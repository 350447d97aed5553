"""Fleet router: front N API-server replicas with one OpenAI surface —
the port of ``dllama_tpu/router/`` (registry, fleet, service, pod).

* :mod:`.registry` probes each replica's ``/health`` and scores it on the
  ``capacity`` block (free slots, free KV pages, queue depth, the degraded
  flag, the SLO verdict), with hysteretic ejection and re-admission;
* :mod:`.service` dispatches each request to the least-loaded healthy
  replica, retries before any bytes, resumes greedy streams on a peer
  after a mid-stream loss (a DLREQ01 checkpoint, or a verified re-run),
  ends sampled ones ``replica_lost``, and splices a draining replica's
  hand-off into the client's open stream;
* :mod:`.fleet` federates the replicas' ``/metrics``, ``/debug/trace`` and
  ``/debug/events``;
* :mod:`.pod` is ``serve-pod``: ``--dp`` replicas of the port's server in
  this process (one model read, an engine and scheduler each), or
  ``--supervise``d child processes that a supervisor respawns;
* :mod:`.elastic` is ``--supervise --elastic``'s control loop: it scales
  the children up on load, down when idle, and reshapes their tp degree,
  by its policy or by ``/admin/scale`` and ``/admin/reshape``.

The router itself is stdlib HTTP plumbing: ``python -m
dllama_tpu_torch.router --backends host:port,...`` starts it without
loading a model.
"""
