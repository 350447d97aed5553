"""Observability for the port's serving stack — trimmed copies of
``dllama_tpu/obs``, stdlib only besides the kernel counters that
:mod:`.dispatch` reads:

* :mod:`.metrics` — the process-global registry (counters, gauges,
  fixed-bucket histograms) with its JSON and Prometheus expositions;
* :mod:`.log` — structured logging (JSON lines or human format) with a
  contextvar-carried request ID;
* :mod:`.trace` — always-on spans in a bounded ring (``/debug/trace``);
* :mod:`.dispatch` — the ``matmul_dispatch{codec, path}`` ledger, read
  from the kernels' launch counters;
* :mod:`.flight` — per-request flight records (``/debug/requests``) and
  the per-dispatch slot timeline (``/debug/timeline``);
* :mod:`.slo` — latency and error objectives with multi-window burn rates
  (``--slo``, the ``/health`` verdict);
* :mod:`.events` — the event journal (``/debug/events``, ``--event-log``);
* :mod:`.cost` — the roofline model: modelled FLOPs and bytes a dispatch,
  the ``mfu``/``mbu`` gauges against the card's peaks.

The router and the pod supervisor (``router/``) bump the ``router_*``,
``pod_*`` and ``fleet_*`` families of the same registry, and the fleet
trace id (``X-Dllama-Trace``) rides :mod:`.trace`.
"""
