"""``serve-pod``: ``--dp`` replicas of the API server, each ``--workers
tpu:N`` ranks wide, fronted by the fleet router on one public port — the
port of ``dllama_tpu/router/pod.py``.

Placement follows the port's rule (``parallel/mesh.py``), not the TPU's:

* ``--device cuda``: replica r takes cards r·N … r·N + N − 1 (the pod
  refuses to start when there are too few cards);
* ``--device cuda:K``: every replica, and every rank, on card K (one card
  serving several replicas);
* ``--device cpu``: the CPU (the tests).

In process (the default), the model is read from disk once; each replica
gets its own batch-1 engine, slot engine, scheduler and ``ApiState`` on a
loopback ephemeral port, and replicas on one device share its weight
tensors.  The router (:mod:`.registry` + :mod:`.service`) runs in the same
process with the replicas registered as backends, so the operator sees one
address.  Launch counters are process-wide: bumped under
``ops.COUNT_LOCK``, they add up every replica's launches.

``--supervise`` trades the shared load for crash isolation: each replica
is a child process (``python -m dllama_tpu_torch.server.api`` on a fixed
loopback port, ``CUDA_VISIBLE_DEVICES`` set to its cards before torch
starts there) under a :class:`Supervisor` that respawns it when it dies —
same port, same cards, a warm ``--snapshot-dir`` restore — and the
registry's hysteretic re-admission folds the replacement back into
rotation.  A replica that keeps dying (``--respawn-max`` deaths inside
``--respawn-window`` seconds) is quarantined; one whose process lives but
whose ``/health`` stops answering 200 (a hung device, or a server degraded
by ``--step-timeout``) is killed and respawned as ``reason="hung"``.  The
supervisor builds the kernels once before it spawns (``ops/_build.py``,
which also holds a file lock), so the children load the library instead
of compiling it twice; a child that still fails to build or to reach its
card dies, and that death counts in the crash-loop window.

``--supervise --elastic`` adds the control loop of :mod:`.elastic`: the
pod grows, shrinks and reshapes its replica set under load or through
``/admin/scale`` and ``/admin/reshape``, within a ``--pod-devices``
budget of ordinals (a card under ``--device cuda``; bookkeeping under
``cuda:K``, where every child runs on card K, and under ``cpu``).
:class:`_PodOps` is the process side it drives: a spawn seats a new child
on its ordinals, a retire marks it ``retiring`` (so the supervisor does
not respawn it) before the SIGTERM drain.
"""

from __future__ import annotations

import argparse
import collections
import http.client
import os
import socket
import subprocess
import sys
import threading
import time

from ..obs import events as obs_events, metrics as obs_metrics
from ..obs.log import get_logger
from ..runtime.faults import FAULTS

_log = get_logger("router.pod")


def parse_pod_tp(workers: str | None, n_devices: int, dp: int) -> int:
    """Per-replica tp degree: ``--workers tpu:N`` names it explicitly;
    default splits every local device evenly over the dp replicas."""
    if workers is None:
        tp, rem = divmod(n_devices, dp)
        if tp < 1:
            raise SystemExit(
                f"serve-pod: {dp} replicas need at least {dp} of the "
                f"{n_devices} local devices")
        return tp
    w = workers.strip().lower()
    if not w.startswith("tpu:"):
        raise SystemExit(f"serve-pod: --workers takes tpu:N, got {workers!r}")
    try:
        tp = int(w.split(":", 1)[1])
    except ValueError:
        raise SystemExit(f"serve-pod: --workers takes tpu:N, got {workers!r}")
    if tp < 1:
        raise SystemExit(f"serve-pod: tp degree must be >= 1, got {tp}")
    return tp


def partition_devices(device: str, dp: int, tp: int, n_cards: int) -> list[tuple[str, ...]]:
    """Each replica's device a rank, replica r on ordinals r·tp … r·tp +
    tp − 1 placed by :func:`ordinal_devices`; raises when ``cuda`` has too
    few cards, ``cuda:K`` names a card not present, or the device is none
    of ``cuda``, ``cuda:K``, ``cpu``."""
    dev = device.strip().lower()
    if dev == "cuda":
        need = dp * tp
        if need > n_cards:
            raise SystemExit(
                f"serve-pod: dp={dp} × tp={tp} needs {need} cards, only {n_cards} "
                "present (--device cuda:K puts every replica on card K)")
        if need < n_cards:
            _log.warning("pod_devices_idle", extra={"used": need, "present": n_cards})
    elif dev.startswith("cuda:"):
        if int(dev.split(":", 1)[1]) >= n_cards:
            raise SystemExit(f"serve-pod: --device {device} but only {n_cards} card(s)")
    elif dev != "cpu":
        raise SystemExit(f"serve-pod: --device takes cuda, cuda:K or cpu, got {device!r}")
    return [ordinal_devices(dev, range(r * tp, r * tp + tp)) for r in range(dp)]


def child_placement(devs: tuple[str, ...]) -> tuple[list[int] | None, str]:
    """A supervised child's ``CUDA_VISIBLE_DEVICES`` ordinals (None on the
    CPU) and its ``--device``: its cards renumber from 0 inside the child,
    so one card is ``cuda:0`` and several are ``cuda`` (rank r on card r);
    ranks that share one card are ``cuda:0`` too."""
    if devs[0] == "cpu":
        return None, "cpu"
    ordinals = sorted({int(d.split(":", 1)[1]) for d in devs})
    return ordinals, "cuda:0" if len(ordinals) == 1 else "cuda"


def ordinal_devices(device: str, ordinals) -> tuple[str, ...]:
    """A replica's device a rank, from its ordinals (the pool's, or the
    boot's r·tp …): under ``cuda`` each ordinal is a card, under
    ``cuda:K`` and ``cpu`` every rank sits on that device (the ordinals are
    bookkeeping)."""
    dev = device.strip().lower()
    if dev == "cuda":
        return tuple(f"cuda:{o}" for o in ordinals)
    if dev.startswith("cuda:"):
        dev = f"cuda:{int(dev.split(':', 1)[1])}"
    return (dev,) * len(ordinals)


# -- supervised (crash-isolated) pod ------------------------------------

def _hold_port() -> tuple[int, socket.socket]:
    """A fixed port the OS just proved free — with the bound socket
    STILL HELD, closing the pick-then-bind race: nothing else on the
    host can claim the port between allocation and the child's bind.
    :meth:`Supervisor.spawn` closes the held socket immediately before
    ``Popen`` (SO_REUSEADDR on both sides, so the child rebinds the
    address with no TIME_WAIT stall).  The residual window while the
    child loads its model is covered by the quarantine ladder: a stolen
    port makes the child's bind fail, which is a death, which feeds
    ``--respawn-max``.  Respawns rebind the SAME address, so the
    registry's hysteretic re-admission recovers the replacement with no
    reconfiguration."""
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("127.0.0.1", 0))
    return s.getsockname()[1], s


def _free_port() -> int:
    """Only the number of :func:`_hold_port` (tests); the race-free path
    holds the socket."""
    port, s = _hold_port()
    s.close()
    return port


def _child_env(base: dict, ordinals: list[int] | None) -> dict:
    """One replica child's environment: its cards as
    ``CUDA_VISIBLE_DEVICES`` (set before torch starts CUDA in the child, so
    the child sees those cards alone, numbered from 0); a CPU child's is
    the parent's."""
    env = dict(base)
    if ordinals is not None:
        env["CUDA_VISIBLE_DEVICES"] = ",".join(str(o) for o in ordinals)
    return env


def _replica_argv(args, port: int, snapdir: str | None, device: str,
                  tp: int) -> list[str]:
    """Child command line: the port's API server on a fixed loopback port
    and ``device`` (``tp`` ranks), carrying the pod's serving flags."""
    argv = [sys.executable, "-m", "dllama_tpu_torch.server.api",
            "--model", args.model, "--tokenizer", args.tokenizer,
            "--host", "127.0.0.1", "--port", str(port), "--device", device,
            "--temperature", str(args.temperature),
            "--topp", str(args.topp),
            "--chunk", str(args.chunk),
            "--max-pending", str(args.max_pending),
            "--request-timeout", str(args.request_timeout),
            "--io-timeout", str(args.io_timeout),
            "--drain-grace", str(args.drain_grace),
            "--buffer-float-type", args.buffer_float_type]
    if tp > 1:
        argv += ["--workers", f"tpu:{tp}"]
    if args.max_seq_len is not None:
        argv += ["--max-seq-len", str(args.max_seq_len)]
    if args.batch_slots > 0:
        argv += ["--batch-slots", str(args.batch_slots),
                 "--kv-pages", str(args.kv_pages),
                 "--kv-page-size", str(args.kv_page_size),
                 "--kv-quant", args.kv_quant,
                 "--sched-prefill-chunk", str(args.sched_prefill_chunk),
                 "--sched-max-wait-ms", str(args.sched_max_wait_ms),
                 "--sched-max-queue", str(args.sched_max_queue)]
        if args.no_prefix_reuse:
            argv.append("--no-prefix-reuse")
        if args.no_sched_overlap:
            argv.append("--no-sched-overlap")
    if args.handoff:
        argv.append("--handoff")
    if args.handoff_ttl:
        argv += ["--handoff-ttl", str(args.handoff_ttl)]
    if snapdir:
        argv += ["--snapshot-dir", snapdir]
    if args.kv_cache_dtype:
        argv += ["--kv-cache-dtype", args.kv_cache_dtype]
    if args.step_timeout is not None:
        argv += ["--step-timeout", str(args.step_timeout)]
    if args.numeric_checks:
        argv.append("--numeric-checks")
    if args.verify_weights:
        argv.append("--verify-weights")
    if args.log_format:
        argv += ["--log-format", args.log_format]
    if args.log_level:
        argv += ["--log-level", args.log_level]
    return argv


class _Replica:
    """One supervised child: its spawn recipe plus crash-loop history."""

    def __init__(self, idx: int, port: int, argv: list[str], env: dict,
                 *, tp: int = 1, ordinals: list[int] | None = None,
                 sock: socket.socket | None = None):
        self.idx = idx
        self.port = port
        self.argv = argv
        self.env = env
        self.tp = tp                      # mesh shape (elastic reshape)
        self.ordinals = ordinals if ordinals is not None else []
        self.sock = sock                  # held bound port (race fence)
        self.proc: subprocess.Popen | None = None
        self.deaths: collections.deque = collections.deque()
        self.quarantined = False
        self.retiring = False    # elastic drain in progress: no respawn
        self.ready = False       # answered /health since last spawn
        self.hang_streak = 0


class Supervisor:
    """Keeps the pod's replica children alive.

    Three failure shapes, three answers:

    * **death** (any exit, SIGKILL included) — respawn on the same port
      and device set; ``--snapshot-dir`` makes it a warm start and the
      registry re-admits it after ``readmit_after`` healthy probes.
    * **crash loop** — more than ``respawn_max`` deaths inside
      ``respawn_window`` seconds quarantines the replica (structured
      ``pod_replica_quarantined`` log, no further respawns): a
      deterministic crasher respawned forever would grind the fleet
      with prefill churn.
    * **hang** — process alive, ``/health`` not 200 for ``hang_probes``
      consecutive probes: SIGKILL then respawn (``reason="hung"``).
      Hang detection only arms after the child's FIRST healthy answer
      since spawn, so a model still loading (or kernels still building)
      is never shot.

    The ``pod.respawn`` fault point fires before each respawn; a raising
    fault counts as another death in the crash-loop window.
    """

    def __init__(self, replicas: list[_Replica], *, respawn_max: int = 5,
                 respawn_window: float = 30.0, hang_probes: int = 3,
                 poll_interval: float = 1.0, probe_timeout: float = 2.0):
        self.replicas = replicas
        self.respawn_max = max(1, int(respawn_max))
        self.respawn_window = float(respawn_window)
        self.hang_probes = max(1, int(hang_probes))
        self.poll_interval = float(poll_interval)
        self.probe_timeout = float(probe_timeout)
        self._lock = threading.Lock()     # the list; a retire against a respawn
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def spawn(self, rep: _Replica) -> None:
        if rep.sock is not None:
            # held-port fence ends here: release the bound socket in the
            # instant before the child binds the same address
            try:
                rep.sock.close()
            except OSError:
                pass
            rep.sock = None
        rep.proc = subprocess.Popen(rep.argv, env=rep.env)
        rep.ready = False
        rep.hang_streak = 0
        _log.info("pod_replica_spawned", extra={
            "replica": rep.idx, "port": rep.port, "pid": rep.proc.pid})
        obs_events.emit("spawn", replica=f"127.0.0.1:{rep.port}",
                        idx=rep.idx, pid=rep.proc.pid, tp=rep.tp)

    # -- runtime membership (elastic pod) -------------------------------
    def add(self, rep: _Replica) -> None:
        """Spawn and adopt a replica mid-flight (elastic scale-up)."""
        self.spawn(rep)
        with self._lock:
            self.replicas.append(rep)
        obs_metrics.POD_REPLICAS_UP.set(self.replicas_up())

    def begin_retire(self, rep: _Replica) -> subprocess.Popen | None:
        """Mark ``rep`` retiring (no respawn from here on) and return its
        process: under the lock a respawn takes, so a child respawned
        just before is the one returned."""
        with self._lock:
            rep.retiring = True
            return rep.proc

    def remove(self, rep: _Replica) -> None:
        """Forget a replica (elastic scale-down; process already
        reaped by the caller)."""
        with self._lock:
            try:
                self.replicas.remove(rep)
            except ValueError:
                return
        obs_metrics.POD_REPLICAS_UP.set(self.replicas_up())

    def snapshot(self) -> list[_Replica]:
        with self._lock:
            return list(self.replicas)

    def start(self) -> None:
        for rep in self.snapshot():
            self.spawn(rep)
        obs_metrics.POD_REPLICAS_UP.set(len(self.replicas))
        self._thread = threading.Thread(target=self._watch,
                                        name="pod-supervisor", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(
                timeout=self.poll_interval + self.probe_timeout + 2.0)
        reps = self.snapshot()
        for rep in reps:
            if rep.proc is not None and rep.proc.poll() is None:
                rep.proc.terminate()
        deadline = time.monotonic() + 10.0
        for rep in reps:
            if rep.proc is None:
                continue
            try:
                rep.proc.wait(timeout=max(0.1,
                                          deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rep.proc.kill()
                rep.proc.wait(timeout=5.0)

    # -- watch loop -----------------------------------------------------
    def _probe(self, rep: _Replica) -> bool:
        try:
            conn = http.client.HTTPConnection(
                "127.0.0.1", rep.port, timeout=self.probe_timeout)
            try:
                conn.request("GET", "/health")
                resp = conn.getresponse()
                resp.read()  # drained: closing on unread bytes resets the replica's socket
                return resp.status == 200
            finally:
                conn.close()
        except OSError:
            return False

    def _watch(self) -> None:
        while not self._stop.wait(self.poll_interval):
            for rep in self.snapshot():
                if rep.quarantined or rep.retiring:
                    # retiring: the elastic controller owns the drain —
                    # its exit is completion, not a death to respawn
                    continue
                if rep.proc is None:
                    # a previous respawn attempt itself failed: treat
                    # every poll without a process as another death so
                    # the crash-loop window still converges
                    self._died(rep, "respawn")
                elif rep.proc.poll() is not None:
                    self._died(rep, "exit")
                elif self._probe(rep):
                    rep.ready = True
                    rep.hang_streak = 0
                elif rep.ready:
                    rep.hang_streak += 1
                    if rep.hang_streak >= self.hang_probes:
                        _log.warning("pod_replica_hung", extra={
                            "replica": rep.idx, "pid": rep.proc.pid,
                            "failed_probes": rep.hang_streak})
                        rep.proc.kill()  # wedged, not draining: no grace
                        try:
                            rep.proc.wait(timeout=10.0)
                        except subprocess.TimeoutExpired:
                            pass
                        self._died(rep, "hung")
            obs_metrics.POD_REPLICAS_UP.set(self.replicas_up())

    def replicas_up(self) -> int:
        return sum(1 for rep in self.snapshot()
                   if not rep.quarantined and rep.proc is not None
                   and rep.proc.poll() is None)

    def _died(self, rep: _Replica, reason: str) -> None:
        if rep.retiring:
            # the controller set it before its SIGTERM (a SIGKILL landing
            # on a retiring child only ends the retire sooner)
            return
        now = time.monotonic()
        rep.deaths.append(now)
        while rep.deaths and now - rep.deaths[0] > self.respawn_window:
            rep.deaths.popleft()
        _log.warning("pod_replica_died", extra={
            "replica": rep.idx, "reason": reason,
            "returncode": rep.proc.returncode if rep.proc else None,
            "deaths_in_window": len(rep.deaths)})
        obs_events.emit("death", replica=f"127.0.0.1:{rep.port}",
                        idx=rep.idx, reason=reason,
                        returncode=rep.proc.returncode if rep.proc
                        else None,
                        deaths_in_window=len(rep.deaths))
        if len(rep.deaths) > self.respawn_max:
            rep.quarantined = True
            rep.proc = None
            _log.error("pod_replica_quarantined", extra={
                "replica": rep.idx, "reason": reason,
                "deaths": len(rep.deaths),
                "window_s": self.respawn_window})
            obs_events.emit("quarantine", replica=f"127.0.0.1:{rep.port}",
                            idx=rep.idx, reason=reason,
                            deaths=len(rep.deaths),
                            window_s=self.respawn_window)
            return
        try:
            with self._lock:
                # a retire that began since the check above owns the
                # replica now: no respawn for it to miss
                if rep.retiring:
                    return
                FAULTS.fire("pod.respawn")
                self.spawn(rep)
        except Exception as e:  # noqa: BLE001 — injected or exec failure
            _log.error("pod_respawn_failed", extra={
                "replica": rep.idx, "error": str(e)})
            rep.proc = None
            return
        obs_metrics.POD_RESPAWNS.inc(str(rep.idx), reason)
        obs_events.emit("respawn", replica=f"127.0.0.1:{rep.port}",
                        idx=rep.idx, reason=reason,
                        pid=rep.proc.pid if rep.proc else None)


def _new_replica(args, idx: int, tp: int, ordinals: list[int],
                 snapshot_root: str | None) -> _Replica:
    """Replica ``idx``'s spawn recipe: a held loopback port, its snapshot
    directory, and its child's placement on ``ordinals`` (the module
    docstring's rule)."""
    port, sock = _hold_port()
    snapdir = None
    if snapshot_root:
        snapdir = os.path.join(snapshot_root, f"replica{idx}")
        os.makedirs(snapdir, exist_ok=True)
    visible, child_dev = child_placement(ordinal_devices(args.device, ordinals))
    return _Replica(idx, port, _replica_argv(args, port, snapdir, child_dev, tp),
                    _child_env(os.environ, visible), tp=tp, ordinals=ordinals, sock=sock)


class _PodOps:
    """Process mechanics the elastic controller drives.  Lives here so
    :mod:`.elastic` never touches subprocess/sockets and stays
    unit-testable with fakes."""

    def __init__(self, sup: Supervisor, args):
        self.sup = sup
        self.args = args
        self._next_idx = 1 + max(
            (r.idx for r in sup.snapshot()), default=-1)

    def spawn(self, tp: int, ordinals: list[int]) -> _Replica:
        """A new child on ``ordinals``, adopted by the supervisor.  It
        builds no kernels: the supervisor built the library once before
        the first spawn."""
        idx, self._next_idx = self._next_idx, self._next_idx + 1
        rep = _new_replica(self.args, idx, tp, list(ordinals), self.args.snapshot_dir)
        self.sup.add(rep)
        return rep

    def retire(self, rep: _Replica, *, grace: float) -> None:
        """SIGTERM → drain (live slots export DLREQ01, streams finish
        ``handoff``) → bounded wait → SIGKILL if the grace blows.  The
        ``retiring`` flag, set first, stops the supervisor treating the
        exit as a death to respawn."""
        proc = self.sup.begin_retire(rep)
        if proc is not None and proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=grace + 10.0)
            except subprocess.TimeoutExpired:
                _log.warning("pod_retire_kill", extra={
                    "replica": rep.idx, "grace_s": grace})
                proc.kill()
                try:
                    proc.wait(timeout=10.0)
                except subprocess.TimeoutExpired:
                    pass
        self.sup.remove(rep)

    def live_replicas(self) -> list[_Replica]:
        return [r for r in self.sup.snapshot() if not r.quarantined]

    def reap_quarantined(self) -> list[_Replica]:
        out = [r for r in self.sup.snapshot() if r.quarantined]
        for r in out:
            self.sup.remove(r)
        return out


# -- the pod --------------------------------------------------------------

class Pod:
    """A serve-pod's parts: the router's state, its HTTP server once it
    serves (:func:`start`), and the replicas — ``servers`` (in-process API
    servers) or ``supervisor`` (child processes).  :meth:`stop` ends them
    all.  An elastic pod's controller is ``rstate.elastic``."""

    def __init__(self, rstate, *, servers=(), supervisor: Supervisor | None = None):
        self.rstate = rstate
        self.servers = list(servers)
        self.supervisor = supervisor
        self.router = None

    @property
    def port(self) -> int:
        return self.router.server_address[1]

    def stop(self) -> None:
        from .service import stop as router_stop
        if self.router is not None:
            router_stop(self.router)
            self.router = None
        if self.rstate.elastic is not None:
            self.rstate.elastic.stop()
        if self.supervisor is not None:
            self.supervisor.stop()
        if self.servers:
            from ..server import api
            for server in self.servers:
                try:
                    api.stop(server)
                except Exception as e:  # noqa: BLE001 — stop every replica
                    _log.warning("pod_replica_stop_failed: %r", e)
            self.servers = []


def _router_state(args, addrs: list[str]):
    from .registry import Registry
    from .service import RouterState
    registry = Registry(
        addrs,
        probe_interval=args.probe_interval,
        eject_after=args.eject_after,
        readmit_after=args.readmit_after,
        probe_timeout=min(float(args.upstream_timeout), 5.0))
    return RouterState(
        registry, retries=args.router_retries,
        upstream_timeout=args.upstream_timeout,
        stall_timeout=args.stall_timeout,
        checkpoint_interval=args.checkpoint_interval,
        resume_policy=args.resume_policy,
        # the replicas sit on loopback ephemeral ports: the pod's public
        # /metrics defaults to the federated fleet scope
        fleet_scope_default=True)


def _card_count(device: str) -> int:
    """Cards present (0 for a CPU pod); counting them starts no CUDA
    context, so a supervisor parent leaves the cards to its children."""
    if device.strip().lower() == "cpu":
        return 0
    import torch
    return torch.cuda.device_count()


def _pod_tp(args, n_cards: int, dp: int) -> int:
    """``--workers tpu:N``'s N; without it, ``--device cuda`` splits the
    cards evenly over the replicas (the JAX package's default) and
    ``cuda:K`` or ``cpu`` runs one rank a replica."""
    if args.workers:
        return parse_pod_tp(args.workers, 0, dp)
    if args.device.strip().lower() == "cuda":
        return parse_pod_tp(None, n_cards, dp)
    return 1


def elastic_policy(args):
    """The controller's policy from the elastic flags, as the JAX pod reads
    them: ``--max-replicas 0`` (the default) is clamped to
    ``--min-replicas`` by the policy."""
    from .elastic import ElasticPolicy
    return ElasticPolicy(
        window=args.elastic_window, cooldown=args.elastic_cooldown,
        up_util=args.scale_up_util, down_util=args.scale_down_util,
        up_queue=args.scale_up_queue, kv_low=args.reshape_kv_low,
        min_replicas=args.min_replicas, max_replicas=args.max_replicas)


def build_supervised(args) -> Pod:
    """The supervised pod's children (spawned) and the router's state;
    with ``--elastic``, its controller too (started, as ``rstate.elastic``)."""
    if not args.model or not args.tokenizer:
        raise SystemExit("--model and --tokenizer are required for serve-pod")
    from .elastic import DevicePool, ElasticController
    dp = max(args.dp, 1)
    n_cards = _card_count(args.device)
    tp = _pod_tp(args, n_cards, dp)
    groups = partition_devices(args.device, dp, tp, n_cards)
    if args.elastic:
        if not args.handoff:
            raise SystemExit("serve-pod: --elastic needs --handoff "
                             "(scale-down migrates in-flight requests "
                             "over the hand-off wire)")
        if args.batch_slots <= 0 or args.kv_pages <= 0:
            raise SystemExit("serve-pod: --elastic needs --batch-slots "
                             "and --kv-pages (fleet signals come from "
                             "slot-scheduler occupancy)")
    pool_size = args.pod_devices or dp * tp
    if pool_size < dp * tp:
        raise SystemExit(f"serve-pod: --pod-devices {pool_size} cannot "
                         f"seat the boot shape dp={dp} × tp={tp}")
    if args.device.strip().lower() == "cuda" and pool_size > n_cards:
        raise SystemExit(f"serve-pod: --pod-devices {pool_size} needs {pool_size} cards, "
                         f"only {n_cards} present (--device cuda:K puts every replica "
                         "on card K)")
    pool = DevicePool(pool_size)
    if groups[0][0] != "cpu":
        # nvcc only (no CUDA context here): the children load this library
        from ..ops import _build
        _build.build()
    replicas = [_new_replica(args, r, tp, pool.allocate(tp), args.snapshot_dir)
                for r in range(dp)]
    sup = Supervisor(
        replicas, respawn_max=args.respawn_max, respawn_window=args.respawn_window,
        poll_interval=min(1.0, float(args.probe_interval)),
        probe_timeout=min(float(args.upstream_timeout), 2.0))
    sup.start()
    try:
        rstate = _router_state(args, [f"127.0.0.1:{rep.port}" for rep in replicas])
        if args.elastic:
            policy = elastic_policy(args)
            rstate.elastic = ElasticController(
                _PodOps(sup, args), rstate.registry, pool, policy,
                tp=tp, interval=args.elastic_interval,
                drain_grace=float(args.drain_grace))
            rstate.elastic.start()
    except BaseException:
        sup.stop()
        raise
    elastic = (f" [elastic {policy.min_replicas}–{policy.max_replicas} over {pool_size} "
               "devices]" if args.elastic else "")
    print(f"💡 serve-pod: supervising {dp} replica process(es) × tp={tp} on "
          f"{', '.join(g[0] for g in groups)}{elastic}; router on :{args.port}")
    return Pod(rstate, supervisor=sup)


def build_in_process(args) -> Pod:
    """The in-process pod: the model read once, one API server per replica
    (its own engines and scheduler; replicas on one device share the
    weights), and the router's state."""
    from ..cli import read_model
    from ..device import resolve
    from ..parallel.mesh import Mesh
    from ..server import api

    dp = max(args.dp, 1)
    n_cards = _card_count(args.device)
    tp = _pod_tp(args, n_cards, dp)
    groups = partition_devices(args.device, dp, tp, n_cards)
    meshes = [Mesh(tuple(resolve(d) for d in devs)) for devs in groups]
    cfg, params, tok = read_model(args, tp, f"{dp} replica(s) × tp={tp} on "
                                            f"{', '.join(g[0] for g in groups)}")
    # a replica's stack: the host params for the first replica on a mesh,
    # then that replica's engine (its weights on the device, shared)
    first: dict = {}
    servers = []
    try:
        for r, mesh in enumerate(meshes):
            src = first.get(mesh) or argparse.Namespace(
                cfg=cfg, params=params, device=mesh.device, mesh=mesh)
            rargs = argparse.Namespace(**vars(args))
            if args.snapshot_dir:
                rargs.snapshot_dir = os.path.join(args.snapshot_dir, f"replica{r}")
            state = api.build_state(rargs, None, stack=(src, tok))
            first.setdefault(mesh, state.engine)
            # loopback + ephemeral port: the OS picks, so replicas never
            # collide with each other or the public port
            server = api.serve(state, host="127.0.0.1", port=0, block=False,
                               install_signals=False)
            servers.append(server)
            _log.info("pod_replica_up", extra={
                "replica": r, "tp": tp, "addr": "127.0.0.1:%d" % server.server_address[1],
                "devices": list(groups[r])})
        del params
        rstate = _router_state(
            args, ["127.0.0.1:%d" % s.server_address[1] for s in servers])
    except BaseException:
        for server in servers:
            api.stop(server)
        raise
    print(f"💡 serve-pod: {dp} replica(s) × tp={tp} in this process; "
          f"router on :{args.port}")
    return Pod(rstate, servers=servers)


def build(args) -> Pod:
    if args.sp > 1 or args.ep > 1:
        raise SystemExit("serve-pod partitions devices into dp × tp "
                         "replicas; --sp/--ep are not supported here "
                         "(run a single replica with dllama-api instead)")
    if args.supervise:
        return build_supervised(args)
    if args.elastic:
        raise SystemExit("serve-pod: --elastic requires --supervise "
                         "(only process replicas can be spawned, "
                         "drained, and reshaped at runtime)")
    return build_in_process(args)


def start(args) -> Pod:
    """Build the pod and serve its router on a background thread
    (``--port 0`` binds a free one: :attr:`Pod.port`); :meth:`Pod.stop`
    ends it (in-process callers: tests, ``chip_smoke.py``)."""
    from .service import serve as router_serve
    pod = build(args)
    try:
        pod.router = router_serve(pod.rstate, host=args.host, port=args.port, block=False)
    except BaseException:
        pod.stop()
        raise
    return pod


def main(args) -> None:
    """``serve-pod``: serve until SIGTERM/SIGINT, then stop the router and
    every replica."""
    from .service import serve as router_serve
    pod = build(args)
    try:
        router_serve(pod.rstate, host=args.host, port=args.port)
    finally:
        pod.stop()
