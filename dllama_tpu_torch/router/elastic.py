"""Elastic pod control loop: load-driven autoscaling and live reshape —
the port of ``dllama_tpu/router/elastic.py``.

``serve-pod --supervise --elastic`` closes the loop the supervisor leaves
open.  The supervisor answers "a replica died"; this module answers "the
traffic changed shape".  Three moves, all built from primitives the pod
already has:

* **scale-up** — allocate ``tp`` ordinals from the :class:`DevicePool`,
  spawn a fresh replica child (a warm ``--snapshot-dir`` boot), register
  it with the router's :class:`~.registry.Registry` at runtime, and let
  the registry's hysteretic admission gate traffic: the newcomer takes no
  requests until its first healthy probe.
* **scale-down** — pick the most idle replica (highest registry score),
  fence admissions (``Registry.retire``), then SIGTERM it so the drain
  path runs: the replica exports every live slot as a DLREQ01 record, its
  streams finish ``handoff``, and the router re-binds each one onto a
  surviving peer.  Its ordinals return to the pool.
* **reshape** — change the per-replica tp degree live (2×tp=1 ⇄ 2×tp=2)
  by interleaving the two moves above: spawn new-shape replicas while
  ordinals are free, retire old-shape ones to free more, and let the
  hand-off wire migrate every in-flight request.  A DLREQ01 fingerprint
  leaves the mesh out, so a record a tp=1 child exports imports on a tp=2
  one.

What an ordinal is follows the pod's placement rule (``router/pod.py``
``partition_devices`` and ``child_placement``):

* ``--device cuda``: an ordinal is a card; a replica's ordinals become its
  child's ``CUDA_VISIBLE_DEVICES``.  A ``--pod-devices`` above
  ``torch.cuda.device_count()`` is refused at start.
* ``--device cuda:K``: ordinals are bookkeeping; every child runs on card
  K (one card serving the whole pod, each child's ranks on it).
* ``--device cpu``: ordinals are bookkeeping too.

The policy (:class:`ElasticPolicy`) is a pure function of a sliding
window of fleet samples — no threads, no sockets — so the hysteresis and
cooldown behaviour is unit-testable without booting a pod.  The
:class:`ElasticController` owns the one policy thread and executes at
most one topology action at a time; manual ``/admin/scale`` and
``/admin/reshape`` commands preempt the policy but run through the same
serialized executor, so chaos during a reshape contends with nothing but
the reshape itself.  This module never touches ``torch``: it runs in the
supervisor's parent, which leaves the cards to its children.
"""

from __future__ import annotations

import collections
import threading
import time

from ..obs import events as obs_events, metrics as obs_metrics
from ..obs.log import get_logger

_log = get_logger("router.elastic")


class DevicePool:
    """Ordinal accounting for the pod's device budget.

    Replicas borrow contiguous ordinal runs when one exists (neighbouring
    cards, matching ``partition_devices``'s boot-time layout) and fall
    back to the lowest free ordinals when fragmentation from earlier scale
    events leaves no run.  What an ordinal is: the module docstring."""

    def __init__(self, total: int):
        if total < 1:
            raise ValueError(f"device pool needs >= 1 device, got {total}")
        self.total = int(total)
        self._free = set(range(self.total))
        self._lock = threading.Lock()

    @property
    def free(self) -> int:
        with self._lock:
            return len(self._free)

    def allocate(self, n: int) -> list[int]:
        """``n`` ordinals, contiguous-preferred.  Raises ``ValueError``
        when the pool cannot satisfy the request — the caller treats
        that as "no capacity", never as a crash."""
        if n < 1:
            raise ValueError(f"device pool: allocation size must be >= 1, "
                             f"got {n}")
        with self._lock:
            if n > len(self._free):
                raise ValueError(
                    f"device pool: want {n} devices, "
                    f"{len(self._free)}/{self.total} free")
            free = sorted(self._free)
            got = free[:n]
            for i in range(len(free) - n + 1):
                run = free[i:i + n]
                if run[-1] - run[0] == n - 1:
                    got = run
                    break
            self._free.difference_update(got)
            return list(got)

    def release(self, ordinals) -> None:
        """Return ordinals to the pool.  Double-release and out-of-range
        ordinals raise — both are accounting bugs worth failing loudly
        on (a silently double-freed device would be handed to two
        replicas)."""
        with self._lock:
            for o in ordinals:
                if not 0 <= o < self.total:
                    raise ValueError(f"device pool: ordinal {o} outside "
                                     f"0..{self.total - 1}")
                if o in self._free:
                    raise ValueError(f"device pool: double release of "
                                     f"ordinal {o}")
            self._free.update(ordinals)


class Decision:
    """One policy verdict: scale ``up``/``down`` or ``reshape`` to a
    new tp degree, with the reason that becomes the metric label."""

    __slots__ = ("direction", "reason", "tp")

    def __init__(self, direction: str, reason: str, tp: int | None = None):
        self.direction = direction
        self.reason = reason
        self.tp = tp

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"Decision({self.direction!r}, {self.reason!r}, tp={self.tp})"


class ElasticPolicy:
    """Sliding-window threshold policy with hysteresis and cooldown.

    A decision needs EVERY sample in the window to agree (sustained
    signal, not a spike), plus ``cooldown`` seconds since the last
    topology action; ``note_action`` also clears the window because
    samples taken under the old topology say nothing about the new one.
    The thresholds are deliberately asymmetric (``up_util`` well above
    ``down_util``) so the fleet never oscillates on a load level that
    sits between them.

    Signals per sample (dicts built by the controller from registry
    health blocks):

    * ``util`` — busy slots / total slots across eligible replicas
    * ``queue_per_replica`` — fleet queue depth / replica count
    * ``kv_free_frac`` — effective free KV pages / total pages
    """

    def __init__(self, *, window: int = 5, cooldown: float = 30.0,
                 up_util: float = 0.85, down_util: float = 0.15,
                 up_queue: float = 2.0, kv_low: float = 0.08,
                 min_replicas: int = 1, max_replicas: int = 8):
        self.window = max(2, int(window))
        self.cooldown = max(0.0, float(cooldown))
        self.up_util = float(up_util)
        self.down_util = float(down_util)
        self.up_queue = float(up_queue)
        self.kv_low = float(kv_low)
        self.min_replicas = max(1, int(min_replicas))
        self.max_replicas = max(self.min_replicas, int(max_replicas))
        self._samples: collections.deque = collections.deque(
            maxlen=self.window)
        self._last_action: float | None = None

    def observe(self, sample: dict) -> None:
        self._samples.append(sample)

    def note_action(self, now: float) -> None:
        """A topology action happened (policy-driven or manual): start
        the cooldown and drop samples measured under the old shape."""
        self._last_action = now
        self._samples.clear()

    def decide(self, now: float, *, n_replicas: int, tp: int,
               free_devices: int) -> Decision | None:
        if len(self._samples) < self.window:
            return None
        if self._last_action is not None \
                and now - self._last_action < self.cooldown:
            return None
        samples = list(self._samples)
        hot = all(s["util"] >= self.up_util
                  or s["queue_per_replica"] >= self.up_queue
                  for s in samples)
        kv_starved = all(s["kv_free_frac"] <= self.kv_low for s in samples)
        idle = all(s["util"] <= self.down_util
                   and s["queue_per_replica"] <= 0 for s in samples)
        total_devices = n_replicas * tp + free_devices
        if kv_starved and tp * 2 <= total_devices \
                and total_devices // (tp * 2) >= self.min_replicas:
            # long-context pressure: fewer, fatter replicas double the
            # per-replica KV pool (throughput-heavy mix → widen tp)
            return Decision("reshape", "kv_pressure", tp=tp * 2)
        if hot and n_replicas < self.max_replicas:
            if free_devices >= tp:
                return Decision("up", "load")
            if tp > 1:
                # no spare devices: trade tp for dp — more, thinner
                # replicas serve a latency-bound interactive surge
                return Decision("reshape", "load", tp=max(1, tp // 2))
            return None
        if idle and n_replicas > self.min_replicas:
            return Decision("down", "idle")
        return None


class ElasticController:
    """One thread that samples, decides, and reshapes the pod.

    The pod's process mechanics stay in ``router/pod.py`` behind the
    ``ops`` object (spawn / retire / live replica listing / quarantine
    reaping) so this module never touches ``subprocess`` and the policy
    plumbing is testable with fakes.  All topology actions — policy
    decisions AND manual ``/admin`` commands — run serialized on the
    controller thread; ``request_scale``/``request_reshape`` only
    enqueue (latest command wins) and return, so the admin surface
    never blocks on a drain.
    """

    def __init__(self, ops, registry, pool: DevicePool,
                 policy: ElasticPolicy, *, tp: int,
                 interval: float = 2.0, drain_grace: float = 30.0,
                 boot_timeout: float = 120.0):
        self.ops = ops
        self.registry = registry
        self.pool = pool
        self.policy = policy
        self.tp = max(1, int(tp))
        self.interval = max(0.05, float(interval))
        self.drain_grace = max(0.0, float(drain_grace))
        self.boot_timeout = max(1.0, float(boot_timeout))
        self._lock = threading.Lock()
        self._pending: tuple[str, int] | None = None
        self._busy: str | None = None      # current action, for /health
        self._last_decision: dict | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        obs_metrics.POD_REPLICAS_DESIRED.set(len(self.ops.live_replicas()))

    # -- lifecycle ------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop,
                                        name="pod-elastic", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval + 2.0)

    # -- admin surface (router /admin/scale, /admin/reshape) ------------
    def request_scale(self, n: int) -> dict:
        n = max(self.policy.min_replicas,
                min(self.policy.max_replicas, int(n)))
        with self._lock:
            self._pending = ("scale", n)
        return {"accepted": True, "target_replicas": n}

    def request_reshape(self, tp: int) -> dict:
        tp = int(tp)
        if tp < 1:
            raise ValueError(f"reshape tp must be >= 1, got {tp}")
        total = self._total_devices()
        if tp > total:
            raise ValueError(f"reshape tp={tp} exceeds the pod's "
                             f"{total}-device budget")
        with self._lock:
            self._pending = ("reshape", tp)
        return {"accepted": True, "target_tp": tp}

    def fleet_status(self) -> dict:
        reps = self.ops.live_replicas()
        with self._lock:
            busy, last = self._busy, self._last_decision
        return {
            "elastic": True,
            "tp": self.tp,
            "n_replicas": len(reps),
            "min_replicas": self.policy.min_replicas,
            "max_replicas": self.policy.max_replicas,
            "device_pool": {"total": self.pool.total,
                            "free": self.pool.free},
            "busy": busy,
            "last_decision": last,
            "replicas": [{"idx": r.idx, "port": r.port, "tp": r.tp,
                          "retiring": r.retiring} for r in reps],
        }

    # -- control loop ---------------------------------------------------
    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self._tick()
            except Exception as e:  # noqa: BLE001 — loop must survive
                _log.error("elastic_tick_failed", extra={"error": repr(e)})

    def _tick(self) -> None:
        self._reap_quarantined()
        with self._lock:
            cmd, self._pending = self._pending, None
        if cmd is not None:
            kind, arg = cmd
            if kind == "scale":
                self._run(f"scale:{arg}", self._scale_to, arg, "manual")
            else:
                self._run(f"reshape:{arg}", self._reshape, arg, "manual")
            return
        sample = self._sample()
        if sample is None:
            return
        self.policy.observe(sample)
        now = time.monotonic()
        d = self.policy.decide(
            now, n_replicas=len(self.ops.live_replicas()),
            tp=self.tp, free_devices=self.pool.free)
        if d is None:
            return
        with self._lock:
            self._last_decision = {"direction": d.direction,
                                   "reason": d.reason, "tp": d.tp}
        _log.info("elastic_decision", extra={
            "direction": d.direction, "reason": d.reason, "tp": d.tp})
        n = len(self.ops.live_replicas())
        if d.direction == "up":
            self._run("scale_up", self._scale_to, n + 1, d.reason)
        elif d.direction == "down":
            self._run("scale_down", self._scale_to, n - 1, d.reason)
        else:
            self._run(f"reshape:{d.tp}", self._reshape, d.tp, d.reason)

    def _run(self, label: str, fn, *args) -> None:
        with self._lock:
            self._busy = label
        try:
            fn(*args)
        finally:
            with self._lock:
                self._busy = None
            self.policy.note_action(time.monotonic())

    # -- signal sampling ------------------------------------------------
    def _sample(self) -> dict | None:
        """One fleet-wide sample from the registry's cached health
        blocks (no extra probes — the registry already polls)."""
        slots = busy = queue = 0
        kv_total = kv_free = 0
        n = 0
        for b in self.registry.eligible_backends():
            h = b.last_health or {}
            occ = h.get("scheduler") or {}
            cap = h.get("capacity") or {}
            if occ.get("slots"):
                slots += occ["slots"]
                busy += occ.get("active", 0)
            else:
                # slot-less replica: approximate with admission depth
                slots += max(h.get("max_pending", 1), 1)
                busy += h.get("in_flight", 0)
            queue += cap.get("queue_depth") or 0
            tot = occ.get("kv_pages_total")
            if tot:
                kv_total += tot
                kvp = cap.get("kv_pressure") or {}
                free = kvp.get("effective_free")
                if free is None:
                    free = occ.get("kv_pages_free") or 0
                kv_free += free
            n += 1
        if n == 0:
            return None
        return {
            "util": busy / slots if slots else 0.0,
            "queue_per_replica": queue / n,
            "kv_free_frac": kv_free / kv_total if kv_total else 1.0,
        }

    # -- topology actions (controller thread only) ----------------------
    def _total_devices(self) -> int:
        return self.pool.total

    def _reap_quarantined(self) -> None:
        """A crash-looper the supervisor quarantined still holds devices
        and a registry row; reclaim both so the pool can respawn
        capacity elsewhere."""
        for rep in self.ops.reap_quarantined():
            self.registry.remove(f"127.0.0.1:{rep.port}")
            self.pool.release(rep.ordinals)
            obs_metrics.POD_SCALE_EVENTS.inc("down", "quarantined")
            obs_events.emit("scale", direction="down",
                            reason="quarantined",
                            replica=f"127.0.0.1:{rep.port}", idx=rep.idx)
            obs_metrics.POD_REPLICAS_DESIRED.set(
                len(self.ops.live_replicas()))
            _log.warning("elastic_reaped_quarantined", extra={
                "replica": rep.idx, "port": rep.port,
                "devices_released": rep.ordinals})

    def _scale_to(self, n: int, reason: str) -> None:
        n = max(self.policy.min_replicas,
                min(self.policy.max_replicas, int(n)))
        obs_metrics.POD_REPLICAS_DESIRED.set(n)
        while len(self.ops.live_replicas()) < n and not self._stop.is_set():
            if not self._spawn_one(self.tp, reason):
                break
        while len(self.ops.live_replicas()) > n and not self._stop.is_set():
            if not self._retire_one(reason):
                break

    def _spawn_one(self, tp: int, reason: str) -> bool:
        try:
            ordinals = self.pool.allocate(tp)
        except ValueError as e:
            _log.warning("elastic_scale_up_blocked",
                         extra={"error": str(e)})
            return False
        try:
            rep = self.ops.spawn(tp, ordinals)
        except Exception as e:  # noqa: BLE001 — spawn must not kill loop
            self.pool.release(ordinals)
            _log.error("elastic_spawn_failed", extra={"error": repr(e)})
            return False
        addr = f"127.0.0.1:{rep.port}"
        self.registry.add(addr)
        obs_metrics.POD_SCALE_EVENTS.inc("up", reason)
        obs_events.emit("scale", direction="up", reason=reason,
                        replica=addr, idx=rep.idx, tp=tp)
        _log.info("elastic_scale_up", extra={
            "replica": rep.idx, "port": rep.port, "tp": tp,
            "devices": ordinals, "reason": reason})
        self._wait_admitted(addr)
        return True

    def _wait_admitted(self, addr: str) -> bool:
        """Block (controller thread only) until the registry's hysteretic
        admission lets the newcomer take traffic, or the boot budget
        runs out — on timeout the supervisor's quarantine ladder owns
        recovery, the controller just stops waiting."""
        deadline = time.monotonic() + self.boot_timeout
        while time.monotonic() < deadline and not self._stop.is_set():
            b = self.registry.get(addr)
            if b is None:
                return False            # reaped while booting
            if b.last_health is not None and not b.ejected:
                return True
            time.sleep(min(0.1, self.interval))
        _log.warning("elastic_admission_timeout", extra={"addr": addr})
        return False

    def _retire_one(self, reason: str, *, shape_tp: int | None = None
                    ) -> bool:
        """Fence, drain, and remove one replica; returns False when no
        replica can be retired safely (nobody left to migrate onto)."""
        reps = [r for r in self.ops.live_replicas() if not r.retiring]
        if shape_tp is not None:
            reps = [r for r in reps if r.tp == shape_tp]
        if not reps:
            return False
        survivors = [r for r in self.ops.live_replicas()
                     if not r.retiring]
        if len(survivors) <= 1:
            _log.warning("elastic_scale_down_blocked", extra={
                "reason": "last replica cannot retire"})
            return False
        victim = self._pick_victim(reps)
        addr = f"127.0.0.1:{victim.port}"
        self.registry.retire(addr)      # admission fence, pre-SIGTERM
        _log.info("elastic_retiring", extra={
            "replica": victim.idx, "port": victim.port,
            "tp": victim.tp, "reason": reason})
        # SIGTERM runs the replica's drain: live slots export DLREQ01
        # records, streams finish "handoff", the router re-binds each
        # on a surviving peer.  The wait is bounded; a replica that
        # ignores its grace is killed (its streams take the resume
        # ladder instead — still zero client-visible drops for greedy).
        self.ops.retire(victim, grace=self.drain_grace)
        self.registry.remove(addr)
        self.pool.release(victim.ordinals)
        obs_metrics.POD_SCALE_EVENTS.inc("down", reason)
        obs_events.emit("scale", direction="down", reason=reason,
                        replica=addr, idx=victim.idx, tp=victim.tp)
        _log.info("elastic_scale_down", extra={
            "replica": victim.idx, "port": victim.port, "reason": reason})
        return True

    def _pick_victim(self, reps):
        """Most-idle replica by the registry's own score so retirement
        migrates the fewest in-flight requests."""
        best, best_score = reps[0], float("-inf")
        for r in reps:
            b = self.registry.get(f"127.0.0.1:{r.port}")
            score = self.registry.score(b) if b is not None \
                else float("-inf")
            if score > best_score:
                best, best_score = r, score
        return best

    def _reshape(self, tp_new: int, reason: str) -> None:
        """Live tp change: interleave spawn-new-shape / retire-old-shape
        until every live replica runs ``tp_new``.  Converges under
        chaos — a SIGKILLed retiring replica just finishes retiring
        faster (the bounded wait sees the exit), a SIGKILLed new-shape
        replica is the supervisor's respawn problem, and each loop pass
        re-reads live state rather than trusting a plan."""
        tp_new = int(tp_new)
        if tp_new < 1 or tp_new == self.tp:
            return
        t0 = time.monotonic()
        live = self.ops.live_replicas()
        budget = sum(r.tp for r in live) + self.pool.free
        target = max(self.policy.min_replicas,
                     min(self.policy.max_replicas, budget // tp_new))
        if target < 1:
            _log.warning("elastic_reshape_blocked", extra={
                "tp": tp_new, "budget": budget})
            return
        _log.info("elastic_reshape_start", extra={
            "tp_from": self.tp, "tp_to": tp_new, "target": target,
            "reason": reason})
        obs_events.emit("reshape", phase="start", tp_from=self.tp,
                        tp_to=tp_new, target=target, reason=reason)
        self.tp = tp_new
        obs_metrics.POD_REPLICAS_DESIRED.set(target)
        # generous overall bound: a wedged drain cannot wedge the
        # controller forever, and partial progress is still progress
        deadline = time.monotonic() + self.boot_timeout \
            + (target + len(live)) * (self.drain_grace + 10.0)
        while not self._stop.is_set() and time.monotonic() < deadline:
            reps = self.ops.live_replicas()
            new = [r for r in reps if r.tp == tp_new and not r.retiring]
            old = [r for r in reps if r.tp != tp_new and not r.retiring]
            if not old and len(new) >= target:
                break
            if len(new) < target and self.pool.free >= tp_new:
                self._spawn_one(tp_new, reason)
            elif old:
                if not self._retire_one(reason, shape_tp=old[0].tp):
                    # nothing retirable yet (last eligible survivor);
                    # give boots in flight a beat to admit
                    time.sleep(min(0.2, self.interval))
            elif len(new) < target:
                # devices still tied up in a retiring replica's drain
                time.sleep(min(0.2, self.interval))
            else:
                break
        obs_metrics.POD_RESHAPE_SECONDS.observe(time.monotonic() - t0)
        obs_metrics.POD_SCALE_EVENTS.inc("reshape", reason)
        obs_events.emit("reshape", phase="done", tp_to=tp_new,
                        reason=reason,
                        seconds=round(time.monotonic() - t0, 3),
                        replicas=len(self.ops.live_replicas()))
        _log.info("elastic_reshape_done", extra={
            "tp": tp_new, "seconds": round(time.monotonic() - t0, 3),
            "replicas": len(self.ops.live_replicas())})
