"""Replica registry: health probes, load scoring, hysteretic ejection —
a copy of ``dllama_tpu/router/registry.py``.

Each backend replica is probed every ``probe_interval`` seconds with
``GET /health`` and scored from the response's ``capacity`` block
(server/api.py serves it precisely so the router never scrapes
Prometheus text).  Dispatch picks the eligible backend with the highest
score; the score is deliberately simple and monotone in "how much of
this replica is idle":

    free_slots − queue_depth − router_in_flight (+ a free-KV-pages tiebreak)

with large penalties for a ``degraded`` replica (in this package: one
whose device step timed out, which also answers ``/health`` with 503) and
a ``violating`` SLO verdict, so a replica that is burning error budget
only takes traffic when nothing healthier can.

Ejection is hysteretic in both directions: ``eject_after`` consecutive
failures (probe or dispatch) before a backend stops receiving traffic,
``readmit_after`` consecutive healthy probes before it gets traffic
again.  One lucky probe does not un-eject a flapping replica, and one
lost packet does not eject a healthy one.  Draining replicas
(``status: "draining"``) are ineligible for dispatch but are NOT
ejected — drain is voluntary and the replica is still healthy enough
to finish and export its in-flight work.
"""

from __future__ import annotations

import http.client
import json
import threading
import time

from ..obs import events as obs_events, metrics as obs_metrics
from ..obs.log import get_logger

_log = get_logger("router.registry")

# score penalty that outweighs any realistic capacity signal: a
# degraded / SLO-violating replica only wins the pick when every
# alternative carries the same penalty
_PENALTY = 1e6


class Backend:
    """One replica's registry row.  Mutable fields are guarded by the
    owning :class:`Registry`'s lock."""

    def __init__(self, addr: str):
        self.addr = addr                  # "host:port" — also the metric label
        host, _, port = addr.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"--backends entry {addr!r} is not host:port")
        self.host, self.port = host, int(port)
        self.fail_streak = 0
        self.ok_streak = 0
        self.ejected = False
        self.retiring = False             # admission fence (elastic drain)
        self.last_health: dict | None = None
        self.last_probe_s: float | None = None  # EWMA probe RTT
        self.rtt_floor: float | None = None     # best EWMA ever seen
        self.in_flight = 0                # router-side active dispatches

    def rtt_degraded(self) -> bool:
        """Probe RTT has blown 10× past this backend's own baseline —
        the pre-hang signature (GC death spiral, device queue backing
        up).  The floor is clamped to 1 ms so a sub-millisecond loopback
        baseline cannot make normal jitter read as degradation, and the
        threshold to 50 ms so WAN-ish probes need a real excursion."""
        if self.last_probe_s is None or self.rtt_floor is None:
            return False
        return self.last_probe_s > max(10.0 * max(self.rtt_floor, 1e-3),
                                       0.05)

    def summary(self) -> dict:
        h = self.last_health or {}
        return {
            "addr": self.addr,
            "ejected": self.ejected,
            "retiring": self.retiring,
            "draining": h.get("status") == "draining",
            "fail_streak": self.fail_streak,
            "ok_streak": self.ok_streak,
            "in_flight": self.in_flight,
            "probe_s": self.last_probe_s,
            "rtt_degraded": self.rtt_degraded(),
            "capacity": h.get("capacity"),
            "degraded": h.get("degraded"),
            "slo": (h.get("slo") or {}).get("status") if h.get("slo")
            else None,
        }


class Registry:
    def __init__(self, addrs: list[str], *, probe_interval: float = 2.0,
                 eject_after: int = 3, readmit_after: int = 2,
                 probe_timeout: float = 5.0):
        if not addrs:
            raise ValueError("registry needs at least one backend")
        self.backends = [Backend(a) for a in addrs]
        self.probe_interval = float(probe_interval)
        self.eject_after = max(1, int(eject_after))
        self.readmit_after = max(1, int(readmit_after))
        self.probe_timeout = float(probe_timeout)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- probing -------------------------------------------------------
    def probe(self, b: Backend) -> bool:
        """One ``GET /health`` round trip; updates streaks and the
        latency gauge.  Returns True on a healthy (HTTP 200) answer."""
        t0 = time.monotonic()
        try:
            conn = http.client.HTTPConnection(b.host, b.port,
                                              timeout=self.probe_timeout)
            try:
                conn.request("GET", "/health")
                resp = conn.getresponse()
                body = resp.read()
                ok = resp.status == 200
                health = json.loads(body) if ok else None
            finally:
                conn.close()
        except (OSError, ValueError):
            ok, health = False, None
        rtt = time.monotonic() - t0
        with self._lock:
            if not ok:
                self._fail_locked(b, "probe")
                return False
            b.last_health = health
            # EWMA keeps the gauge stable across one slow GC pause but
            # tracking a genuinely slowing replica within a few probes
            b.last_probe_s = rtt if b.last_probe_s is None \
                else 0.7 * b.last_probe_s + 0.3 * rtt
            b.rtt_floor = b.last_probe_s if b.rtt_floor is None \
                else min(b.rtt_floor, b.last_probe_s)
            obs_metrics.ROUTER_BACKEND_LATENCY_S.set(
                b.addr, round(b.last_probe_s, 6))
            b.fail_streak = 0
            b.ok_streak += 1
            if b.ejected and b.ok_streak >= self.readmit_after:
                b.ejected = False
                obs_metrics.ROUTER_READMITS.inc(b.addr)
                obs_events.emit("readmit", replica=b.addr,
                                ok_streak=b.ok_streak)
                _log.info("backend %s re-admitted after %d healthy probes",
                          b.addr, b.ok_streak)
        return True

    def probe_all(self) -> None:
        # iterate a lock-held copy: the elastic controller adds and
        # removes backends at runtime from its own thread
        with self._lock:
            backends = list(self.backends)
        for b in backends:
            self.probe(b)

    def _probe_loop(self) -> None:
        while not self._stop.wait(self.probe_interval):
            self.probe_all()

    def start(self) -> None:
        """Synchronous first probe round (dispatch decisions are never
        made blind), then the background probe thread."""
        self.probe_all()
        self._thread = threading.Thread(target=self._probe_loop,
                                        name="router-probe", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.probe_timeout + 1.0)

    # -- runtime membership (elastic pod) ------------------------------
    def add(self, addr: str) -> Backend:
        """Register a backend at runtime.  The newcomer starts with no
        health record, so dispatch ignores it until its first healthy
        probe — the same hysteretic admission an ejected backend earns
        re-entry through."""
        b = Backend(addr)
        with self._lock:
            if any(x.addr == addr for x in self.backends):
                raise ValueError(f"backend {addr} already registered")
            self.backends.append(b)
        _log.info("backend %s registered at runtime", addr)
        return b

    def remove(self, addr: str) -> Backend | None:
        """Drop a backend's row.  In-flight dispatches holding the
        Backend object finish normally; only future picks stop seeing
        it."""
        with self._lock:
            for i, b in enumerate(self.backends):
                if b.addr == addr:
                    del self.backends[i]
                    _log.info("backend %s removed from registry", addr)
                    return b
        return None

    def retire(self, addr: str) -> None:
        """Admission fence: the backend stops receiving NEW dispatches
        immediately (before its own /health flips to draining), but is
        not ejected — it stays a valid hand-off exporter while it
        drains."""
        with self._lock:
            for b in self.backends:
                if b.addr == addr:
                    b.retiring = True
                    obs_events.emit("retire", replica=addr)
                    return

    def get(self, addr: str) -> Backend | None:
        with self._lock:
            for b in self.backends:
                if b.addr == addr:
                    return b
        return None

    def score(self, b: Backend) -> float:
        """Public idle-ness score (elastic victim selection)."""
        with self._lock:
            return self._score(b)

    # -- dispatch feedback ---------------------------------------------
    def _fail_locked(self, b: Backend, why: str) -> None:
        b.ok_streak = 0
        b.fail_streak += 1
        if not b.ejected and b.fail_streak >= self.eject_after:
            b.ejected = True
            obs_metrics.ROUTER_EJECTIONS.inc(b.addr)
            obs_events.emit("eject", replica=b.addr, why=why,
                            fail_streak=b.fail_streak)
            _log.warning("backend %s EJECTED after %d consecutive %s "
                         "failures", b.addr, b.fail_streak, why)

    def record_failure(self, b: Backend, why: str = "dispatch") -> None:
        with self._lock:
            self._fail_locked(b, why)

    def force_eject(self, b: Backend, why: str) -> None:
        """Immediate ejection, bypassing the failure-streak hysteresis —
        for signals where waiting out ``eject_after`` probes would keep
        feeding streams to a replica known to be wedged (the router's
        stream-stall watchdog).  Re-admission stays hysteretic: the
        replica earns its way back with ``readmit_after`` healthy
        probes like any ejected backend."""
        with self._lock:
            b.ok_streak = 0
            b.fail_streak = max(b.fail_streak, self.eject_after)
            if not b.ejected:
                b.ejected = True
                obs_metrics.ROUTER_EJECTIONS.inc(b.addr)
                obs_events.emit("eject", replica=b.addr, why=why,
                                forced=True)
                _log.warning("backend %s EJECTED (%s)", b.addr, why)

    def record_success(self, b: Backend) -> None:
        # a served request proves liveness as well as a probe does, but
        # re-admission stays probe-driven (readmit_after applies to
        # probes only, so the hysteresis clock has one owner)
        with self._lock:
            b.fail_streak = 0

    def acquire(self, b: Backend) -> None:
        with self._lock:
            b.in_flight += 1

    def release(self, b: Backend) -> None:
        with self._lock:
            b.in_flight = max(0, b.in_flight - 1)

    # -- scoring -------------------------------------------------------
    @staticmethod
    def _score(b: Backend, interactive: bool = False) -> float:
        h = b.last_health or {}
        cap = h.get("capacity") or {}
        free_slots = cap.get("free_slots")
        score = float(free_slots if free_slots is not None else 0)
        score -= float(cap.get("queue_depth") or 0)
        score -= float(b.in_flight)
        # KV tiebreak: prefer the tiering view when the replica reports
        # one — resident free pages plus pages reclaimable by spilling
        # idle slots (kv_pressure.effective_free) — falling back to the
        # plain free list for pre-tiering replicas
        kvp = cap.get("kv_pressure") or {}
        free_pages = kvp.get("effective_free")
        if free_pages is None:
            free_pages = cap.get("free_kv_pages")
        if free_pages is not None:
            # tiebreak only: a page is worth far less than a slot
            score += min(float(free_pages), 1e5) * 1e-6
        if h.get("degraded"):
            score -= _PENALTY
        if b.rtt_degraded():
            # pre-hang signature: probes still answer (no failure streak
            # to eject on) but 10× slower than this backend's own
            # baseline — steer traffic away BEFORE the full stall
            score -= _PENALTY
        if (h.get("slo") or {}).get("status") == "violating" \
                and not interactive:
            # steer low-priority dispatch away from a replica that is
            # burning its SLO budget, but keep it fully eligible for
            # interactive traffic — the replica sheds batch/standard
            # itself, so interactive capacity there is real
            score -= _PENALTY
        return score

    def _eligible_locked(self, exclude, *, handoff: bool) -> list[Backend]:
        out = []
        for b in self.backends:
            if b in exclude or b.ejected or b.retiring \
                    or b.last_health is None:
                continue
            h = b.last_health
            if h.get("status") == "draining":
                continue
            if handoff and not (h.get("capacity") or {}).get("handoff"):
                continue
            out.append(b)
        return out

    def pick(self, exclude=(), priority: str | None = None
             ) -> Backend | None:
        """Least-loaded eligible backend, or None when the fleet has no
        capacity to offer (all ejected/draining/excluded)."""
        interactive = priority == "interactive"
        with self._lock:
            cands = self._eligible_locked(set(exclude), handoff=False)
            if not cands:
                return None
            return max(cands,
                       key=lambda b: self._score(b, interactive))

    def eligible_backends(self) -> list[Backend]:
        """Every backend dispatch would consider right now (elastic
        signal sampling reads their cached health blocks)."""
        with self._lock:
            return self._eligible_locked((), handoff=False)

    def handoff_peers(self, exclude=()) -> list[Backend]:
        """Eligible hand-off importers, best-scored first (the record is
        offered to each in turn; a geometry 409 moves to the next)."""
        with self._lock:
            cands = self._eligible_locked(set(exclude), handoff=True)
            return sorted(cands, key=self._score, reverse=True)

    def snapshot(self) -> dict:
        with self._lock:
            rows = [b.summary() for b in self.backends]
        avail = sum(1 for r in rows
                    if not r["ejected"] and not r["draining"]
                    and not r["retiring"] and r["capacity"] is not None)
        return {"backends": rows, "available": avail,
                "total": len(rows)}
