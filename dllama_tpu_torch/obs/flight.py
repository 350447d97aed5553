"""Per-request flight recorder and per-dispatch slot timeline — a copy of
``dllama_tpu/obs/flight.py`` without the kernel-degrade fields (the port
has no degrade path: a CUDA tensor launches its kernel or raises).

* :class:`FlightRecorder` keeps one lifecycle record per request, keyed by
  ``X-Request-Id``: submit time, queue wait, admit slot, every prefill
  chunk, decode burst and verify burst, the retire reason, the final TTFT
  and inter-token stats, the speculation counts (``spec_proposed``,
  ``spec_accepted``) and the roofline cost block (``obs/cost.py``:
  ``chip_ms``, ``flops``, ``hbm_bytes``, ``kv_page_ms``).  The slot scheduler fills it with per-dispatch
  detail, the mutex and lockstep paths with coarse phases; ``GET
  /debug/requests`` serves recent summaries, ``/debug/requests/<id>`` a
  whole record.
* :class:`SlotTimeline` keeps one entry per scheduler dispatch: each
  slot's phase (``prefill``/``decode``/``pad``), tokens produced, device
  time, and the host gap and idle sleep before it (``GET
  /debug/timeline``).

Ring capacities come from ``--flight-buffer`` / ``DLLAMA_FLIGHT_BUFFER``
(records), with the trace ring's warn-once fallback for a malformed
value.  Phase ``ms`` values are dispatch wall times: a mixed dispatch
charges its whole wall to every row that rode it.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque

from .log import current_request_id
from .trace import parse_buffer_env

DEFAULT_FLIGHT_CAPACITY = 512
DEFAULT_TIMELINE_CAPACITY = 4096


def _flight_capacity() -> int:
    return parse_buffer_env("DLLAMA_FLIGHT_BUFFER", DEFAULT_FLIGHT_CAPACITY)


class FlightRecorder:
    """Bounded insertion-ordered map of per-request lifecycle records.

    ``submit`` is get-or-create-or-merge: the server handler and the
    scheduler both call it for the same request ID (the ticket carries
    the handler's contextvar ID into the scheduler thread) and the two
    field sets union instead of clobbering.  A *retired* record under a
    reused ID is replaced — a client recycling ``X-Request-Id`` starts a
    fresh flight, it does not append to last week's."""

    def __init__(self, capacity: int | None = None):
        self._lock = threading.Lock()
        self._capacity = max(1, capacity if capacity is not None
                             else _flight_capacity())
        self._records: OrderedDict[str, dict] = OrderedDict()

    # -- capacity ----------------------------------------------------------
    def resize(self, capacity: int) -> None:
        with self._lock:
            self._capacity = max(1, int(capacity))
            while len(self._records) > self._capacity:
                self._records.popitem(last=False)

    @property
    def capacity(self) -> int:
        return self._capacity

    # -- lifecycle hooks ---------------------------------------------------
    def _rid(self, rid):
        return rid if rid is not None else current_request_id()

    def _get_locked(self, rid: str) -> dict | None:
        return self._records.get(rid)

    def submit(self, rid=None, **fields) -> None:
        """Open (or merge into) the record for ``rid``.  Fields already
        present win — first writer (usually the server handler) sets the
        authoritative submit picture, later writers only fill gaps."""
        rid = self._rid(rid)
        if rid is None:
            return
        with self._lock:
            rec = self._records.get(rid)
            if rec is not None and "finish" in rec:
                del self._records[rid]     # reused ID: start a fresh flight
                rec = None
            if rec is None:
                rec = {"request_id": rid,
                       "submitted_at": round(time.time(), 6),
                       "phases": [],
                       "itl": {"count": 0, "sum_s": 0.0, "max_s": 0.0}}
                self._records[rid] = rec
                while len(self._records) > self._capacity:
                    self._records.popitem(last=False)
            for k, v in fields.items():
                rec.setdefault(k, v)

    def admit(self, rid=None, *, slot=None, queued_ms=None, **fields) -> None:
        rid = self._rid(rid)
        if rid is None:
            return
        with self._lock:
            rec = self._get_locked(rid)
            if rec is None:
                return
            if slot is not None:
                rec["slot"] = slot
            if queued_ms is not None and "queued_ms" not in rec:
                rec["queued_ms"] = round(float(queued_ms), 3)
            rec["admitted_at"] = round(time.time(), 6)
            for k, v in fields.items():
                rec.setdefault(k, v)

    def phase(self, rid=None, kind: str = "", **fields) -> None:
        """Append one phase entry (``prefill_chunk`` / ``decode_burst`` /
        ``verify_burst``)."""
        rid = self._rid(rid)
        if rid is None:
            return
        with self._lock:
            rec = self._get_locked(rid)
            if rec is None:
                return
            entry = {"kind": kind}
            for k, v in fields.items():
                entry[k] = round(v, 3) if isinstance(v, float) else v
            rec["phases"].append(entry)

    def cost(self, rid=None, **inc) -> None:
        """Accumulate roofline cost attribution (``chip_ms``, ``flops``,
        ``hbm_bytes``, ``kv_page_ms``) into the record's cost block —
        one call per dispatch the request rode, raw floats summed here
        and rounded only at exposition (get/recent)."""
        rid = self._rid(rid)
        if rid is None:
            return
        with self._lock:
            rec = self._get_locked(rid)
            if rec is None:
                return
            cost = rec.setdefault(
                "cost", {"chip_ms": 0.0, "flops": 0.0,
                         "hbm_bytes": 0.0, "kv_page_ms": 0.0})
            for k, v in inc.items():
                cost[k] = cost.get(k, 0.0) + float(v)

    @staticmethod
    def _cost_view(rec: dict) -> dict | None:
        cost = rec.get("cost")
        if cost is None:
            return None
        return {k: round(v, 3) for k, v in cost.items()}

    def first_token(self, rid=None, ttft_s: float = 0.0) -> None:
        """The exact value the serving layer observed into the TTFT
        histogram — stored verbatim so record and histogram agree."""
        rid = self._rid(rid)
        if rid is None:
            return
        with self._lock:
            rec = self._get_locked(rid)
            if rec is not None and "ttft_s" not in rec:
                rec["ttft_s"] = float(ttft_s)

    def inter_token(self, rid=None, gap_s: float = 0.0) -> None:
        rid = self._rid(rid)
        if rid is None:
            return
        with self._lock:
            rec = self._get_locked(rid)
            if rec is None:
                return
            itl = rec["itl"]
            itl["count"] += 1
            itl["sum_s"] += float(gap_s)
            itl["max_s"] = max(itl["max_s"], float(gap_s))

    def retire(self, rid=None, reason: str = "done", **fields) -> None:
        """Close the record.  The first specific reason wins: the
        scheduler retires with stop/length/timeout/... before the server
        handler's generic fallback fires in its ``finally``."""
        rid = self._rid(rid)
        if rid is None:
            return
        with self._lock:
            rec = self._get_locked(rid)
            if rec is None or "finish" in rec:
                return
            rec["finish"] = reason
            rec["ended_at"] = round(time.time(), 6)
            rec["duration_ms"] = round(
                (rec["ended_at"] - rec["submitted_at"]) * 1e3, 3)
            itl = rec["itl"]
            if itl["count"]:
                itl["avg_s"] = round(itl["sum_s"] / itl["count"], 6)
            for k, v in fields.items():
                if v is not None:
                    rec.setdefault(k, v)

    # -- exposition --------------------------------------------------------
    def get(self, rid: str) -> dict | None:
        with self._lock:
            rec = self._records.get(rid)
            if rec is None:
                return None
            out = dict(rec)
            out["phases"] = [dict(p) for p in rec["phases"]]
            out["itl"] = dict(rec["itl"])
            if "cost" in rec:
                out["cost"] = self._cost_view(rec)
            return out

    def recent(self, n: int = 50) -> list[dict]:
        """Newest-first summaries for ``GET /debug/requests``."""
        with self._lock:
            recs = [dict(rec)
                    for rec in list(self._records.values())[-max(0, n):]]
        out = []
        for rec in reversed(recs):
            row = {k: rec.get(k) for k in
                   ("request_id", "submitted_at", "slot", "n_prompt",
                    "produced", "queued_ms", "ttft_s", "duration_ms",
                    "finish", "path", "priority", "preempt_count")}
            if "cost" in rec:
                row["cost"] = self._cost_view(rec)
            out.append(row)
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    def clear(self) -> None:
        with self._lock:
            self._records.clear()


class SlotTimeline:
    """Ring of per-dispatch entries, one slot map per scheduler step."""

    def __init__(self, capacity: int = DEFAULT_TIMELINE_CAPACITY):
        self._lock = threading.Lock()
        self._steps = deque(maxlen=max(1, capacity))
        self._seq = 0

    def record_step(self, *, ts: float, wall_ms: float,
                    device_ms: float | None = None,
                    host_gap_ms: float = 0.0, idle_ms: float = 0.0,
                    steps: int = 1, t_width: int = 1,
                    slots: list[dict] | None = None,
                    error: bool = False, overlapped: bool = False,
                    hidden_host_ms: float = 0.0,
                    discarded: bool = False) -> None:
        """``ts`` is the dispatch-start ``perf_counter`` (the span clock,
        so ``--slots`` tracks align with the request spans in Perfetto).

        ``overlapped`` marks a dispatch that was already enqueued on
        device while its predecessor landed; its ``hidden_host_ms`` is
        the host-side gap the device outlived (reported here and in the
        hidden-gap counter, NOT silently dropped — and not double-counted
        into ``host_gap_ms``, which stays the *exposed* gap).
        ``discarded`` marks a pipelined dispatch thrown away at a
        pipeline flush point: its tokens were never fanned out."""
        with self._lock:
            self._seq += 1
            entry = {"seq": self._seq, "t": round(time.time(), 6),
                     "ts": ts, "wall_ms": round(wall_ms, 3),
                     "host_gap_ms": round(host_gap_ms, 3),
                     "idle_ms": round(idle_ms, 3),
                     "steps": steps, "t_width": t_width,
                     "overlapped": bool(overlapped),
                     "hidden_host_ms": round(hidden_host_ms, 3),
                     "slots": slots or []}
            if device_ms is not None:
                entry["device_ms"] = round(device_ms, 3)
            if error:
                entry["error"] = True
            if discarded:
                entry["discarded"] = True
            self._steps.append(entry)

    def snapshot(self, n: int | None = None) -> list[dict]:
        with self._lock:
            steps = list(self._steps)
        if n is not None:
            steps = steps[-max(0, n):]
        return [dict(e) for e in steps]

    def clear(self) -> None:
        with self._lock:
            self._steps.clear()
            self._seq = 0


#: THE process-global rings both serving paths and /debug read.
RECORDER = FlightRecorder()
TIMELINE = SlotTimeline()


def submit(rid=None, **fields) -> None:
    RECORDER.submit(rid, **fields)


def admit(rid=None, **kw) -> None:
    RECORDER.admit(rid, **kw)


def phase(rid=None, kind: str = "", **fields) -> None:
    RECORDER.phase(rid, kind, **fields)


def first_token(rid=None, ttft_s: float = 0.0) -> None:
    RECORDER.first_token(rid, ttft_s)


def inter_token(rid=None, gap_s: float = 0.0) -> None:
    RECORDER.inter_token(rid, gap_s)


def retire(rid=None, reason: str = "done", **fields) -> None:
    RECORDER.retire(rid, reason, **fields)


def cost(rid=None, **inc) -> None:
    RECORDER.cost(rid, **inc)


def get(rid: str) -> dict | None:
    return RECORDER.get(rid)


def recent(n: int = 50) -> list[dict]:
    return RECORDER.recent(n)


def configure(capacity: int | None = None) -> None:
    """Apply a CLI-chosen capacity (``--flight-buffer``) after import."""
    if capacity is not None:
        RECORDER.resize(capacity)


def clear() -> None:
    RECORDER.clear()
    TIMELINE.clear()
