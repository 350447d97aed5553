"""Always-on in-process spans in a bounded ring buffer — a copy of
``dllama_tpu/obs/trace.py``.

Every request records a handful of spans (request, queue_wait, prefill,
decode_chunk, emit; the scheduler's sched_admit, sched_step,
sched_retire) into a fixed-capacity deque, and ``GET /debug/trace`` dumps
the recent ones as Chrome ``trace_event`` JSON for ``chrome://tracing`` or
Perfetto (``?since=<seq>``: the raw incremental export).  Timestamps are
``time.perf_counter()`` seconds (µs in the export): they order and measure
within one process but are not wall-clock, so ``raw()`` samples
``(perf_now, wall_now)`` at serve time.  Capacity comes from
``--trace-buffer`` / ``DLLAMA_TRACE_BUFFER`` (default 8192 spans); a
malformed value warns once and falls back.

Fleet trace context: ``X-Dllama-Trace`` carries one id for a request's
whole life across router hops and DLREQ01 migrations.  The id rides a
contextvar for the accepting thread plus a bounded rid→trace map
(``set_trace``/``trace_of``) for threads that work on behalf of another
request (the scheduler loop stamps spans with an explicit ``rid``).
"""

from __future__ import annotations

import contextvars
import os
import re
import threading
import time
import uuid
from collections import OrderedDict, deque
from contextlib import contextmanager

from .log import get_logger, request_id_var

_log = get_logger("obs.trace")

DEFAULT_CAPACITY = 8192

_warned_specs: set = set()

# ---------------------------------------------------------------------------
# Fleet trace context (X-Dllama-Trace)
# ---------------------------------------------------------------------------

#: header value charset — same shape as request ids so proxies/log greps
#: treat them alike; anything else is stripped at the trust boundary.
_TRACE_RE = re.compile(r"[^A-Za-z0-9._-]")
_TRACE_MAX = 64

#: ambient trace id for the thread/task that accepted the request.
trace_id_var: contextvars.ContextVar = contextvars.ContextVar(
    "dllama_trace_id", default=None)

#: rid → trace id, bounded LRU so abandoned requests can't grow it.
_RID_TRACE_CAP = 4096
_rid_trace: OrderedDict = OrderedDict()
_rid_trace_lock = threading.Lock()


def new_trace_id() -> str:
    """A fresh 32-hex trace id (uuid4, no dashes) — traceparent-sized."""
    return uuid.uuid4().hex


def sanitize_trace_id(raw: str | None) -> str | None:
    """Clamp an untrusted header value to the id charset; None if empty."""
    if not raw:
        return None
    return _TRACE_RE.sub("", raw)[:_TRACE_MAX] or None


def set_trace(rid: str | None, trace_id: str | None) -> None:
    """Associate a request id with a trace id (LRU-bounded)."""
    if not rid or not trace_id:
        return
    with _rid_trace_lock:
        _rid_trace[rid] = trace_id
        _rid_trace.move_to_end(rid)
        while len(_rid_trace) > _RID_TRACE_CAP:
            _rid_trace.popitem(last=False)


def trace_of(rid: str | None) -> str | None:
    """The trace id associated with ``rid`` (or None)."""
    if not rid:
        return None
    with _rid_trace_lock:
        return _rid_trace.get(rid)


def parse_buffer_env(var: str, default: int) -> int:
    """Ring capacity from ``var``; a value that is not a positive integer
    logs one warning per distinct spec and falls back to ``default`` —
    never raises (the buffer size must not be able to take the server
    down)."""
    spec = os.environ.get(var)
    if spec is None or spec == "":
        return default
    try:
        cap = int(spec)
        if cap < 1:
            raise ValueError(spec)
        return cap
    except ValueError:
        key = (var, spec)
        if key not in _warned_specs:
            _warned_specs.add(key)
            _log.warning("%s=%r is not a positive integer; using default %d",
                         var, spec, default)
        return default


def _capacity() -> int:
    return parse_buffer_env("DLLAMA_TRACE_BUFFER", DEFAULT_CAPACITY)


class Tracer:
    """Lock + ring buffer of completed spans (dicts)."""

    def __init__(self, capacity: int | None = None):
        self._lock = threading.Lock()
        self._spans = deque(maxlen=capacity or _capacity())
        self._seq = 0

    def record(self, name: str, t0: float, t1: float, rid=None,
               **args) -> None:
        """Record a completed span; ``t0``/``t1`` are perf_counter secs.
        ``rid`` overrides the ambient contextvar request ID — threads that
        work on behalf of another request (the scheduler loop) stamp the
        ticket's ID explicitly.  The span's fleet trace id resolves from
        the rid→trace map first, then the ambient contextvar."""
        th = threading.current_thread()
        rid = rid if rid is not None else request_id_var.get()
        trace = trace_of(rid) or trace_id_var.get()
        span = {"name": name, "ts": t0, "dur": max(t1 - t0, 0.0),
                "tid": th.ident or 0, "thread": th.name,
                "rid": rid, "trace": trace, "args": args}
        with self._lock:
            self._seq += 1
            span["seq"] = self._seq
            self._spans.append(span)

    def resize(self, capacity: int) -> None:
        """Re-bound the ring, keeping the most recent spans that fit."""
        with self._lock:
            self._spans = deque(self._spans, maxlen=max(1, int(capacity)))

    @property
    def capacity(self) -> int:
        return self._spans.maxlen or 0

    @contextmanager
    def span(self, name: str, **args):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, t0, time.perf_counter(), **args)

    def snapshot(self) -> list[dict]:
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    def raw(self, since: int | None = None) -> dict:
        """Machine-oriented export for incremental polling: spans with
        their ring sequence numbers (only those after ``since`` when
        given), the cursor to pass next time, and a paired ``(perf_now,
        wall_now)`` clock sample so a consumer in another process can map
        perf_counter timestamps to wall-clock."""
        with self._lock:
            spans = [dict(s) for s in self._spans
                     if since is None or s.get("seq", 0) > since]
            next_seq = self._seq
        return {"spans": spans, "next_seq": next_seq,
                "capacity": self.capacity,
                "perf_now": time.perf_counter(), "wall_now": time.time()}

    def trace_events(self, last_requests: int | None = None) -> list[dict]:
        """Chrome ``trace_event`` array; optionally only the spans of the
        last N distinct request IDs (id-less spans always kept)."""
        spans = self.snapshot()
        if last_requests is not None:
            keep, order = set(), 0
            for s in reversed(spans):
                rid = s["rid"]
                if rid is not None and rid not in keep:
                    if order >= last_requests:
                        continue
                    keep.add(rid)
                    order += 1
            spans = [s for s in spans if s["rid"] is None or s["rid"] in keep]

        tids, names = {}, {}
        for s in spans:
            if s["tid"] not in tids:
                tids[s["tid"]] = len(tids) + 1
                names[s["tid"]] = s["thread"]

        events = [{"name": "thread_name", "ph": "M", "pid": 1, "tid": t,
                   "args": {"name": f"{names[raw]} ({raw})"}}
                  for raw, t in tids.items()]
        for s in spans:
            args = dict(s["args"])
            if s["rid"]:
                args["request_id"] = s["rid"]
            if s.get("trace"):
                args["trace_id"] = s["trace"]
            events.append({"name": s["name"], "cat": "dllama", "ph": "X",
                           "ts": round(s["ts"] * 1e6, 3),
                           "dur": round(s["dur"] * 1e6, 3),
                           "pid": 1, "tid": tids[s["tid"]], "args": args})
        return events

    def trace_json(self, last_requests: int | None = None) -> dict:
        return {"traceEvents": self.trace_events(last_requests),
                "displayTimeUnit": "ms"}


#: THE process-global tracer.
TRACER = Tracer()


def record(name: str, t0: float, t1: float, rid=None, **args) -> None:
    TRACER.record(name, t0, t1, rid=rid, **args)


def configure(capacity: int | None = None) -> None:
    """Apply a CLI-chosen capacity (``--trace-buffer``) after import."""
    if capacity is not None:
        TRACER.resize(capacity)


def span(name: str, **args):
    return TRACER.span(name, **args)


def trace_json(last_requests: int | None = None) -> dict:
    return TRACER.trace_json(last_requests)


def raw(since: int | None = None) -> dict:
    return TRACER.raw(since)


def clear() -> None:
    TRACER.clear()
