"""Continuous-batching slot scheduler over the slot engine — a copy of
``dllama_tpu/runtime/scheduler.py``.

One daemon thread owns the ``--batch-slots`` engine and drives
:meth:`Engine.slot_step_async`, admitting a waiting request into any free
slot between dispatches and retiring finished ones without disturbing
their neighbors (iteration-level scheduling, Orca OSDI'22 / vLLM
SOSP'23).  Per dispatch:

* every active slot is either **prefilling** (its prompt feeds in chunks
  of ``prefill_chunk`` tokens, riding the same mixed forward as its
  neighbors' decode tokens) or **decoding** (feeds its previous sample);
* when no slot is mid-prefill, decode runs in on-device bursts
  (``steps > 1``), clamped so queued work waits at most ~``max_wait_ms``;
* a freed slot is reused by handing its row position 0 again: the last
  occupant's KV sits above the newcomer's causal ceiling, so the cache is
  never zeroed;
* with ``overlap`` (default on, ``--no-sched-overlap`` turns it off)
  steady-state decode runs as a two-deep pipeline: while dispatch N's
  tokens land and fan out host-side, dispatch N+1 is already enqueued on
  the device, fed by N's on-device last-token row (``slot_step_async``'s
  ``feed_dev``: no device→host→device round trip).  Every *flush point* —
  a queued ticket awaiting admission, cancel or deadline,
  ``exclusive()`` parking, :meth:`flush`, drain and close — completes the
  round synchronously: the pipelined dispatch is landed and discarded,
  its KV writes sit above every surviving row's position (masked by the
  causal ceiling exactly like slot reuse), and greedy output stays
  byte-identical with overlap on or off.  A row that retires in N's
  fanout (EOS, budget) leaves N+1 row-wise: its burst row is ignored;
* with a ``spec`` proposer (``runtime/spec.py``, ``--spec pld|draft``),
  each greedy decode slot drafts up to ``spec_k`` tokens after a dispatch
  lands, and the next dispatch is a ragged verify step
  (:meth:`Engine.slot_verify_async`, a fixed window of ``spec_k + 1``
  columns): proposing rows feed their drafts, the others ride as one
  plain decode step, and each row emits its accepted leading drafts and
  one more token, all the target model's own argmax, so greedy output is
  byte-identical with speculation on or off.  A rejection truncates that
  row alone (its stale KV sits above its ceiling), and every flush point
  (retire, park, export, drain) drops pending drafts.  Speculation
  supersedes the overlapped pipeline while armed: a window's drafts
  depend on the previous dispatch's landed tokens.

Paged engines (``engine.kv_pages > 0``) reserve pages at admission.  Under
``kv_reserve="full"`` (the default) that is every page a request can touch
(prompt + budget), so a dispatch never fails on allocation and exhaustion
surfaces as queueing.  Under ``"optimistic"`` admission binds only
``ceil((prompt + spill_headroom)/page)`` pages and slots grow page by page
between rounds through a reclaim ladder (free list, radix eviction, then a
spill of the idle-longest neighbour's pages to a bytes-bounded pinned host
pool, ``runtime/kvtier.py``); a spilled slot sits out the dispatches until
its pages page back in, and a slot the ladder cannot grow is preempted.
With ``prefix_reuse`` a radix tree over full prompt pages lets a later
prompt with the same prefix bind those pages copy-free and prefill only its
suffix.

**Moving a request's KV off the card and back** (``runtime/snapshot.py``):
every move happens at a step boundary with zero dispatches in flight (the
exporters run inside :meth:`SlotScheduler._flushed`; admission, preemption
and tiering run between rounds), and every write back lands in place in the
engine's pool (``Engine.write_pool_pages``), so the captured graphs stay
valid.

* hand-off: :meth:`SlotScheduler.handoff_export_all` (drain),
  :meth:`checkpoint_export` (one live slot, non-destructive) and
  :meth:`import_request` move a live request between replicas as a DLREQ01
  record; the importer allocates its own pages and resumes the clocks;
* QoS: every request has a priority class (:data:`PRIORITY_LEVELS`);
  admission takes the best effective level (aged by ``preempt_age_ms``),
  and a request that finds no slot or pages may preempt a strictly
  lower-priority slot, which is exported and parked (in RAM or
  ``spill_dir``) with its ticket live and resumes byte for byte later;
  past ``preempt_cap`` or a full parked area the victim retires
  ``preempted``;
* snapshots: :meth:`snapshot_paged` and :meth:`restore_paged` keep the
  pool, the page tables and the radix tree's keys across a restart.

Each request gets a :class:`Ticket`, a thread-safe token stream the HTTP
handler consumes.  Cancellation (disconnect, stop string, deadline) takes
effect at the next step boundary.  A failed dispatch retires every active
slot with the error and the loop keeps serving.  Greedy requests produce
the same tokens whichever slot they land in and whatever their neighbors
do; sampled requests draw from the engine's shared generator, so their
draws depend on co-scheduling.

Observability (``obs/``), at the JAX package's call sites: the registry's
scheduler, KV-pool and goodput families (every millisecond between the
first dispatch and the latest land lands in one of the ``prefill``,
``decode``, ``pad``, ``host_gap`` and ``idle`` components), a flight
record a request (submit, admit, prefill chunks, decode and verify
bursts, its cost block, retire), a slot-timeline entry a dispatch, and
``sched_admit``/``sched_step``/``sched_verify``/``sched_retire`` spans.
Every landed dispatch is costed by the roofline model (``obs/cost.py``:
the ``dispatch_flops``/``dispatch_bytes`` families, per-request chip
time, ``class_chip_ms``, the ``mfu``/``mbu`` gauges).  ``stats`` keeps
this scheduler's own counts (the registry is the process's).

Fault points (``runtime/faults.py``), where the JAX package fires them:
``kv.spill`` before a slot's pages move to the host pool (a raise there
abandons the spill and the ladder falls back to preemption, as the JAX
package documents; its own loop dies there instead), ``sched.host_fanout``
after a dispatch lands.
A hand-off record carries the request's fleet trace id (``trace_id``).
"""

from __future__ import annotations

import contextlib
import logging
import math
import os
import queue
import threading
import time
from collections import deque

import numpy as np

from ..obs import cost as obs_cost, dispatch as obs_dispatch
from ..obs import events as obs_events, flight as obs_flight
from ..obs import metrics as obs_metrics, trace as obs_trace
from ..obs.log import current_request_id, new_request_id, request_id_var
from . import kvtier, snapshot as snapfmt
from .engine import ContextOverflow, record_rng_kind
from .faults import FAULTS
from .pagepool import PagePool, PagePoolExhausted, RadixTree

_log = logging.getLogger("dllama_tpu_torch.runtime.scheduler")

_DONE = object()  # ticket stream terminator

# QoS classes (lower level = more important): the body field ``priority``
# and the X-Dllama-Priority header name them; admission orders by level and
# a request preempts strictly lower-priority slots
PRIORITY_LEVELS = {"interactive": 0, "standard": 1, "batch": 2}
PRIORITY_NAMES = {v: k for k, v in PRIORITY_LEVELS.items()}

#: a sampled request's record names its sampler so: the JAX package's
#: importers (sampling path ``device``) refuse it, as a greedy record (which
#: keeps ``device``) crosses either way
SAMPLED_PATH = "torch-generator"


class SchedulerClosed(RuntimeError):
    """submit() after begin_drain()/close(): no new work is admitted."""


class SchedulerSaturated(RuntimeError):
    """submit() with the wait queue at its bound (the server answers 429)."""


class Ticket:
    """One request's handle: a token stream plus the finish verdict.
    Produced by the scheduler thread, consumed by the HTTP handler
    thread; ``cancel`` may be called from either side."""

    def __init__(self, prompt, max_new, temperature, top_p, eos_ids,
                 deadline, priority: int = 1, top_k: int = 0):
        self.prompt = list(prompt)
        self.max_new = int(max_new)
        self.temperature = float(temperature)
        self.top_p = float(top_p)
        self.top_k = int(top_k)
        self.eos_ids = tuple(eos_ids)
        self.deadline = deadline  # time.monotonic() or None
        # finish: stop/length/timeout/aborted/error/handoff/preempted
        self.finish: str | None = None
        self.error: BaseException | None = None
        self.slot: int | None = None
        self.submitted_at = time.monotonic()
        # QoS: the level (PRIORITY_LEVELS), how often it was preempted and
        # parked, and the ms it spent parked; KV tiering: the ms its pages
        # sat in the host pool.  All four ride a DLREQ01 record.
        self.priority = int(priority)
        self.preempt_count = 0
        self.parked_ms = 0.0
        self.spill_ms = 0.0
        #: monotonic time of the first completion token (time to first token)
        self.first_token_at: float | None = None
        #: prompt tokens this request fed through the model (a prefix-cache
        #: hit skips the rest)
        self.prefilled = 0
        # hand-off state: the server parks its stop strings here and every
        # emitted token is kept, so an exported record can rebuild the
        # decode and stop-scan state on the importer
        self.stop: list[str] = []
        self.emitted: list[int] = []
        # speculative decoding: drafts proposed for and accepted by this
        # request's verify steps (flight record, /debug/requests)
        self.spec_proposed = 0
        self.spec_accepted = 0
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._cancel: str | None = None
        self._on_cancel = None  # scheduler wakeup, bound at submit
        self._page_deferred = False
        # the submitting thread's X-Request-Id rides the ticket onto the
        # scheduler thread (flight records, spans, log records)
        self.rid: str = current_request_id() or new_request_id()

    def cancel(self, reason: str = "aborted") -> None:
        """Retire this request at the next step boundary (idempotent).  A
        queued ticket is dropped without ever occupying a slot."""
        if self._cancel is None and self.finish is None:
            self._cancel = reason
            if self._on_cancel is not None:
                self._on_cancel()

    def tokens(self):
        """Yield completion token ids until the request retires; then
        ``finish`` holds the verdict.  A scheduler-side failure re-raises
        here, on the consumer's thread."""
        while True:
            item = self._q.get()
            if item is _DONE:
                break
            yield item
        if self.error is not None:
            raise self.error


class _Slot:
    __slots__ = ("ticket", "pos", "fed", "produced", "last", "pages",
                 "prefix_tokens", "inserted", "budget", "spilled", "active_at")

    def __init__(self):
        self.ticket: Ticket | None = None
        self.pos = 0        # this row's cache clock
        self.fed = 0        # prompt tokens consumed so far
        self.produced = 0   # completion tokens emitted
        self.last = 0       # previous sample (decode feedback)
        self.pages: list[int] = []   # paged mode: owned pool pages
        self.prefix_tokens = 0       # prompt tokens bound from the radix tree
        self.inserted = False        # prompt pages handed to the tree yet?
        # KV tiering: the most pages this request can need (the growth
        # ceiling), whether its pages sit in the host pool (it then sits out
        # the dispatches), and the monotonic time it last took part in a
        # dispatch (the idle-longest slot spills first)
        self.budget = 0
        self.spilled = False
        self.active_at = 0.0


class _Parked:
    """A preempted request: its live ticket (the consumer still waits on
    the stream: parking is a stall) and the DLREQ01 record that resumes
    it, in RAM (``blob``) or in ``spill_dir`` (``path``)."""

    __slots__ = ("ticket", "blob", "path", "parked_at")

    def __init__(self, ticket, blob, path, parked_at):
        self.ticket = ticket
        self.blob = blob
        self.path = path
        self.parked_at = parked_at


class _Pending:
    """One in-flight dispatch: the engine's completion handle plus who rode
    it, with how many valid tokens each, and with which sampling params.
    The pipeline in :meth:`SlotScheduler._dispatch` keeps at most one of
    these beyond the dispatch it is landing (depth 2)."""

    __slots__ = ("handle", "error", "active", "tickets", "steps", "n_valid",
                 "temps", "topps", "topks", "prefset", "enq_tp", "overlapped",
                 "t_width", "pos_rows", "queued", "t0_mono", "host_gap_ms", "idle_ms",
                 "verify", "proposed_by_slot")

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw.get(k))


class SlotScheduler:
    """Owns the batch engine; see the module docstring.  ``max_queue``
    bounds requests waiting for a slot (beyond it submit() raises
    :class:`SchedulerSaturated`).  QoS (paged only: a victim leaves
    through the DLREQ01 export): ``preempt``, ``preempt_age_ms`` (a queued
    request climbs one class per this many ms; 0: no aging),
    ``preempt_cap`` (parks a request at most this often), ``parked_max``
    (default ``max_queue``) and ``spill_dir`` (parked records on disk).
    KV tiering (paged only): ``kv_reserve`` ``"full"`` or
    ``"optimistic"``, ``spill_headroom`` tokens bound beyond the prompt,
    ``host_pool_mb`` the host pool's budget (0: no spill).  Speculation:
    ``spec`` a :class:`runtime.spec.Proposer` (None: off), ``spec_k`` the
    most drafts a row a verify step."""

    def __init__(self, engine, *, prefill_chunk: int = 16,
                 max_wait_ms: float = 50.0, decode_burst: int = 16,
                 max_queue: int = 32, prefix_reuse: bool = True,
                 overlap: bool = True, preempt: bool = True,
                 preempt_age_ms: float = 5000.0, preempt_cap: int = 3,
                 parked_max: int | None = None, spill_dir: str | None = None,
                 kv_reserve: str = "full", spill_headroom: int = 16,
                 host_pool_mb: float = 64.0, spec=None, spec_k: int = 4):
        if engine.cache.quantized and not engine.paged:
            raise ValueError("slot scheduling needs a dense or paged-int8 KV cache")
        if kv_reserve not in ("full", "optimistic"):
            raise ValueError(f"kv_reserve must be 'full' or 'optimistic', got {kv_reserve!r}")
        self.engine = engine
        self.slots = [_Slot() for _ in range(engine.batch)]
        self.prefill_chunk = max(1, int(prefill_chunk))
        # speculative decoding (runtime/spec.py): the proposer (None: off)
        # and per-slot pending drafts collected at land time, each tagged
        # with the ticket it was drafted for, so a re-bound slot never
        # consumes a predecessor's drafts.  Host-side; flush points clear it
        self.spec = spec
        self.spec_k = max(1, int(spec_k))
        self._proposals: dict[int, tuple[Ticket, list[int]]] = {}
        self.max_wait_ms = float(max_wait_ms)
        self.decode_burst = max(1, int(decode_burst))
        self.max_queue = max(1, int(max_queue))
        self.paged = bool(engine.paged)
        self.pool: PagePool | None = None
        self.prefix_cache: RadixTree | None = None
        self.kv_reserve = kv_reserve
        self.optimistic = self.paged and kv_reserve == "optimistic"
        self.spill_headroom = max(0, int(spill_headroom))
        self.host_pool: kvtier.HostPagePool | None = None
        self._spilled: dict[int, dict] = {}   # slot -> its spill record's bookkeeping
        self._page_nbytes = 0                 # one page, every plane, every layer
        if self.paged:
            self.pool = PagePool(engine.kv_pages, engine.kv_page_size)
            if prefix_reuse:
                self.prefix_cache = RadixTree(self.pool)
            self._page_tables = np.zeros(
                (engine.batch, engine.max_pages_per_slot), np.int32)
            self.host_pool = kvtier.HostPagePool(int(float(host_pool_mb) * (1 << 20)))
            self._page_nbytes = sum(
                int(np.prod([ts[0].shape[0], sum(t.shape[2] for t in ts), *ts[0].shape[3:]]))
                * ts[0].element_size() for ts in engine.kv_planes().values())
            obs_metrics.KV_PAGES_TOTAL.set(self.pool.capacity)
            obs_metrics.KV_PAGES_IN_USE.set(0)
        # QoS (see the class docstring); beyond preempt_cap or parked_max a
        # victim retires "preempted" instead of parking
        self.preempt = bool(preempt)
        self.preempt_age_ms = float(preempt_age_ms)
        self.preempt_cap = max(0, int(preempt_cap))
        self.parked_max = self.max_queue if parked_max is None else max(0, int(parked_max))
        self.spill_dir = spill_dir
        self._parked: list[_Parked] = []
        #: plain counters: dispatches landed, of them pipelined ones
        #: (``overlapped``) and pipelined ones landed and discarded at a
        #: flush point, prefill tokens fed, prefix-cache hits and the prompt
        #: tokens they skipped, admissions deferred for pages; preemptions,
        #: parked requests resumed, pages spilled and paged in, requests
        #: exported and imported
        self.stats = {"dispatches": 0, "overlapped": 0, "discarded": 0,
                      "prefill_tokens": 0, "prefix_hits": 0,
                      "prefix_tokens_reused": 0, "kv_pool_exhausted": 0,
                      "preemptions": 0, "resumed": 0, "pages_spilled": 0,
                      "pages_paged_in": 0, "exported": 0, "imported": 0,
                      "verify_dispatches": 0, "spec_proposed": 0, "spec_accepted": 0}
        self._queue: deque[Ticket] = deque()
        self._cond = threading.Condition()
        # serializes the engine's device calls between the dispatch loop and
        # the export and import paths, which run on other threads; held
        # only around those calls, never while taking _cond
        self._engine_lock = threading.Lock()
        self._draining = False
        self._stop = False
        self._idle = threading.Event()  # set while paused with empty slots
        self._paused = 0
        self._step_ms_ema: float | None = None
        # overlapped-dispatch pipeline (see module docstring).  Mutated on
        # the scheduler thread only; _inflight_n is also read under _cond
        # by _flushed() waiters, and _flush_req is written by them.
        self.overlap = bool(overlap)
        self._inflight_n = 0     # pipelined dispatches on the device
        self._flush_req = 0      # >0: flush requested, pipelining blocked
        self._last_land: float | None = None  # perf_counter of the last land
        self._depth = 0          # dispatches enqueued and not yet landed
        # goodput accounting: every ms between the first dispatch and the
        # latest land lands in exactly one component
        self._idle_accum = 0.0   # seconds slept waiting for work since the last dispatch
        self._comp = dict.fromkeys(("prefill", "decode", "pad", "host_gap", "idle"), 0.0)
        # roofline cost attribution (obs/cost.py): analytic FLOPs and bytes
        # a landed dispatch; None when the engine could not be modelled
        # (serving never depends on the accounting)
        self.cost_model = obs_cost.model_from_engine(engine)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="dllama-torch-slot-scheduler")
        self._thread.start()

    # -- submission-side API -------------------------------------------
    def submit(self, prompt: list[int], max_new: int, *,
               temperature: float = 0.0, top_p: float = 0.9,
               top_k: int = 0, eos_ids: tuple[int, ...] = (),
               deadline: float | None = None, priority: int = 1) -> Ticket:
        """Queue one request; returns its :class:`Ticket` immediately.
        ``deadline`` is a ``time.monotonic()`` instant; an expired request
        retires with finish ``timeout`` and what it produced.  ``priority``
        is a :data:`PRIORITY_LEVELS` level."""
        if not prompt:
            raise ValueError("empty prompt")
        if max_new < 1:
            raise ValueError("max_new must be positive")
        if self.pool is not None:
            # a reservation larger than the whole pool would wait forever:
            # a sizing error, not transient saturation
            need = min(len(prompt) + max_new, self.engine.seq_len)
            n_pages = -(-need // self.pool.page_size)
            if n_pages > self.pool.capacity:
                raise ContextOverflow(
                    f"request needs {n_pages} KV pages but the pool has "
                    f"{self.pool.capacity}; raise --kv-pages or shorten the request")
        t = Ticket(prompt, max_new, temperature, top_p, eos_ids, deadline,
                   priority=max(0, min(max(PRIORITY_NAMES), int(priority))), top_k=top_k)
        with self._cond:
            if self._stop or self._draining:
                raise SchedulerClosed("scheduler is draining")
            # admission runs on the scheduler thread: tickets that free
            # slots will absorb at once do not count against the bound
            free = sum(1 for s in self.slots if s.ticket is None)
            if len(self._queue) >= self.max_queue + (0 if self._paused else free):
                raise SchedulerSaturated(f"{len(self._queue)} requests already waiting")
            t._on_cancel = self._wake
            self._queue.append(t)
            self._cond.notify_all()
        obs_flight.submit(t.rid, n_prompt=len(t.prompt), max_new=t.max_new,
                          temperature=t.temperature, source="scheduler",
                          priority=PRIORITY_NAMES.get(t.priority, "standard"))
        return t

    def occupancy(self) -> dict:
        """Live state for /health and the over-capacity error body."""
        with self._cond:
            out = {"slots": len(self.slots),
                   "active": sum(1 for s in self.slots if s.ticket is not None),
                   "queued": len(self._queue), "parked": len(self._parked)}
            if self.pool is not None:
                out["kv_pages_total"] = self.pool.capacity
                out["kv_pages_free"] = self.pool.available
                if self.prefix_cache is not None:
                    out["prefix_nodes"] = len(self.prefix_cache)
                # tiering pressure: resident free pages plus what one spill
                # pass could free into the host pool
                owned = sum(len(s.pages) for s in self.slots
                            if s.ticket is not None and not s.spilled)
                headroom = max(0, self.host_pool.capacity_bytes
                               - self.host_pool.bytes_used) // self._page_nbytes
                spillable = min(owned, headroom) if self.optimistic else 0
                out["kv_pressure"] = {
                    "reserve": self.kv_reserve,
                    "resident_free": self.pool.available,
                    "spillable": spillable,
                    "effective_free": self.pool.available + spillable,
                    "host_pool_bytes": self.host_pool.bytes_used,
                    "spilled_slots": len(self._spilled),
                    "codec": "int8" if self.engine.cache.quantized
                    else snapfmt.dtype_of(self.engine.cache.k.dtype),
                }
            out.update(self.stats)
            return out

    def begin_drain(self, deadline: float | None) -> None:
        """Stop admitting and clamp every live, queued and parked
        deadline."""
        with self._cond:
            self._draining = True
            # a drain is a flush point: pending drafts die (no new ones are
            # collected while draining)
            self._proposals.clear()
            for t in (list(self._queue) + [s.ticket for s in self.slots if s.ticket is not None]
                      + [e.ticket for e in self._parked]):
                t.deadline = min(t.deadline, deadline) \
                    if (t.deadline and deadline) else (t.deadline or deadline)
            self._cond.notify_all()

    def drain_with_export(self, deadline: float | None) -> dict[str, bytes]:
        """Stop admissions, clamp every deadline, and export every live slot
        (and every parked request) as a DLREQ01 record in one call; returns
        the records by request id (``{}`` without a paged pool)."""
        self.begin_drain(deadline)
        return self.handoff_export_all()

    def close(self, timeout: float = 5.0) -> None:
        """Stop the loop; still-live tickets retire as ``aborted``."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        self._thread.join(timeout)

    @contextlib.contextmanager
    def exclusive(self):
        """Park the scheduler until every slot has retired, so the caller
        may run other work on the card (the server's batch-1 mutex path).
        Admission pauses; queued requests keep their place."""
        with self._cond:
            self._paused += 1
            self._cond.notify_all()
        self._idle.wait()
        try:
            yield
        finally:
            with self._cond:
                self._paused -= 1
                if self._paused == 0:
                    self._idle.clear()
                self._cond.notify_all()

    def _wake(self):
        with self._cond:
            self._cond.notify_all()

    # -- pipeline flush ------------------------------------------------
    @contextlib.contextmanager
    def _flushed(self):
        """Hold the dispatch pipeline empty: block new pipelining, wait
        for any in-flight pipelined dispatch to land (it is discarded at
        the flush point), then yield with ``self._cond`` held and zero
        dispatches in flight."""
        with self._cond:
            self._flush_req += 1
            self._cond.notify_all()
            try:
                if not self._cond.wait_for(lambda: self._inflight_n == 0, timeout=60.0):
                    _log.error("pipeline flush timed out with %d in flight",
                               self._inflight_n)
                yield
            finally:
                self._flush_req -= 1
                self._cond.notify_all()

    def flush(self) -> None:
        """Synchronize the dispatch pipeline: returns only once zero
        pipelined dispatches are in flight."""
        with self._flushed():
            pass

    # -- paged state snapshot and restore (DLSNAP02) --------------------
    def snapshot_paged(self, path, extra: dict | None = None) -> str:
        """Save the paged serving state: the pool rides the engine's
        snapshot, the page tables go as an extra array and the radix tree's
        token keys and pages in the meta.  Call with no live slot (drain or
        ``exclusive()`` first)."""
        if self.pool is None:
            raise ValueError("snapshot_paged on a non-paged scheduler")
        with self._cond:
            if self._active():
                raise RuntimeError("snapshot_paged with live slots; drain first")
            meta = dict(extra or {})
            meta["radix"] = self.prefix_cache.export() if self.prefix_cache is not None else []
            with self._engine_lock:
                return self.engine.snapshot(
                    path, extra=meta, extra_arrays={"page_tables": self._page_tables.copy()})

    def restore_paged(self, path) -> dict:
        """Restore :meth:`snapshot_paged` state: the engine checks the file
        and its fingerprint (the pool geometry is part of it, so another
        geometry raises :class:`snapshot.SnapshotMismatch` and the caller
        cold-starts) and writes the pool in place; the page pool and the
        radix tree are rebuilt from the tree's keys, reclaiming their
        pages.  Returns the snapshot's ``extra``."""
        if self.pool is None:
            raise ValueError("restore_paged on a non-paged scheduler")
        with self._cond:
            if self._active():
                raise RuntimeError("restore_paged with live slots")
            with self._engine_lock:
                extra = self.engine.restore(path)
            pt = self.engine.restored_arrays.get("page_tables")
            if pt is not None and pt.shape == self._page_tables.shape:
                self._page_tables[:] = pt
            self.pool = PagePool(self.engine.kv_pages, self.engine.kv_page_size)
            if self.prefix_cache is not None:
                self.prefix_cache = RadixTree(self.pool)
                self.prefix_cache.restore(extra.get("radix") or [])
            # spill records describe the pool before the restore
            self.host_pool.clear()
            self._spilled.clear()
            obs_metrics.KV_PAGES_IN_USE.set(self.pool.in_use)
            return extra

    # -- per-request KV hand-off (DLREQ01) -------------------------------
    def _export_slot_locked(self, slot_idx: int) -> bytes:
        """One live slot as a DLREQ01 record (caller holds ``_cond``, zero
        dispatches in flight): its written pages (positions ``[0, pos)``),
        the prompt and completion tokens, the sampling parameters, the
        deadline left, the QoS clocks and the generator's state.  A spilled
        slot's pages come from its host-pool copy."""
        s = self.slots[slot_idx]
        t = s.ticket
        eng = self.engine
        n_data = math.ceil(s.pos / self.pool.page_size)
        deadline_left = None
        if t.deadline is not None:
            deadline_left = max(t.deadline - time.monotonic(), 0.0)
        if s.spilled:
            rec = self.host_pool.get(self._spill_key(slot_idx))
            if rec is None:
                raise RuntimeError(f"slot {slot_idx} marked spilled but its host-pool "
                                   "record is missing")
            arrays = {name: np.asanyarray(a)[:, :n_data] for name, a in rec[0].items()}
        else:
            with self._engine_lock:
                arrays = eng.read_pool_pages(s.pages[:n_data])
        arrays.update(eng.rng_arrays())
        return snapfmt.dumps_request(
            fingerprint=eng.handoff_fingerprint(), pos=s.pos, chunk_counter=0,
            arrays=arrays,
            extra={
                "rid": t.rid, "prompt": list(t.prompt), "completion": list(t.emitted),
                "max_new": t.max_new, "temperature": t.temperature, "top_p": t.top_p,
                "top_k": t.top_k,
                "sampling_path": eng.sampling_path if t.temperature == 0.0 else SAMPLED_PATH,
                "rng_kind": eng.rng_kind,
                "eos_ids": list(t.eos_ids), "stop": list(t.stop),
                "deadline_left": deadline_left,
                "fed": s.fed, "produced": s.produced, "last": s.last,
                "priority": t.priority, "preempt_count": t.preempt_count,
                "parked_ms": t.parked_ms, "spill_ms": t.spill_ms,
                "trace_id": obs_trace.trace_of(t.rid),
            })

    def handoff_export_all(self) -> dict[str, bytes]:
        """Drain-time hand-off: flush the pipeline, export every live slot
        as a DLREQ01 record keyed by request id and retire it ``handoff``;
        parked requests ship their records as they are; queued tickets
        retire ``handoff`` with no record (nothing was streamed: the router
        resubmits them)."""
        if self.pool is None:
            return {}
        records: dict[str, bytes] = {}
        with self._flushed():
            for i in self._active():
                t = self.slots[i].ticket
                try:
                    records[t.rid] = self._export_slot_locked(i)
                    self.stats["exported"] += 1
                    obs_flight.phase(t.rid, "handoff", direction="export", slot=i,
                                     pos=self.slots[i].pos)
                except Exception as e:
                    # one unexportable slot drains as a plain abort
                    _log.error("handoff export of %s failed: %r", t.rid, e)
                self._retire(i, "handoff")
            for e in list(self._parked):
                t = e.ticket
                try:
                    blob = e.blob
                    if blob is None:
                        with open(e.path, "rb") as f:
                            blob = f.read()
                    records[t.rid] = blob
                except Exception as exc:
                    _log.error("handoff export of parked %s failed: %r", t.rid, exc)
                self._drop_parked_locked(e)
                self._fail_ticket(t, "handoff")
            while self._queue:
                self._fail_ticket(self._queue.popleft(), "handoff")
            self._cond.notify_all()
        for rid in records:
            obs_events.emit("handoff", direction="export", rid=rid)
        return records

    def checkpoint_export(self, rid: str) -> bytes | None:
        """A non-destructive DLREQ01 record of the live slot serving
        ``rid`` (the slot keeps decoding), taken with the pipeline flushed;
        None when ``rid`` holds no live slot."""
        if self.pool is None:
            return None
        with self._flushed():
            for i in self._active():
                t = self.slots[i].ticket
                if t.rid == rid:
                    return self._export_slot_locked(i)
        return None

    def import_request(self, blob) -> tuple[Ticket, dict]:
        """Bind an exported request (DLREQ01 bytes) to a free slot: allocate
        this pool's own pages, write the record's pages into them in place,
        and resume the slot's clocks where the exporter stopped, so a
        continued greedy decode equals the uninterrupted one.

        Raises :class:`ArtifactError` on a corrupt record,
        :class:`snapshot.SnapshotMismatch` on another geometry, pages that
        disagree with the position, or a sampled stream from another kind of
        generator (``rng_kind``), :class:`SchedulerSaturated` without a free
        slot or pages, :class:`SchedulerClosed` while draining.  The
        record's generator state is taken only when nothing else is live
        here (the generator is shared by the slots).  Returns ``(ticket,
        record extra)``."""
        if self.pool is None:
            raise ValueError("hand-off import needs a paged scheduler (--kv-pages)")
        meta, arrays = snapfmt.loads_request(blob)
        eng = self.engine
        want = eng.handoff_fingerprint()
        if meta["fingerprint"] != want:
            raise snapfmt.SnapshotMismatch(
                "<handoff record>", "fingerprint",
                "record is from a replica with incompatible geometry",
                expected=want, got=meta["fingerprint"])
        extra = dict(meta.get("extra", {}))
        kind = record_rng_kind(extra, arrays)
        if float(extra.get("temperature", 0.0)) > 0.0 and kind != eng.rng_kind:
            raise snapfmt.SnapshotMismatch(
                "<handoff record>", "rng_kind",
                "a sampled stream cannot continue on another generator",
                expected=eng.rng_kind, got=kind)
        prompt = [int(x) for x in extra.get("prompt") or []]
        completion = [int(x) for x in extra.get("completion") or []]
        pos = int(meta["pos"])
        max_new = int(extra.get("max_new", 1))
        fed = int(extra.get("fed", 0))
        produced = int(extra.get("produced", len(completion)))
        if not prompt or max_new < 1 or not (0 <= pos <= eng.seq_len) \
                or not (0 <= fed <= len(prompt)) or produced < 0:
            raise snapfmt.SnapshotMismatch("<handoff record>", "extra",
                                           "inconsistent request state in hand-off record")
        page_arrays = self._page_arrays(arrays, pos)
        ps = self.pool.page_size
        n_data = -(-pos // ps)
        need = min(len(prompt) + max_new, eng.seq_len)
        n_total = -(-need // ps)
        if n_total > self.pool.capacity:
            raise ContextOverflow(f"request needs {n_total} KV pages but the pool has "
                                  f"{self.pool.capacity}")
        deadline = None
        if extra.get("deadline_left") is not None:
            deadline = time.monotonic() + float(extra["deadline_left"])
        with self._cond:
            if self._stop or self._draining:
                raise SchedulerClosed("scheduler is draining")
            slot_idx = next((i for i, s in enumerate(self.slots) if s.ticket is None), None)
            if slot_idx is None:
                raise SchedulerSaturated("no free slot for hand-off import")
            n_alloc = n_total
            if self.optimistic:
                n_alloc = max(n_data, -(-min(pos + self.spill_headroom, need) // ps))
            pages = self._alloc_ladder_locked(n_alloc, allow_spill=False)
            if pages is None:
                raise SchedulerSaturated("no free KV pages for hand-off import")
            others = any(s.ticket is not None for s in self.slots)
            with self._engine_lock:
                if n_data:
                    eng.write_pool_pages(pages[:n_data], page_arrays)
                if not others and not self._queue and kind == eng.rng_kind \
                        and "rng_state" in arrays:
                    eng.set_rng(arrays["rng_state"])
            t = Ticket(prompt, max_new, float(extra.get("temperature", 0.0)),
                       float(extra.get("top_p", 0.9)),
                       tuple(int(e) for e in extra.get("eos_ids") or ()), deadline,
                       priority=int(extra.get("priority", 1)),
                       top_k=int(extra.get("top_k", 0)))
            t.rid = str(extra.get("rid") or t.rid)
            # the exporter's fleet trace id: the resumed request's spans here
            # join the same trace
            if extra.get("trace_id"):
                obs_trace.set_trace(t.rid, str(extra["trace_id"]))
            t.stop = [str(x) for x in extra.get("stop") or []]
            t.emitted = list(completion)
            t.preempt_count = int(extra.get("preempt_count", 0))
            t.parked_ms = float(extra.get("parked_ms", 0.0))
            t.spill_ms = float(extra.get("spill_ms", 0.0))
            t._on_cancel = self._wake
            self._bind_resumed_locked(slot_idx, t, pages, pos=pos, fed=fed,
                                      produced=produced, last=int(extra.get("last", 0)),
                                      budget=n_total)
            self.stats["imported"] += 1
            obs_metrics.SCHED_SLOT_JOINS.inc(slot_idx)
            self._cond.notify_all()
        obs_flight.submit(t.rid, n_prompt=len(prompt), max_new=max_new,
                          temperature=t.temperature, source="handoff",
                          priority=PRIORITY_NAMES.get(t.priority, "standard"))
        obs_flight.admit(t.rid, slot=slot_idx, queued_ms=0.0, prefix_reused=0)
        obs_flight.phase(t.rid, "handoff", direction="import", slot=slot_idx, pos=pos)
        obs_events.emit("handoff", direction="import", rid=t.rid, slot=slot_idx, pos=pos,
                        produced=produced)
        return t, extra

    def _page_arrays(self, arrays: dict, pos: int) -> dict:
        """The record's page planes, checked against this pool: values
        always, scale planes iff the pool is int8, each (L, ceil(pos/ps),
        Hkv, ps, Dh | 1)."""
        n_data = -(-pos // self.pool.page_size)
        out = {}
        for n, (_, shape) in self.engine.kv_layout().items():
            name = f"pages.{n}"
            arr = arrays.get(name)
            want = (shape[0], n_data, *shape[2:])
            if arr is None or tuple(arr.shape) != want:
                raise snapfmt.SnapshotMismatch(
                    "<handoff record>", f"array {name!r}",
                    "page payload does not match the record position",
                    expected=str(want), got="missing" if arr is None else str(arr.shape))
            out[name] = arr
        return out

    def _bind_resumed_locked(self, slot_idx: int, t: Ticket, pages: list[int], *,
                             pos: int, fed: int, produced: int, last: int,
                             budget: int) -> None:
        """Bind a resumed request (imported or unparked) to ``slot_idx``
        with its written pages already in ``pages``: the clocks resume where
        the record stopped."""
        s = self.slots[slot_idx]
        s.ticket = t
        s.pages = list(pages)
        s.prefix_tokens = 0
        # prompt pages become shareable when prefill completes; a request
        # resumed past it never inserts (its pages' prefix is unknown here)
        s.inserted = fed >= len(t.prompt)
        s.budget = budget
        s.spilled = False
        s.active_at = time.monotonic()
        s.pos, s.fed, s.produced, s.last = pos, fed, produced, last
        t.slot = slot_idx
        row = self._page_tables[slot_idx]
        row[:] = 0
        row[:len(pages)] = pages
        obs_metrics.KV_PAGES_IN_USE.set(self.pool.in_use)

    # -- scheduler thread ----------------------------------------------
    def _retire(self, slot_idx: int, reason: str,
                error: BaseException | None = None) -> None:
        s = self.slots[slot_idx]
        t = s.ticket
        if t is None:
            return
        t.finish = reason
        t.error = error
        if self.pool is not None:
            # a spilled slot owns no pages; its host-pool record dies with
            # the request (dropped while the ticket is bound, so the time
            # lands on its spill_ms)
            self._drop_spilled_locked(slot_idx)
        s.ticket = None
        # flush point for speculation: pending drafts die with the slot and
        # the proposer forgets it (a later occupant rebuilds from its prompt)
        self._proposals.pop(slot_idx, None)
        if self.spec is not None:
            self.spec.reset(slot_idx)
        if self.pool is not None and s.pages:
            # drop this slot's references; pages the radix tree retained
            # stay live for the next matching prompt
            self.pool.decref(s.pages)
            s.pages = []
            self._page_tables[slot_idx][:] = 0
            obs_metrics.KV_PAGES_IN_USE.set(self.pool.in_use)
        obs_metrics.SCHED_SLOT_RETIRES.inc(slot_idx, reason)
        now = time.monotonic()
        obs_trace.record("sched_retire", now, now, rid=t.rid, slot=slot_idx,
                         reason=reason, produced=s.produced)
        # the log record factory stamps the contextvar: bind the ticket's ID
        # around the call (this thread serves many requests)
        ctx = request_id_var.set(t.rid)
        try:
            _log.info("slot retire", extra={"slot": slot_idx, "reason": reason,
                                            "produced": s.produced})
        finally:
            request_id_var.reset(ctx)
        obs_flight.retire(t.rid, reason, produced=s.produced, pos=s.pos,
                          error=repr(error) if error is not None else None,
                          preempt_count=t.preempt_count or None,
                          parked_ms=round(t.parked_ms, 3) if t.parked_ms else None,
                          spill_ms=round(t.spill_ms, 3) if t.spill_ms else None,
                          spec_proposed=t.spec_proposed or None,
                          spec_accepted=t.spec_accepted if t.spec_proposed else None)
        t._q.put(_DONE)

    def _fail_ticket(self, t: Ticket, reason: str,
                     error: BaseException | None = None) -> None:
        t.finish = reason
        t.error = error
        obs_flight.retire(t.rid, reason, produced=0,
                          error=repr(error) if error is not None else None)
        t._q.put(_DONE)

    def _bind_pages(self, slot_idx: int, t: Ticket) -> bool:
        """Paged admission: match the prompt against the radix tree, then
        reserve pages: under ``full`` every page the request can touch
        (matched prefix + fresh pages through ``min(len(prompt) + max_new,
        seq_len)``), under ``optimistic`` only through ``prompt +
        spill_headroom`` (the slot grows later, :meth:`_tier_round_locked`).
        Returns False, binding nothing, when the pool cannot supply them:
        the request stays queued.  Caller holds the lock."""
        pool = self.pool
        ps = pool.page_size
        prompt = t.prompt
        matched, shared = 0, []
        if self.prefix_cache is not None:
            matched, shared = self.prefix_cache.match(prompt)
            # leave >= 1 prompt token to feed: the forward over the suffix
            # is what samples the first token
            while matched >= len(prompt):
                matched -= ps
                shared = shared[:-1]
        # reference the shared pages BEFORE any allocation/eviction, so the
        # evictor cannot free a page this admission just matched
        pool.incref(shared)
        need_len = min(len(prompt) + t.max_new, self.engine.seq_len)
        reserve_len = min(len(prompt) + self.spill_headroom, need_len) \
            if self.optimistic else need_len
        fresh = -(-reserve_len // ps) - len(shared)
        new_pages = self._alloc_ladder_locked(fresh, allow_spill=False)
        if new_pages is None:
            pool.decref(shared)
            if not t._page_deferred:
                t._page_deferred = True
                self.stats["kv_pool_exhausted"] += 1
                obs_metrics.KV_POOL_EXHAUSTED.inc()
                _log.info("kv pool exhausted: need %d pages, %d free", fresh,
                          pool.available)
            return False
        s = self.slots[slot_idx]
        s.pages = list(shared) + new_pages
        s.prefix_tokens = matched
        s.inserted = False
        # the growth ceiling (under full: the pages bound now)
        s.budget = -(-need_len // ps)
        s.spilled = False
        # the page-table row: reserved pages first, scratch page 0 after
        row = self._page_tables[slot_idx]
        row[:] = 0
        row[:len(s.pages)] = s.pages
        if matched:
            self.stats["prefix_hits"] += 1
            self.stats["prefix_tokens_reused"] += matched
            obs_metrics.PREFIX_HITS.inc()
            obs_metrics.PREFIX_TOKENS_REUSED.inc(matched)
            obs_flight.phase(t.rid, "prefix_reuse", tokens=matched,
                             pages=len(shared))
        obs_metrics.KV_PAGES_IN_USE.set(pool.in_use)
        return True

    def _eff_level(self, t: Ticket, now: float) -> int:
        """The level after aging: a waiting ticket climbs one class per
        ``preempt_age_ms`` waited (<= 0: no aging)."""
        lvl = t.priority
        if self.preempt_age_ms > 0:
            lvl -= int((now - t.submitted_at) * 1e3 / self.preempt_age_ms)
        return lvl

    def _admit_locked(self, now: float) -> None:
        """Move waiting work into free slots in priority order (caller
        holds the lock).  Candidates are the queue and the parked area; the
        best effective level wins, parked before queued on a tie, then the
        earlier submission.  A candidate that finds no slot or pages may
        preempt a strictly lower-priority slot; otherwise admission stops
        for the round and the candidate keeps its place."""
        while True:
            best = None  # (sort key, kind, ticket, parked entry)
            for t in self._queue:
                k = (self._eff_level(t, now), 1, t.submitted_at)
                if best is None or k < best[0]:
                    best = (k, "queued", t, None)
            for e in self._parked:
                k = (self._eff_level(e.ticket, now), 0, e.ticket.submitted_at)
                if best is None or k < best[0]:
                    best = (k, "parked", e.ticket, e)
            if best is None:
                return
            _, kind, t, entry = best
            if t._cancel is not None or (t.deadline is not None and now >= t.deadline):
                if kind == "queued":
                    self._queue.remove(t)
                else:
                    self._drop_parked_locked(entry)
                self._fail_ticket(t, t._cancel or "timeout")
                continue
            free = next((i for i, s in enumerate(self.slots) if s.ticket is None), None)
            if free is None:
                if self._preempt_for_locked(t, now, "no_free_slot"):
                    continue
                return
            if kind == "parked":
                if self._unpark_locked(free, entry, now):
                    continue
                if self._preempt_for_locked(t, now, "pool_exhausted"):
                    continue
                return
            if self.pool is not None and not self._bind_pages(free, t):
                if self._preempt_for_locked(t, now, "pool_exhausted"):
                    continue
                return
            self._queue.remove(t)
            s = self.slots[free]
            s.ticket = t
            # a prefix hit's matched tokens are already in the cache
            # (shared pages): the clock starts past them
            s.pos = s.fed = s.prefix_tokens if self.pool is not None else 0
            s.produced = 0
            s.last = 0
            s.active_at = now
            t.slot = free
            queued_ms = round((now - t.submitted_at) * 1e3, 3)
            obs_metrics.SCHED_SLOT_JOINS.inc(free)
            obs_trace.record("sched_admit", t.submitted_at, now, rid=t.rid, slot=free,
                             queued_ms=queued_ms, n_prompt=len(t.prompt),
                             prefix_reused=s.pos,
                             priority=PRIORITY_NAMES.get(t.priority, t.priority))
            ctx = request_id_var.set(t.rid)
            try:
                _log.info("slot join", extra={"slot": free, "n_prompt": len(t.prompt),
                                              "queued_ms": queued_ms,
                                              "prefix_reused": s.pos})
            finally:
                request_id_var.reset(ctx)
            obs_flight.admit(t.rid, slot=free, queued_ms=queued_ms, prefix_reused=s.pos)
            obs_metrics.QUEUE_WAIT.observe(max(now - t.submitted_at, 0.0))

    # -- QoS preemption (export, park, resume) ---------------------------
    def _preempt_for_locked(self, t: Ticket, now: float, reason: str) -> bool:
        """Preempt the lowest-priority, longest-remaining slot so ``t`` can
        admit.  The raw levels decide (an aged ticket admits earlier but
        evicts nothing of its own class).  Admission runs between rounds,
        so no dispatch is in flight; ``_inflight_n`` is checked anyway.
        False when preemption is off, the scheduler is unpaged, or no slot
        holds a strictly lower priority."""
        if not self.preempt or self.pool is None or self._inflight_n:
            return False
        victims = [i for i, s in enumerate(self.slots)
                   if s.ticket is not None and s.ticket.priority > t.priority]
        if not victims:
            return False
        victim = max(victims, key=lambda i: (self.slots[i].ticket.priority,
                                             self.slots[i].ticket.max_new
                                             - self.slots[i].produced))
        self._preempt_locked(victim, reason, now)
        return True

    def _preempt_locked(self, slot_idx: int, reason: str, now: float) -> None:
        """Evict one slot through the DLREQ01 export: park the record (RAM,
        or ``spill_dir``), free its pages, keep the ticket live (its
        consumer sees a stall).  Past ``preempt_cap``, with the parked area
        full, or when the export fails, the victim retires ``preempted``
        with what it produced."""
        s = self.slots[slot_idx]
        t = s.ticket
        # flush point: pending drafts die before the export, so a record
        # never carries speculative state (the resumed slot re-drafts)
        self._proposals.pop(slot_idx, None)
        if self.spec is not None:
            self.spec.reset(slot_idx)
        obs_metrics.SCHED_PREEMPTIONS.inc(reason)
        self.stats["preemptions"] += 1
        obs_trace.record("sched_preempt", now, time.monotonic(), rid=t.rid, slot=slot_idx,
                         reason=reason, produced=s.produced,
                         priority=PRIORITY_NAMES.get(t.priority, t.priority))
        if t.preempt_count >= self.preempt_cap or len(self._parked) >= self.parked_max:
            self._retire(slot_idx, "preempted")
            return
        t0 = time.perf_counter()
        try:
            blob = self._export_slot_locked(slot_idx)
        except Exception as e:
            _log.error("preempt export of %s failed: %r", t.rid, e)
            self._retire(slot_idx, "preempted")
            return
        export_ms = (time.perf_counter() - t0) * 1e3
        path = None
        if self.spill_dir is not None:
            try:
                os.makedirs(self.spill_dir, exist_ok=True)
                path = os.path.join(self.spill_dir, f"{t.rid}.dlreq")
                with open(path, "wb") as f:
                    f.write(blob)
                blob = None
            except OSError as e:
                path = None  # keep the record in RAM
                _log.error("preempt spill of %s failed; record kept in RAM: %r", t.rid, e)
        t.preempt_count += 1
        self._parked.append(_Parked(t, blob, path, now))
        # a spilled victim parked from its host-pool copy: drop that copy
        # while the ticket is still bound
        self._drop_spilled_locked(slot_idx)
        s.ticket = None
        t.slot = None
        if s.pages:
            self.pool.decref(s.pages)
            s.pages = []
            self._page_tables[slot_idx][:] = 0
            obs_metrics.KV_PAGES_IN_USE.set(self.pool.in_use)
        obs_metrics.SCHED_PREEMPT_PARKED.set(len(self._parked))
        ctx = request_id_var.set(t.rid)
        try:
            _log.info("slot preempt", extra={"slot": slot_idx, "reason": reason,
                                             "produced": s.produced,
                                             "preempt_count": t.preempt_count})
        finally:
            request_id_var.reset(ctx)
        obs_flight.phase(t.rid, "preempted", slot=slot_idx, reason=reason,
                         produced=s.produced, preempt_count=t.preempt_count,
                         export_ms=export_ms, on_disk=path is not None)
        obs_events.emit("preempt", rid=t.rid, slot=slot_idx, reason=reason,
                        produced=s.produced, spilled=path is not None)

    def _unpark_locked(self, slot_idx: int, entry: _Parked, now: float) -> bool:
        """Resume a parked request in ``slot_idx`` on its original ticket:
        its pages are written back in place and its clocks resume, so a
        greedy stream goes on byte for byte.  True when the entry was used
        (resumed, or failed on an unreadable record), False when pages are
        short and it stays parked."""
        eng = self.engine
        t = entry.ticket
        try:
            blob = entry.blob
            if blob is None:
                with open(entry.path, "rb") as f:
                    blob = f.read()
            meta, arrays = snapfmt.loads_request(blob)
            pos = int(meta["pos"])
            page_arrays = self._page_arrays(arrays, pos)
        except Exception as e:
            _log.error("parked record of %s unreadable; it cannot resume: %r", t.rid, e)
            self._drop_parked_locked(entry)
            self._fail_ticket(t, "preempted")
            return True
        ps = self.pool.page_size
        n_data = -(-pos // ps)
        need = min(len(t.prompt) + t.max_new, eng.seq_len)
        n_total = -(-need // ps)
        n_alloc = n_total
        if self.optimistic:
            # the written pages plus headroom, as an optimistic admission
            n_alloc = max(n_data, -(-min(pos + self.spill_headroom, need) // ps))
        # the whole ladder: resuming may spill an idle neighbour
        pages = self._alloc_ladder_locked(n_alloc)
        if pages is None:
            return False
        extra = dict(meta.get("extra", {}))
        others = any(s.ticket is not None for s in self.slots)
        t0 = time.perf_counter()
        with self._engine_lock:
            if n_data:
                eng.write_pool_pages(pages[:n_data], page_arrays)
            if not others and not self._queue and "rng_state" in arrays:
                eng.set_rng(arrays["rng_state"])
        write_ms = (time.perf_counter() - t0) * 1e3
        fed = int(extra.get("fed", 0))
        self._bind_resumed_locked(slot_idx, t, pages, pos=pos, fed=fed,
                                  produced=int(extra.get("produced", len(t.emitted))),
                                  last=int(extra.get("last", 0)), budget=n_total)
        s = self.slots[slot_idx]
        s.active_at = now
        parked_ms = round((now - entry.parked_at) * 1e3, 3)
        t.parked_ms += parked_ms
        self._drop_parked_locked(entry)
        self.stats["resumed"] += 1
        obs_metrics.SCHED_SLOT_JOINS.inc(slot_idx)
        obs_trace.record("sched_resume", entry.parked_at, now, rid=t.rid, slot=slot_idx,
                         parked_ms=parked_ms, pos=pos,
                         priority=PRIORITY_NAMES.get(t.priority, t.priority))
        ctx = request_id_var.set(t.rid)
        try:
            _log.info("slot resume", extra={"slot": slot_idx, "pos": pos,
                                            "produced": s.produced, "parked_ms": parked_ms})
        finally:
            request_id_var.reset(ctx)
        obs_flight.phase(t.rid, "resumed", slot=slot_idx, parked_ms=parked_ms, pos=pos,
                         write_ms=write_ms)
        obs_events.emit("resume", rid=t.rid, slot=slot_idx, parked_ms=parked_ms, pos=pos)
        return True

    def _drop_parked_locked(self, entry: _Parked) -> None:
        with contextlib.suppress(ValueError):
            self._parked.remove(entry)
        if entry.path is not None:
            with contextlib.suppress(OSError):
                os.remove(entry.path)
        obs_metrics.SCHED_PREEMPT_PARKED.set(len(self._parked))

    def _sweep_parked_locked(self, now: float) -> None:
        for e in list(self._parked):
            t = e.ticket
            if t._cancel is not None:
                self._drop_parked_locked(e)
                self._fail_ticket(t, t._cancel)
            elif t.deadline is not None and now >= t.deadline:
                self._drop_parked_locked(e)
                self._fail_ticket(t, "timeout")

    # -- KV tiering (optimistic growth, spill, page-in) ------------------
    def _spill_key(self, slot_idx: int):
        """The host-pool key of a slot's spill record: (slot, request id),
        so a slot bound to a new ticket never meets its predecessor's."""
        return (slot_idx, self.slots[slot_idx].ticket.rid)

    def _drop_spilled_locked(self, slot_idx: int) -> None:
        """Forget a slot's spill record (retire, park), charging the
        spilled time to its ticket; a no-op without one."""
        rec = self._spilled.pop(slot_idx, None)
        if rec is None:
            return
        s = self.slots[slot_idx]
        if s.ticket is not None:
            s.ticket.spill_ms += (time.monotonic() - rec["since"]) * 1e3
        self.host_pool.drop(rec["key"])
        s.spilled = False

    def _spill_slot_locked(self, slot_idx: int) -> bool:
        """Move one slot's pages to the host pool (caller holds ``_cond``,
        zero dispatches in flight): the engine gathers them on its stream
        and copies them into pinned memory on a side stream; only after that
        copy has landed (``wait()``) and the host pool took the record are
        the pages freed.  A refused spill leaves the slot resident."""
        s = self.slots[slot_idx]
        t = s.ticket
        n = len(s.pages)
        if not n or not self.host_pool.would_fit(n * self._page_nbytes):
            return False
        try:
            FAULTS.fire("kv.spill")
        except Exception as e:  # noqa: BLE001 — an injected failed drain
            # the spill is abandoned and the ladder falls back (to
            # preemption): honest queueing, never wrong bytes
            _log.warning("kv spill of slot %d aborted: %r", slot_idx, e)
            return False
        t0 = time.perf_counter()
        with self._engine_lock:
            handles = self.engine.read_pool_pages_async(s.pages)
        arrays = {k: h.wait() for k, h in handles.items()}
        ms = (time.perf_counter() - t0) * 1e3
        key = self._spill_key(slot_idx)
        if not self.host_pool.put(key, arrays, {"pos": s.pos}):
            return False
        self.pool.decref(s.pages)
        s.pages = []
        s.spilled = True
        self._page_tables[slot_idx][:] = 0
        self._spilled[slot_idx] = {"key": key, "since": time.monotonic(), "n_pages": n}
        self.stats["pages_spilled"] += n
        obs_metrics.KV_PAGES_SPILLED.inc(n)
        obs_metrics.KV_SPILL_BYTES.inc(kvtier.arrays_nbytes(arrays))
        obs_metrics.KV_PAGES_IN_USE.set(self.pool.in_use)
        ctx = request_id_var.set(t.rid)
        try:
            _log.info("kv spill", extra={"slot": slot_idx, "pages": n, "pos": s.pos})
        finally:
            request_id_var.reset(ctx)
        obs_flight.phase(t.rid, "kv_spill", slot=slot_idx, pages=n, ms=ms)
        return True

    def _spill_one_locked(self, exclude: int | None = None) -> bool:
        """Spill the best victim among the live resident slots
        (:func:`kvtier.rank_victims`), never ``exclude`` (the slot being
        grown)."""
        cands = [(i, self.slots[i].active_at) for i in self._active()
                 if i != exclude and not self.slots[i].spilled and self.slots[i].pages]
        for idx in kvtier.rank_victims(cands):
            if self._spill_slot_locked(idx):
                return True
        return False

    def _alloc_ladder_locked(self, n: int, exclude: int | None = None,
                             allow_spill: bool = True):
        """``n`` pages through the reclaim ladder: the free list, radix
        eviction (cold shared prefixes), then spills of idle slots.  None
        when it cannot; the caller picks the fallback.  The first two rungs
        free only pages no slot row references, so they are safe under an
        in-flight dispatch; a spill reads the pool and is for round
        boundaries only (``allow_spill=False`` otherwise)."""
        if n <= 0:
            return []
        pool = self.pool
        try:
            return pool.alloc(n)
        except PagePoolExhausted:
            pass
        if self.prefix_cache is not None:
            self.prefix_cache.evict(n - pool.available)
            try:
                return pool.alloc(n)
            except PagePoolExhausted:
                pass
        if allow_spill:
            while pool.available < n:
                if not self._spill_one_locked(exclude):
                    return None
            try:
                return pool.alloc(n)
            except PagePoolExhausted:  # pragma: no cover - defensive
                return None
        return None

    def _grow_slot_locked(self, slot_idx: int, target_pos: int,
                          allow_spill: bool = True) -> bool:
        """Make ``slot_idx`` own every page a write of positions ``[0,
        target_pos)`` touches (clamped to its budget).  Growth lands before
        the dispatch that writes there: an unbound table entry is scratch
        page 0, which would swallow the write."""
        s = self.slots[slot_idx]
        need = min(-(-int(target_pos) // self.pool.page_size), s.budget)
        extra = need - len(s.pages)
        if extra <= 0:
            return True
        pages = self._alloc_ladder_locked(extra, exclude=slot_idx, allow_spill=allow_spill)
        if pages is None:
            return False
        s.pages.extend(pages)
        self._page_tables[slot_idx][:len(s.pages)] = s.pages
        obs_metrics.KV_PAGES_IN_USE.set(self.pool.in_use)
        return True

    def _try_page_in_locked(self) -> None:
        """Bring spilled slots back, the longest-stalled first, before any
        admission (their consumers are waiting).  No spill rung here:
        paging one slot in by spilling another would ping-pong."""
        order = sorted(self._spilled.items(), key=lambda kv: (kv[1]["since"], kv[0]))
        for slot_idx, rec in order:
            s = self.slots[slot_idx]
            pages = self._alloc_ladder_locked(rec["n_pages"], allow_spill=False)
            if pages is None:
                return
            got = self.host_pool.pop(rec["key"])
            if got is None:  # pragma: no cover - defensive
                self._spilled.pop(slot_idx, None)
                s.spilled = False
                self.pool.decref(pages)
                continue
            arrays, _ = got
            t0 = time.perf_counter()
            with self._engine_lock:
                self.engine.write_pool_pages(pages, arrays)
            ms = (time.perf_counter() - t0) * 1e3
            s.pages = list(pages)
            s.spilled = False
            row = self._page_tables[slot_idx]
            row[:] = 0
            row[:len(pages)] = pages
            t = s.ticket
            stalled_ms = (time.monotonic() - rec["since"]) * 1e3
            t.spill_ms += stalled_ms
            self._spilled.pop(slot_idx, None)
            self.stats["pages_paged_in"] += len(pages)
            obs_metrics.KV_PAGES_PAGED_IN.inc(len(pages))
            obs_metrics.KV_PAGES_IN_USE.set(self.pool.in_use)
            ctx = request_id_var.set(t.rid)
            try:
                _log.info("kv page-in", extra={"slot": slot_idx, "pages": len(pages),
                                               "stalled_ms": round(stalled_ms, 3)})
            finally:
                request_id_var.reset(ctx)
            obs_flight.phase(t.rid, "kv_pagein", slot=slot_idx, pages=len(pages), ms=ms,
                             stalled_ms=stalled_ms)

    def _tier_round_locked(self, now: float) -> None:
        """Between rounds (``_cond`` held, zero in flight): grow every live
        resident slot to cover the widest write the next dispatch can make;
        a slot the ladder cannot grow is preempted (``kv_pressure``)."""
        if not self.optimistic:
            return
        reach = max(self.prefill_chunk, self.decode_burst,
                    (self.spec_k + 1) if self.spec is not None else 1)
        for i in self._active():
            s = self.slots[i]
            if s.spilled:
                continue
            target = min(s.pos + reach, int(self.engine.seq_len))
            if not self._grow_slot_locked(i, target, allow_spill=True):
                self._preempt_locked(i, "kv_pressure", now)

    def _active(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s.ticket is not None]

    def _run(self) -> None:
        try:
            while True:
                with self._cond:
                    now = time.monotonic()
                    # honor cancels/deadlines first so their slots free up
                    for i in self._active():
                        t = self.slots[i].ticket
                        if t._cancel is not None:
                            self._retire(i, t._cancel)
                        elif t.deadline is not None and now >= t.deadline:
                            self._retire(i, "timeout")
                    for t in [q for q in self._queue
                              if q._cancel is not None
                              or (q.deadline is not None and now >= q.deadline)]:
                        self._queue.remove(t)
                        self._fail_ticket(t, t._cancel or "timeout")
                    self._sweep_parked_locked(now)
                    if self._spilled:
                        # spilled slots hold live tickets whose consumers
                        # wait: freed pages go to them before admissions
                        self._try_page_in_locked()
                    if not self._paused:
                        self._admit_locked(now)
                    self._tier_round_locked(now)
                    real_active = self._active()
                    # a spilled slot holds a ticket but no pages: it sits
                    # out the dispatch (its table row is all scratch) until
                    # it pages back in
                    active = [i for i in real_active if not self.slots[i].spilled]
                    queued = len(self._queue)
                    obs_metrics.SCHED_SLOTS_OCCUPIED.set(len(active))
                    obs_metrics.SCHED_QUEUE_DEPTH.set(queued)
                    if self._stop:
                        return
                    if not active:
                        if self._paused and not real_active:
                            self._idle.set()
                        # submissions, cancels and close notify at once; the
                        # timeout only has to cover the earliest queued or
                        # parked deadline (a paused scheduler holds its queue)
                        timeout = 0.5
                        dls = [t.deadline for t in self._queue if t.deadline is not None]
                        dls += [e.ticket.deadline for e in self._parked
                                if e.ticket.deadline is not None]
                        if dls:
                            timeout = min(timeout, max(min(dls) - now, 0.0))
                        w0 = time.perf_counter()
                        self._cond.wait(timeout)
                        self._idle_accum += time.perf_counter() - w0
                        continue
                self._dispatch(active, queued)
        except BaseException:  # the loop must not die silently
            _log.exception("scheduler loop failed")
            raise
        finally:
            with self._cond:
                for i in self._active():
                    self._retire(i, "aborted")
                while self._queue:
                    self._fail_ticket(self._queue.popleft(), "aborted")
                for e in list(self._parked):
                    self._drop_parked_locked(e)
                    self._fail_ticket(e.ticket, "aborted")
                self._idle.set()

    def _dispatch(self, active: list[int], queued: int) -> None:
        """Run one dispatch round — and, with ``overlap`` on, keep a second
        dispatch enqueued on the device while the first one's tokens land
        and fan out (a two-deep pipeline).  INVARIANT: zero dispatches are
        in flight when this returns, so admission, ``exclusive()`` and
        drain all happen at a plain step boundary."""
        cur = self._enqueue_first(active, queued)
        while True:
            nxt = None
            if cur.error is None and self.overlap:
                nxt = self._maybe_pipeline(cur)
            ok = self._land_and_fanout(cur)
            if not ok or nxt is None:
                if nxt is not None:
                    self._abandon(nxt)
                return
            if self._pipeline_verdict(nxt) is None:
                self._abandon(nxt)
                return
            cur = nxt

    def _enqueue_first(self, active: list[int], queued: int) -> _Pending:
        """Build and enqueue the round's dispatch without blocking on the
        device."""
        eng = self.engine
        b = eng.batch
        slots = self.slots
        prefilling = [i for i in active
                      if slots[i].fed < len(slots[i].ticket.prompt)]
        room = min(eng.seq_len - slots[i].pos for i in active)
        # the slots' pending drafts (runtime/spec.py) are valid for exactly
        # this dispatch: popped unconditionally, kept only for the slot's
        # current ticket, and dropped whole when a prefilling row joins (a
        # mixed step has no verify shape) or the context edge is closer
        # than a full window (the proposer re-drafts from exact state)
        props: dict[int, list[int]] = {}
        if self.spec is not None:
            with self._cond:
                pend, self._proposals = self._proposals, {}
            if not prefilling and room >= self.spec_k + 1:
                for i, (tk, d) in pend.items():
                    if i in active and slots[i].ticket is tk and d:
                        props[i] = d
        # both dispatch dimensions are rounded down to a power of two: a
        # few distinct shapes, each reused (the JAX package compiles one
        # program per shape; here it keeps step times comparable)
        if props:
            # a ragged verify step of fixed width spec_k + 1 (one graph):
            # proposing rows feed [last, d_1..], the others ride as one
            # plain decode step (n_valid 1)
            t_width = self.spec_k + 1
            steps = 1
        elif prefilling:
            # mixed step: prefill chunks ride with the decode rows' single
            # tokens; steps=1 keeps every row's clock advancing by n_valid
            t_width = min(self.prefill_chunk, room,
                          max(len(slots[i].ticket.prompt) - slots[i].fed
                              for i in prefilling))
            t_width = 1 << (t_width.bit_length() - 1)
            steps = 1
        else:
            # pure decode: burst on the device, clamped so no row outruns
            # the context edge and queued work waits ~max_wait_ms at most;
            # a row that hits its budget mid-burst retires and the fanout
            # discards its overrun
            t_width = 1
            steps = min(self.decode_burst, room)
            if queued and self._step_ms_ema:
                steps = min(steps, max(1, int(self.max_wait_ms / self._step_ms_ema)))
            steps = max(1, steps)
            steps = 1 << (steps.bit_length() - 1)

        tokens = np.zeros((b, t_width), np.int32)
        n_valid = np.ones((b,), np.int32)
        pos_rows = np.zeros((b,), np.int32)
        temps = np.zeros((b,), np.float32)
        topps = np.full((b,), 0.9, np.float32)
        topks = np.zeros((b,), np.int32)
        for i in active:
            s = slots[i]
            pos_rows[i] = s.pos
            temps[i] = s.ticket.temperature
            topps[i] = s.ticket.top_p
            topks[i] = s.ticket.top_k
            if s.fed < len(s.ticket.prompt):
                c = min(t_width, len(s.ticket.prompt) - s.fed)
                tokens[i, :c] = s.ticket.prompt[s.fed:s.fed + c]
                n_valid[i] = c
            else:
                tokens[i, 0] = s.last
                d = props.get(i)
                if d is not None:
                    tokens[i, 1:1 + len(d)] = d
                    n_valid[i] = 1 + len(d)
        obs_metrics.SCHED_BATCH_EFFICIENCY.set(len(active) / b)
        tickets = {i: slots[i].ticket for i in active}
        # the gap since the last land: idle (slept waiting for work), the
        # rest host_gap (fanout, admission, array prep)
        tp0 = time.perf_counter()
        host_gap_ms = idle_ms = 0.0
        if self._last_land is not None:
            gap_ms = max(tp0 - self._last_land, 0.0) * 1e3
            idle_ms = min(self._idle_accum * 1e3, gap_ms)
            host_gap_ms = gap_ms - idle_ms
            self._account("idle", idle_ms)
            self._account("host_gap", host_gap_ms)
            obs_metrics.SCHED_HOST_GAP_MS.observe(host_gap_ms)
        self._idle_accum = 0.0
        t0_mono = time.monotonic()
        ptab = None
        if self.paged:
            # only the riders' rows: a row bound under us (a hand-off
            # import on another thread) must not take this dispatch's
            # idle-row writes, which a zero row sends to scratch page 0
            ptab = np.zeros_like(self._page_tables)
            with self._cond:
                ptab[active] = self._page_tables[active]
        handle, error = None, None
        try:
            with self._engine_lock:
                if props:
                    handle = eng.slot_verify_async(
                        tokens, pos_rows, n_valid, temps_np=temps, topps_np=topps,
                        topks_np=topks, page_tables_np=ptab)
                else:
                    handle = eng.slot_step_async(
                        tokens, pos_rows, n_valid, temps_np=temps, topps_np=topps,
                        topks_np=topks, steps=steps, page_tables_np=ptab)
        except Exception as e:
            error = e
        if handle is not None:
            self._depth += 1
            obs_metrics.SCHED_INFLIGHT_DEPTH.set(self._depth)
        return _Pending(handle=handle, error=error, active=list(active),
                        tickets=tickets, steps=steps, n_valid=n_valid, temps=temps,
                        topps=topps, topks=topks, prefset=set(prefilling),
                        enq_tp=tp0, overlapped=False, t_width=t_width,
                        pos_rows=pos_rows, queued=queued, t0_mono=t0_mono,
                        host_gap_ms=host_gap_ms, idle_ms=idle_ms, verify=bool(props),
                        proposed_by_slot={i: len(d) for i, d in props.items()})

    def _maybe_pipeline(self, cur: _Pending) -> _Pending | None:
        """While ``cur`` is still in flight, enqueue the next pure-decode
        dispatch fed by ``cur``'s on-device last-token row.  Returns None
        at any pipeline flush point — queued admission pending, drain /
        pause / flush request / close, cancel or expired deadline, a row
        still mid-prefill after ``cur``, no context room, every row's
        budget spent by ``cur`` — and the round then completes
        synchronously."""
        if self.spec is not None:
            # token speculation supersedes dispatch pipelining: a verify
            # window's drafts depend on the previous dispatch's landed
            # tokens, so the next dispatch cannot be built while ``cur`` is
            # in flight; the verify step's multi-token yield amortizes the
            # host gap instead
            return None
        eng = self.engine
        slots = self.slots
        b = eng.batch
        with self._cond:
            if (self._stop or self._draining or self._paused
                    or self._flush_req or self._queue or self._parked):
                return None
            now = time.monotonic()
            pos2 = np.zeros((b,), np.int32)
            budget = 0
            for j in range(b):
                s = slots[j]
                t = s.ticket
                if j not in cur.tickets:
                    if t is not None:
                        return None   # a slot bound under us
                    continue
                if t is None or t is not cur.tickets[j]:
                    return None       # slot re-bound under us
                if t._cancel is not None or (t.deadline is not None
                                             and now >= t.deadline):
                    return None
                nv = int(cur.n_valid[j])
                if s.fed < len(t.prompt) and s.fed + nv < len(t.prompt):
                    return None       # still mid-prefill after cur
                pos2[j] = s.pos + nv + (cur.steps - 1)
                made = 1 if j in cur.prefset else cur.steps
                budget = max(budget, t.max_new - (s.produced + made))
            if budget < 1:
                # every row hits its token budget during ``cur``: the
                # pipelined dispatch knows its predecessor's yield up
                # front, so the all-overrun burst is avoidable waste
                return None
            room = min(int(eng.seq_len) - int(pos2[i]) for i in cur.active)
            if room < 1:
                return None
            # sized exactly like the sync burst, so the overlap on/off A/B
            # compares dispatch pipelining alone
            steps2 = max(1, min(self.decode_burst, room))
            steps2 = 1 << (steps2.bit_length() - 1)
            if self.optimistic:
                # a pipelined chain runs on past the round's growth: each
                # burst grows its rows here.  No spill: a page read would
                # queue behind the dispatch in flight; radix eviction frees
                # only pages no row references
                for j in cur.active:
                    if not self._grow_slot_locked(j, int(pos2[j]) + steps2,
                                                  allow_spill=False):
                        return None
            # the import path rewrites _page_tables under _cond: the
            # enqueue below (outside the lock) reads a frozen copy
            ptab = self._page_tables.copy() if self.paged else None
            # reserve the in-flight count before releasing the lock so a
            # concurrent _flushed() waiter sees this dispatch coming
            self._inflight_n += 1
        handle, err = None, None
        try:
            with self._engine_lock:
                handle = eng.slot_step_async(
                    None, pos2, np.ones((b,), np.int32), temps_np=cur.temps,
                    topps_np=cur.topps, topks_np=cur.topks, steps=steps2,
                    page_tables_np=ptab, feed_dev=cur.handle.last_dev)
        except Exception as e:
            err = e
        if err is not None:
            with self._cond:
                self._inflight_n -= 1
                self._cond.notify_all()
            _log.error("pipelined enqueue failed; round completes synchronously: %r", err)
            return None
        self._depth += 1
        obs_metrics.SCHED_INFLIGHT_DEPTH.set(self._depth)
        return _Pending(handle=handle, error=None, active=list(cur.active),
                        tickets=dict(cur.tickets), steps=steps2,
                        n_valid=np.ones((b,), np.int32), temps=cur.temps,
                        topps=cur.topps, topks=cur.topks, prefset=set(),
                        enq_tp=time.perf_counter(), overlapped=True, t_width=1,
                        pos_rows=pos2, queued=0, t0_mono=time.monotonic(),
                        host_gap_ms=0.0, idle_ms=0.0, verify=False, proposed_by_slot={})

    def _pipeline_verdict(self, nxt: _Pending) -> list[int] | None:
        """After ``nxt``'s predecessor landed and fanned out with ``nxt``
        still in flight: decide whether ``nxt``'s tokens may be emitted.
        Returns the surviving slot list, or None for a hard flush (``nxt``
        must be discarded).  A slot that merely retired in the
        predecessor's fanout (EOS / budget) survives row-wise removal —
        the burst computed its row for nothing, which is cheaper than
        flushing the whole pipeline."""
        slots = self.slots
        with self._cond:
            if (self._stop or self._draining or self._paused
                    or self._flush_req or self._queue or self._parked):
                return None
            now = time.monotonic()
            survivors = []
            for j in range(len(slots)):
                s = slots[j]
                if j not in nxt.tickets:
                    if s.ticket is not None:
                        return None   # a slot bound mid-pipeline
                    continue
                t = s.ticket
                if t is None:
                    continue          # retired by the predecessor's fanout
                if t is not nxt.tickets[j]:
                    return None       # slot re-bound
                if t._cancel is not None or (t.deadline is not None
                                             and now >= t.deadline):
                    return None       # honor the step boundary, like sync
                survivors.append(j)
            if not survivors:
                return None
            nxt.active = survivors
            nxt.tickets = {j: nxt.tickets[j] for j in survivors}
            return survivors

    def _abandon(self, nxt: _Pending) -> None:
        """Land and discard an in-flight pipelined dispatch at a flush
        point.  No slot clock ever advanced for it and its tokens are never
        emitted, so greedy output is byte-identical to never having
        pipelined: its KV writes all sit above every surviving row's
        position — masked by the causal ceiling and rewritten identically
        by the synchronous redo dispatch, exactly like slot reuse.  The
        sampler draws it consumed are not given back: sampled draws depend
        on co-scheduling by contract (module docstring); greedy rows never
        draw."""
        try:
            nxt.handle.wait()
        except Exception as e:
            # the discarded dispatch owns its own failure: nothing was
            # emitted from it; the next live dispatch re-probes the device
            _log.error("discarded in-flight dispatch failed: %r", e)
        tp1 = time.perf_counter()
        prev_end, self._last_land = self._last_land, tp1
        self.stats["dispatches"] += 1
        self.stats["overlapped"] += 1
        self.stats["discarded"] += 1
        self._note_dispatch()
        with self._cond:
            self._inflight_n -= 1
            self._cond.notify_all()
        wall_ms = max(tp1 - prev_end, 0.0) * 1e3
        self._account("pad", wall_ms)  # burned device capacity, not goodput
        obs_metrics.SCHED_OVERLAP_DISCARDS.inc()
        obs_flight.TIMELINE.record_step(
            ts=prev_end, wall_ms=wall_ms, steps=nxt.steps, t_width=1,
            overlapped=True, discarded=True, slots=self._slot_entries({}, set(), {}))

    def _land_and_fanout(self, cur: _Pending) -> bool:
        """Block until ``cur``'s tokens land and fan them out to their
        tickets.  Returns False when the dispatch failed: every active
        slot retires with the error (stale cache garbage sits above future
        occupants' ceilings) and the loop keeps serving."""
        b = self.engine.batch
        tw = time.perf_counter()
        error, out = cur.error, None
        if error is None:
            try:
                out = cur.handle.wait()
            except Exception as e:
                error = e
        tp1 = time.perf_counter()
        prev_end, self._last_land = self._last_land, tp1
        self.stats["dispatches"] += 1
        if cur.overlapped:
            self.stats["overlapped"] += 1
            with self._cond:
                self._inflight_n -= 1
                self._cond.notify_all()
        if cur.handle is not None:
            self._note_dispatch()
        hidden_ms = 0.0
        step_ms = None  # the burst clamp's wall, where the split below differs
        if cur.overlapped:
            # the burst clamp reads the whole span since the previous land
            step_ms = (tp1 - max(cur.enq_tp, prev_end)) * 1e3
            # a pipelined dispatch owns the wall from its predecessor's land
            # on.  The host's share before wait() is hidden when the land
            # still had to wait (the device was busy under it), else exposed
            host_ms = max(tw - prev_end, 0.0) * 1e3
            wait_ms = max(tp1 - tw, 0.0) * 1e3
            if wait_ms >= 0.1:
                hidden_ms, exposed_ms, wall_ms = host_ms, 0.0, host_ms + wait_ms
            else:
                exposed_ms, wall_ms = host_ms, wait_ms
            if exposed_ms:
                self._account("host_gap", exposed_ms)
                obs_metrics.SCHED_HOST_GAP_MS.observe(exposed_ms)
            if hidden_ms:
                obs_metrics.SCHED_HOST_GAP_HIDDEN_MS.inc(hidden_ms)
            ts0, gap_exposed, gap_idle = prev_end, exposed_ms, 0.0
        else:
            wall_ms = (tp1 - cur.enq_tp) * 1e3
            ts0, gap_exposed, gap_idle = cur.enq_tp, cur.host_gap_ms, cur.idle_ms
        # every row rode the same step: a row's share of the wall is 1/b
        n_pref, n_act = len(cur.prefset), len(cur.active)
        self._account("prefill", wall_ms * n_pref / b)
        self._account("decode", wall_ms * (n_act - n_pref) / b)
        self._account("pad", wall_ms * (b - n_act) / b)
        total = sum(self._comp.values())
        if total > 0:
            obs_metrics.SCHED_GOODPUT_RATIO.set(
                (self._comp["prefill"] + self._comp["decode"]) / total)
        rids = {i: cur.tickets[i].rid for i in cur.active}
        if error is not None:
            _log.error("slot dispatch failed: %r", error)
            obs_flight.TIMELINE.record_step(
                ts=ts0, wall_ms=wall_ms, host_gap_ms=gap_exposed, idle_ms=gap_idle,
                steps=cur.steps, t_width=cur.t_width, error=True,
                overlapped=cur.overlapped, hidden_host_ms=hidden_ms,
                slots=self._slot_entries(rids, cur.prefset, {}))
            with self._cond:
                for i in self._active():
                    self._retire(i, "error", error=error)
            return False
        self._note_step_time(wall_ms if step_ms is None else step_ms, cur.steps)
        if cur.verify:
            preds, accepted = out
            self.stats["verify_dispatches"] += 1
            obs_trace.record("sched_verify", cur.t0_mono, time.monotonic(), active=n_act,
                             queued=cur.queued, t=cur.t_width,
                             proposed=sum(cur.proposed_by_slot.values()),
                             accepted=sum(int(accepted[i]) for i in cur.proposed_by_slot),
                             rids=sorted(rids.values()))
        else:
            obs_trace.record("sched_step", cur.t0_mono, time.monotonic(), active=n_act,
                             queued=cur.queued, t=cur.t_width, steps=cur.steps,
                             overlapped=cur.overlapped, rids=sorted(rids.values()))
        FAULTS.fire("sched.host_fanout")
        emitted = dict.fromkeys(cur.active, 0)
        # the fanout holds _cond: slot clocks and tickets are never seen
        # half-advanced from another thread
        with self._cond:
            if cur.verify:
                self._fanout_verify(cur.active, preds, accepted, cur.proposed_by_slot,
                                    emitted)
            else:
                self._fanout(cur.active, cur.steps, out, cur.n_valid, emitted)
        # flight phases after the fanout, so the emitted counts are final
        for i in cur.active:
            if i in cur.prefset:
                obs_flight.phase(rids[i], "prefill_chunk", tokens=int(cur.n_valid[i]),
                                 ms=wall_ms, pos=int(cur.pos_rows[i]), emitted=emitted[i])
            elif cur.verify:
                obs_flight.phase(rids[i], "verify_burst",
                                 proposed=cur.proposed_by_slot.get(i, 0),
                                 accepted=int(accepted[i]), tokens=emitted[i],
                                 wall_ms=wall_ms)
            else:
                obs_flight.phase(rids[i], "decode_burst", steps=cur.steps,
                                 tokens=emitted[i], wall_ms=wall_ms,
                                 step_ms=wall_ms / cur.steps)
        self._attribute_cost(cur, wall_ms)
        obs_flight.TIMELINE.record_step(
            ts=ts0, wall_ms=wall_ms, device_ms=self.engine.last_slot_dispatch_ms,
            host_gap_ms=gap_exposed, idle_ms=gap_idle, steps=cur.steps,
            t_width=cur.t_width, overlapped=cur.overlapped, hidden_host_ms=hidden_ms,
            slots=self._slot_entries(rids, cur.prefset, emitted))
        if self.spec is not None:
            self._collect_proposals()
        return True

    def _attribute_cost(self, cur: _Pending, wall_ms: float) -> None:
        """Analytic roofline attribution of one landed dispatch
        (``obs/cost.py``): the ``dispatch_flops``/``dispatch_bytes``
        families by (codec, path, phase), a cost block on every riding
        request's flight record, per-class chip time and the MFU/MBU
        gauges.  A row's chip-time share is ``wall_ms / batch`` (pad rows'
        share is nobody's); FLOPs and bytes use each row's own useful
        tokens, the pass's weight read split evenly over the occupied
        rows."""
        cm = self.cost_model
        if cm is None or not cur.active:
            return
        rows = []
        for i in cur.active:
            if i in cur.prefset:
                rows.append(("prefill", int(cur.pos_rows[i]), int(cur.n_valid[i])))
            elif cur.verify and cur.proposed_by_slot.get(i):
                rows.append(("verify", int(cur.pos_rows[i]), int(cur.n_valid[i])))
            else:
                # plain decode rows advance cur.steps tokens (1 inside a
                # mixed or verify dispatch)
                rows.append(("decode", int(cur.pos_rows[i]), int(cur.steps)))
        out = cm.dispatch_cost(rows, steps=cur.steps)
        obs_dispatch.record_cost(out["entries"])
        obs_cost.TRACKER.note(out["flops"], out["hbm_bytes"], wall_ms)
        mfu, mbu = obs_cost.TRACKER.mfu(), obs_cost.TRACKER.mbu()
        if mfu is not None:
            obs_metrics.MFU.set(mfu)
        if mbu is not None:
            obs_metrics.MBU.set(mbu)
        chip_ms = wall_ms / self.engine.batch
        for i, rc in zip(cur.active, out["per_row"]):
            pages = len(self.slots[i].pages) if self.paged else 0
            t = cur.tickets[i]
            obs_flight.cost(t.rid, chip_ms=chip_ms, flops=rc["flops"],
                            hbm_bytes=rc["hbm_bytes"], kv_page_ms=pages * wall_ms)
            obs_metrics.CLASS_CHIP_MS.inc(PRIORITY_NAMES.get(t.priority, "standard"),
                                          n=chip_ms)

    def _fanout_verify(self, active: list[int], preds, accepted,
                       proposed_by_slot: dict[int, int], emitted: dict[int, int]) -> None:
        """Distribute one verify dispatch's tokens and advance the slot
        clocks: row ``i`` emits ``preds[i, :accepted[i] + 1]``, every token
        the model's own argmax, so the stream is plain decode's byte for
        byte.  A rejection truncates that row alone (its clock advances by
        its own accepted count; the rejected tail's KV sits above it).
        EOS or the budget mid-window retires the row and drops the rest of
        its window.  Caller holds ``self._cond``."""
        eng = self.engine
        slots = self.slots
        now = time.monotonic()
        for i in active:
            s = slots[i]
            s.active_at = now
            t = s.ticket
            if t is None:  # retired between enqueue and land
                continue
            a = int(accepted[i])
            k = proposed_by_slot.get(i, 0)
            if k:
                t.spec_proposed += k
                t.spec_accepted += a
                self.stats["spec_proposed"] += k
                self.stats["spec_accepted"] += a
                obs_metrics.SCHED_SPEC_PROPOSED.inc(k)
                if a:
                    obs_metrics.SCHED_SPEC_ACCEPTED.inc(self.spec.name, n=a)
            for tok in (int(preds[i, j]) for j in range(a + 1)):
                s.pos += 1
                s.last = tok
                if tok in t.eos_ids:
                    self._retire(i, "stop")
                    break
                if t.first_token_at is None:
                    t.first_token_at = time.monotonic()
                s.produced += 1
                emitted[i] += 1
                t.emitted.append(tok)
                t._q.put(tok)
                if s.produced >= t.max_new or s.pos >= eng.seq_len:
                    self._retire(i, "length")
                    break
        if self.stats["spec_proposed"]:
            obs_metrics.SCHED_SPEC_ACCEPT_RATIO.set(
                self.stats["spec_accepted"] / self.stats["spec_proposed"])

    def _collect_proposals(self) -> None:
        """After a dispatch fans out: let each live, greedy, decoding slot
        draft up to ``spec_k`` tokens for the next dispatch.  The proposer
        runs outside ``_cond`` (a draft-model proposer runs its own
        engine), so the drafts are stored only for the ticket they were
        drafted for."""
        spec = self.spec
        eng = self.engine
        slots = self.slots
        want: dict[int, int] = {}
        tick: dict[int, Ticket] = {}
        with self._cond:
            if (self._stop or self._draining or self._paused
                    or self._flush_req or self._queue or self._parked):
                # a flush point (or an admission, which makes the next
                # dispatch a mixed step) is coming: drafts would be dropped
                return
            now = time.monotonic()
            for i in self._active():
                s = slots[i]
                t = s.ticket
                if (s.spilled or t.temperature != 0.0 or s.fed < len(t.prompt)
                        or t._cancel is not None
                        or (t.deadline is not None and now >= t.deadline)):
                    continue
                if eng.seq_len - s.pos < self.spec_k + 1:
                    # the window is spec_k + 1 columns however few drafts a
                    # row has, so a row this close to the edge cannot ride
                    continue
                # drafting past the budget is waste: the window's extra
                # token is the one that lands on the budget
                k = min(self.spec_k, t.max_new - s.produced - 1)
                if k < 1:
                    continue
                spec.sync(i, t.rid, t.prompt, t.emitted)
                want[i] = k
                tick[i] = t
        if not want:
            return
        props = spec.propose(want)
        with self._cond:
            for i, d in props.items():
                t = slots[i].ticket
                if t is None or t is not tick.get(i):
                    continue
                d = d[:want[i]]
                if d:
                    self._proposals[i] = (t, d)

    def _account(self, component: str, ms: float) -> None:
        self._comp[component] += ms
        obs_metrics.SCHED_STEP_TIME_MS.inc(component, n=ms)

    def _note_dispatch(self) -> None:
        """One dispatch landed (``stats`` already counts it): the in-flight
        depth and the overlap ratio."""
        self._depth -= 1
        obs_metrics.SCHED_INFLIGHT_DEPTH.set(self._depth)
        obs_metrics.SCHED_OVERLAP_RATIO.set(self.stats["overlapped"] / self.stats["dispatches"])

    def _slot_entries(self, rids: dict, prefset: set, emitted: dict) -> list:
        """The timeline's slot map of one dispatch."""
        return [{"slot": i, "phase": "prefill" if i in prefset else "decode",
                 "tokens": emitted.get(i, 0), "request_id": rids[i]} if i in rids
                else {"slot": i, "phase": "pad", "tokens": 0}
                for i in range(len(self.slots))]

    def _note_step_time(self, wall_ms: float, steps: int) -> None:
        """Fold one dispatch's per-step wall into the EMA that clamps burst
        size under queue pressure."""
        step_ms = wall_ms / max(1, steps)
        self._step_ms_ema = step_ms if self._step_ms_ema is None \
            else 0.8 * self._step_ms_ema + 0.2 * step_ms

    def _fanout(self, active: list[int], steps: int, out, n_valid,
                emitted: dict[int, int]) -> None:
        """Distribute one dispatch's sampled tokens to their tickets and
        advance the slot clocks; ``emitted`` counts the tokens each slot
        gave its ticket.  Caller holds ``self._cond``."""
        eng = self.engine
        slots = self.slots
        now = time.monotonic()
        for i in active:
            # the spill victim clock: a slot that rode this dispatch was
            # active now, whatever it emitted
            slots[i].active_at = now
        for j in range(steps):
            for i in active:
                s = slots[i]
                t = s.ticket
                if t is None:  # retired earlier this burst
                    continue
                tok = int(out[j, i])
                if j == 0 and s.fed < len(t.prompt):
                    s.fed += int(n_valid[i])
                    s.pos += int(n_valid[i])
                    t.prefilled += int(n_valid[i])
                    self.stats["prefill_tokens"] += int(n_valid[i])
                    if s.fed < len(t.prompt):
                        continue  # mid-prefill: the sample means nothing yet
                    # prefill just completed: this sample is the first
                    # completion token.  The prompt's full pages are now
                    # written for good, so they become shareable.
                    if self.prefix_cache is not None and not s.inserted:
                        s.inserted = True
                        n_full = len(t.prompt) // self.pool.page_size
                        if n_full:
                            self.prefix_cache.insert(
                                t.prompt[:n_full * self.pool.page_size],
                                s.pages[:n_full])
                else:
                    s.pos += 1
                s.last = tok
                if tok in t.eos_ids:
                    self._retire(i, "stop")
                    continue
                if t.first_token_at is None:
                    t.first_token_at = time.monotonic()
                s.produced += 1
                emitted[i] += 1
                t.emitted.append(tok)
                t._q.put(tok)
                if s.produced >= t.max_new or s.pos >= eng.seq_len:
                    self._retire(i, "length")
