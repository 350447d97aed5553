"""Continuous-batching slot scheduler over the slot engine — a trimmed copy
of ``dllama_tpu/runtime/scheduler.py`` in its ``kv_reserve="full"``
configuration.

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
  fanout (EOS, budget) leaves N+1 row-wise: its burst row is ignored.

Paged engines (``engine.kv_pages > 0``) reserve every page a request can
touch at admission (prompt + budget), so a dispatch never fails on
allocation and exhaustion surfaces as queueing.  With ``prefix_reuse`` a
radix tree over full prompt pages lets a later prompt with the same prefix
bind those pages copy-free and prefill only its suffix.

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
record a request (submit, admit, prefill chunks, decode bursts, retire),
a slot-timeline entry a dispatch, and ``sched_admit``/``sched_step``/
``sched_retire`` spans.  ``stats`` keeps this scheduler's own counts
(the registry is the process's).

Left out of the copy (``ROADMAP.md``): priorities and preemption,
parking, KV spill and tiering and optimistic reservation, hand-off and
snapshots, and speculative decoding.
"""

from __future__ import annotations

import contextlib
import logging
import queue
import threading
import time
from collections import deque

import numpy as np

from ..obs import flight as obs_flight, metrics as obs_metrics, trace as obs_trace
from ..obs.log import current_request_id, new_request_id, request_id_var
from .engine import ContextOverflow
from .pagepool import PagePool, PagePoolExhausted, RadixTree

_log = logging.getLogger("dllama_tpu_torch.runtime.scheduler")

_DONE = object()  # ticket stream terminator


class SchedulerClosed(RuntimeError):
    """submit() after begin_drain()/close(): no new work is admitted."""


class SchedulerSaturated(RuntimeError):
    """submit() with the wait queue at its bound (the server answers 429)."""


class Ticket:
    """One request's handle: a token stream plus the finish verdict.
    Produced by the scheduler thread, consumed by the HTTP handler
    thread; ``cancel`` may be called from either side."""

    def __init__(self, prompt, max_new, temperature, top_p, eos_ids,
                 deadline, top_k: int = 0):
        self.prompt = list(prompt)
        self.max_new = int(max_new)
        self.temperature = float(temperature)
        self.top_p = float(top_p)
        self.top_k = int(top_k)
        self.eos_ids = tuple(eos_ids)
        self.deadline = deadline  # time.monotonic() or None
        # finish: stop/length/timeout/aborted/error
        self.finish: str | None = None
        self.error: BaseException | None = None
        self.slot: int | None = None
        self.submitted_at = time.monotonic()
        #: monotonic time of the first completion token (time to first token)
        self.first_token_at: float | None = None
        #: prompt tokens this request fed through the model (a prefix-cache
        #: hit skips the rest)
        self.prefilled = 0
        self.stop: list[str] = []
        self.emitted: list[int] = []
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
                 "prefix_tokens", "inserted")

    def __init__(self):
        self.ticket: Ticket | None = None
        self.pos = 0        # this row's cache clock
        self.fed = 0        # prompt tokens consumed so far
        self.produced = 0   # completion tokens emitted
        self.last = 0       # previous sample (decode feedback)
        self.pages: list[int] = []   # paged mode: owned pool pages
        self.prefix_tokens = 0       # prompt tokens bound from the radix tree
        self.inserted = False        # prompt pages handed to the tree yet?


class _Pending:
    """One in-flight dispatch: the engine's completion handle plus who rode
    it, with how many valid tokens each, and with which sampling params.
    The pipeline in :meth:`SlotScheduler._dispatch` keeps at most one of
    these beyond the dispatch it is landing (depth 2)."""

    __slots__ = ("handle", "error", "active", "tickets", "steps", "n_valid",
                 "temps", "topps", "topks", "prefset", "enq_tp", "overlapped",
                 "t_width", "pos_rows", "queued", "t0_mono", "host_gap_ms", "idle_ms")

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw.get(k))


class SlotScheduler:
    """Owns the batch engine; see the module docstring.  ``max_queue``
    bounds requests waiting for a slot (beyond it submit() raises
    :class:`SchedulerSaturated`)."""

    def __init__(self, engine, *, prefill_chunk: int = 16,
                 max_wait_ms: float = 50.0, decode_burst: int = 16,
                 max_queue: int = 32, prefix_reuse: bool = True,
                 overlap: bool = True):
        if engine.cache.quantized and not engine.paged:
            raise ValueError("slot scheduling needs a dense or paged-int8 KV cache")
        self.engine = engine
        self.slots = [_Slot() for _ in range(engine.batch)]
        self.prefill_chunk = max(1, int(prefill_chunk))
        # the widest mixed step this scheduler can emit (a power of two)
        engine.check_slot_width(1 << (min(self.prefill_chunk, engine.seq_len).bit_length() - 1))
        self.max_wait_ms = float(max_wait_ms)
        self.decode_burst = max(1, int(decode_burst))
        self.max_queue = max(1, int(max_queue))
        self.paged = bool(engine.paged)
        self.pool: PagePool | None = None
        self.prefix_cache: RadixTree | None = None
        if self.paged:
            self.pool = PagePool(engine.kv_pages, engine.kv_page_size)
            if prefix_reuse:
                self.prefix_cache = RadixTree(self.pool)
            self._page_tables = np.zeros(
                (engine.batch, engine.max_pages_per_slot), np.int32)
            obs_metrics.KV_PAGES_TOTAL.set(self.pool.capacity)
            obs_metrics.KV_PAGES_IN_USE.set(0)
        #: plain counters: dispatches landed, of them pipelined ones
        #: (``overlapped``) and pipelined ones landed and discarded at a
        #: flush point, prefill tokens fed, prefix-cache hits and the prompt
        #: tokens they skipped, admissions deferred for pages
        self.stats = {"dispatches": 0, "overlapped": 0, "discarded": 0,
                      "prefill_tokens": 0, "prefix_hits": 0,
                      "prefix_tokens_reused": 0, "kv_pool_exhausted": 0}
        self._queue: deque[Ticket] = deque()
        self._cond = threading.Condition()
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
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="dllama-torch-slot-scheduler")
        self._thread.start()

    # -- submission-side API -------------------------------------------
    def submit(self, prompt: list[int], max_new: int, *,
               temperature: float = 0.0, top_p: float = 0.9,
               top_k: int = 0, eos_ids: tuple[int, ...] = (),
               deadline: float | None = None) -> Ticket:
        """Queue one request; returns its :class:`Ticket` immediately.
        ``deadline`` is a ``time.monotonic()`` instant; an expired request
        retires with finish ``timeout`` and what it produced."""
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
                   top_k=top_k)
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
                          temperature=t.temperature, source="scheduler")
        return t

    def occupancy(self) -> dict:
        """Live state for /health and the over-capacity error body."""
        with self._cond:
            out = {"slots": len(self.slots),
                   "active": sum(1 for s in self.slots if s.ticket is not None),
                   "queued": len(self._queue)}
            if self.pool is not None:
                out["kv_pages_total"] = self.pool.capacity
                out["kv_pages_free"] = self.pool.available
                if self.prefix_cache is not None:
                    out["prefix_nodes"] = len(self.prefix_cache)
            out.update(self.stats)
            return out

    def begin_drain(self, deadline: float | None) -> None:
        """Stop admitting and clamp every live and queued deadline."""
        with self._cond:
            self._draining = True
            for t in list(self._queue) + [s.ticket for s in self.slots
                                          if s.ticket is not None]:
                t.deadline = min(t.deadline, deadline) \
                    if (t.deadline and deadline) else (t.deadline or deadline)
            self._cond.notify_all()

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

    # -- scheduler thread ----------------------------------------------
    def _retire(self, slot_idx: int, reason: str,
                error: BaseException | None = None) -> None:
        s = self.slots[slot_idx]
        t = s.ticket
        if t is None:
            return
        t.finish = reason
        t.error = error
        s.ticket = None
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
                          error=repr(error) if error is not None else None)
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
        reserve every page the request can touch (matched prefix + fresh
        pages through ``min(len(prompt) + max_new, seq_len)``).  Returns
        False, binding nothing, when the pool cannot supply them: the
        request stays queued.  Caller holds the lock."""
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
        fresh = -(-need_len // ps) - len(shared)
        try:
            new_pages = pool.alloc(fresh)
        except PagePoolExhausted:
            new_pages = None
            if self.prefix_cache is not None:
                self.prefix_cache.evict(fresh - pool.available)
                try:
                    new_pages = pool.alloc(fresh)
                except PagePoolExhausted:
                    pass
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

    def _admit_locked(self, now: float) -> None:
        """Move waiting tickets into free slots in arrival order (caller
        holds the lock).  A ticket that cannot get its pages keeps the head
        of the queue and admission stops for the round."""
        while self._queue:
            t = self._queue[0]
            if t._cancel is not None or (t.deadline is not None
                                         and now >= t.deadline):
                self._queue.popleft()
                self._fail_ticket(t, t._cancel or "timeout")
                continue
            free = next((i for i, s in enumerate(self.slots)
                         if s.ticket is None), None)
            if free is None:
                return
            if self.pool is not None and not self._bind_pages(free, t):
                return
            self._queue.popleft()
            s = self.slots[free]
            s.ticket = t
            # a prefix hit's matched tokens are already in the cache
            # (shared pages): the clock starts past them
            s.pos = s.fed = s.prefix_tokens if self.pool is not None else 0
            s.produced = 0
            s.last = 0
            t.slot = free
            queued_ms = round((now - t.submitted_at) * 1e3, 3)
            obs_metrics.SCHED_SLOT_JOINS.inc(free)
            obs_trace.record("sched_admit", t.submitted_at, now, rid=t.rid, slot=free,
                             queued_ms=queued_ms, n_prompt=len(t.prompt),
                             prefix_reused=s.pos)
            ctx = request_id_var.set(t.rid)
            try:
                _log.info("slot join", extra={"slot": free, "n_prompt": len(t.prompt),
                                              "queued_ms": queued_ms,
                                              "prefix_reused": s.pos})
            finally:
                request_id_var.reset(ctx)
            obs_flight.admit(t.rid, slot=free, queued_ms=queued_ms, prefix_reused=s.pos)
            obs_metrics.QUEUE_WAIT.observe(max(now - t.submitted_at, 0.0))

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
                    if not self._paused:
                        self._admit_locked(now)
                    active = self._active()
                    queued = len(self._queue)
                    obs_metrics.SCHED_SLOTS_OCCUPIED.set(len(active))
                    obs_metrics.SCHED_QUEUE_DEPTH.set(queued)
                    if self._stop:
                        return
                    if not active:
                        if self._paused:
                            self._idle.set()
                        # submissions, cancels and close notify at once; the
                        # timeout only has to cover the earliest queued
                        # deadline (a paused scheduler holds its queue)
                        timeout = 0.5
                        dls = [t.deadline for t in self._queue if t.deadline is not None]
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
        # both dispatch dimensions are rounded down to a power of two: a
        # few distinct shapes, each reused (the JAX package compiles one
        # program per shape; here it keeps step times comparable)
        if prefilling:
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
        handle, error = None, None
        try:
            handle = eng.slot_step_async(
                tokens, pos_rows, n_valid, temps_np=temps, topps_np=topps,
                topks_np=topks, steps=steps,
                page_tables_np=self._page_tables if self.paged else None)
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
                        host_gap_ms=host_gap_ms, idle_ms=idle_ms)

    def _maybe_pipeline(self, cur: _Pending) -> _Pending | None:
        """While ``cur`` is still in flight, enqueue the next pure-decode
        dispatch fed by ``cur``'s on-device last-token row.  Returns None
        at any pipeline flush point — queued admission pending, drain /
        pause / flush request / close, cancel or expired deadline, a row
        still mid-prefill after ``cur``, no context room, every row's
        budget spent by ``cur`` — and the round then completes
        synchronously."""
        eng = self.engine
        slots = self.slots
        b = eng.batch
        with self._cond:
            if (self._stop or self._draining or self._paused
                    or self._flush_req or self._queue):
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
            ptab = self._page_tables.copy() if self.paged else None
            # reserve the in-flight count before releasing the lock so a
            # concurrent _flushed() waiter sees this dispatch coming
            self._inflight_n += 1
        handle, err = None, None
        try:
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
                        host_gap_ms=0.0, idle_ms=0.0)

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
                    or self._flush_req or self._queue):
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
        obs_trace.record("sched_step", cur.t0_mono, time.monotonic(), active=n_act,
                         queued=cur.queued, t=cur.t_width, steps=cur.steps,
                         overlapped=cur.overlapped, rids=sorted(rids.values()))
        emitted = dict.fromkeys(cur.active, 0)
        # the fanout holds _cond: slot clocks and tickets are never seen
        # half-advanced from another thread
        with self._cond:
            self._fanout(cur.active, cur.steps, out, cur.n_valid, emitted)
        # flight phases after the fanout, so the emitted counts are final
        for i in cur.active:
            if i in cur.prefset:
                obs_flight.phase(rids[i], "prefill_chunk", tokens=int(cur.n_valid[i]),
                                 ms=wall_ms, pos=int(cur.pos_rows[i]), emitted=emitted[i])
            else:
                obs_flight.phase(rids[i], "decode_burst", steps=cur.steps,
                                 tokens=emitted[i], wall_ms=wall_ms,
                                 step_ms=wall_ms / cur.steps)
        obs_flight.TIMELINE.record_step(
            ts=ts0, wall_ms=wall_ms, device_ms=self.engine.last_slot_dispatch_ms,
            host_gap_ms=gap_exposed, idle_ms=gap_idle, steps=cur.steps,
            t_width=cur.t_width, overlapped=cur.overlapped, hidden_host_ms=hidden_ms,
            slots=self._slot_entries(rids, cur.prefset, emitted))
        return True

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
