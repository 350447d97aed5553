"""CUDA graphs of the port's decode steps — the counterpart of the JAX
package's compiled decode chunk (``dllama_tpu/runtime/engine.py``
``_chunk_fn`` over ``decode_loop.decode_chunk``) and of its jitted slot
step (``slot_step_async``): a decode step is one program on the card,
replayed with one launch instead of the ~300 ops a forward issues from
Python.

Three step bodies, each one step of its eager twin in ``decode_loop``,
reading every input from static buffers and writing every output there:

* :func:`chunk_step` — a step of ``decode_chunk``: batch-1 streams
  (``Engine.generate_stream``: the ``inference``, ``generate`` and ``chat``
  modes) and the lockstep ragged batch (``generate_batch_stream``, its
  ``offsets`` a static buffer);
* :func:`slot_step` — a pure-decode step of ``slot_chunk``
  (``Engine.slot_step_async`` with ``feed_dev`` or one token a row):
  contiguous slot rows or a paged pool, bf16 or int8;
* :func:`mixed_step` — the first forward of a mixed ``slot_chunk``
  (t > 1 tokens a row: prefill chunks beside decode rows), the scheduler's
  prefill step, which sets TTFT.  Its paged read is the prefill kernel
  (``ops.attention.paged_prefill_attention``); the contiguous slot rows'
  read stays the plain per-row-ceiling op.  The dispatch's later steps
  replay the slot graph, fed the mixed step's last row on the device;
* :func:`verify_step` — ``decode_loop.slot_verify_chunk``, speculative
  decoding's verify step (``Engine.slot_verify_async``): the (B, T) window
  of every row (its last sample, then its drafts; T = ``spec_k + 1``,
  fixed, each row's ``nvalid`` of it valid) through the slot forward with
  every position's logits, the argmax a position, and the accepted counts
  and ``last`` computed in the graph; read the same way as the mixed step;
* :func:`pld_step` — the batch-1 prompt-lookup window of
  ``Engine.generate_pld_stream``: ``T = k + 1`` tokens at the device
  position on the contiguous cache (the plain t > 1 read), the argmax a
  position and the accepted count in the graph.

A verify or PLD step writes its predictions with the accepted counts
appended (``vout``: (B, T + 1) int32) to a static buffer the engine lands
through one pinned copy, so the host reads both after the landing event,
never mid-step.

:class:`DecodeGraphs` keeps one engine's graphs, keyed by what fixes a
graph's shapes (:class:`GraphKey`: path, rows, greedy or sampled, walk
bucket), with their buffers.  The first step of a key runs its body
eagerly — the warm-up, where the kernels' build, library load and
shared-memory opt-in happen, never inside a capture — and then captures
the body once; every later step of the key replays it.  A capture or a
replay that fails raises: nothing runs eagerly in its place.  With
``capture=False`` every step runs the same body on the same buffers
eagerly: the CPU tests drive it so.

Eager, and how they run today (every kernel still launches on the
card): the batch-1 and lockstep prefill forwards (``Engine.prefill``,
``prefill_ragged``) and tensor parallelism (tp > 1).

What a captured step has to hold, and how the bodies hold it:

* **Positions on the device.**  A graph freezes Python ints, so the step
  reads its position from a buffer (``ops.attention.DevicePos``): RoPE
  angles, the KV write (``index_copy_`` at a device index) and the
  attention mask all read it there.  The contiguous decode walk
  (``blocked_live_fold``) reads a fixed number of ``_kv_chunk`` blocks a
  graph: the step takes the graph of the bucket that holds its position
  (``ops.attention.walk_bucket``; 4 buckets at seq_len 4096), and each step
  picks its own, so a chunk that crosses a block edge changes graph there.
  Below ``_DECODE_BLOCKED_MIN_S`` the one-shot attention reads the whole
  cache and masks with the device position (bucket 0).  The paged slot
  step needs no bucket: kernel 7's split plan depends on shapes only, and
  it reads positions and page tables on the device.
* **Buffers that must not move.**  ``q40._gemv_workspace`` and
  ``device.index_view`` keep every buffer they replace alive, so a graph
  captured before a replacement keeps valid addresses; the decode body's
  counts are 0 after every replay as after every launch.  Scratch a
  wrapper allocates per call (the tensor-core body's split-K sums, the
  attention kernels' split records) is allocated during the capture, from
  the graph's own pool, which lives as long as the graph.  The RoPE
  frequencies live on the device once (``ops.kernels.rope_angles``): the
  body makes no host-to-device copy.
* **Launch counters.**  The kernels' counters are Python ints bumped at
  launch, which a replay would not bump.  A capture records the counters'
  deltas (:func:`counter_delta`), takes them back (the capture launched
  nothing) and every replay adds them (:func:`add_counts`), so the
  counters read the same per token with graphs on and off.
* **The generator.**  A sampled step's coins are drawn eagerly into the
  static ``coins`` buffer just before each replay (``uniform_`` from the
  engine's generator, the draw ``torch.rand`` makes), so the generator
  advances on the host exactly as in the eager loop, and
  ``get_state``/``set_state`` still hand back a discarded chunk's draws.
  Greedy steps draw nothing.
* **Token feedback.**  Each step writes its sample into the static input
  buffer ``tok`` that the next replay reads, and into an output ring the
  engine copies to the host (``Engine`` part of the dispatch) before a
  later dispatch can overwrite it: by position for the chunk path, by step
  for the slot path.  Each graph has its own memory pool; a capture's
  seconds and the bytes its pool reserved are kept in :attr:`DecodeGraphs.cost`.
* **Threads.**  Graphs are captured by the thread that steps the engine
  (the scheduler's thread for the slot engine) on a capture stream of
  their own, in ``thread_local`` capture mode, so another thread's work on
  the card cannot break a capture.  Python's cyclic collector is held off
  during a capture: collecting an unreachable engine's graph there would
  destroy a graph while a stream captures, which invalidates the capture.
"""

from __future__ import annotations

import contextlib
import gc
import sys
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from ..device import upload
from ..models.transformer import forward, forward_last, forward_slots, forward_slots_all
from ..ops import COUNT_LOCK, attention, q8, q40
from ..ops.attention import DevicePos, walk_bound, walk_bucket
from ..sampling import sample_on_device
from .decode_loop import verify_accept

# the modules whose launch counters a replay advances
COUNTED = (q40, q8, attention)


class GraphKey(NamedTuple):
    """What fixes a graph's shapes: ``path`` (``"chunk"``: batch-1 and
    lockstep rows without offsets, ``"ragged"``: the lockstep batch with
    its offsets, ``"slot"``, ``"mixed"``), ``batch`` rows, ``greedy``
    (argmax, no coin) or sampled, and ``walk``: the walk bucket (0 where
    there is no walk), or a mixed, verify or PLD step's width T (paths
    ``"verify"`` and ``"pld"``)."""
    path: str
    batch: int
    greedy: bool
    walk: int


# -- captures and the cyclic collector ------------------------------------

_gc_lock = threading.Lock()
_gc_holds = 0           # captures in progress, on any thread
_gc_was_enabled = False


@contextlib.contextmanager
def _no_collection():
    """Hold Python's cyclic collector off while any capture runs (it is
    process-wide, and captures of several engines may overlap): a
    collection that destroyed an unreachable engine's CUDA graph during a
    capture would invalidate the capture."""
    global _gc_holds, _gc_was_enabled
    with _gc_lock:
        if _gc_holds == 0:
            _gc_was_enabled = gc.isenabled()
            gc.disable()
        _gc_holds += 1
    try:
        yield
    finally:
        with _gc_lock:
            _gc_holds -= 1
            if _gc_holds == 0 and _gc_was_enabled:
                gc.enable()


# -- launch counters -----------------------------------------------------

def counter_snapshot(modules=COUNTED) -> dict:
    """Every launch counter of ``modules``, flat: ``(module, name)`` for
    the plain ints, ``(module, "launches_by_shape", key)`` for the
    per-shape ones."""
    snap = {}
    for mod in modules:
        for name, v in mod.counters().items():
            if name == "launches_by_shape":
                for key, n in v.items():
                    snap[(mod.__name__, name, key)] = n
            else:
                snap[(mod.__name__, name)] = v
    return snap


def counter_delta(before: dict, after: dict) -> dict:
    """The counts that moved from ``before`` to ``after`` (snapshots)."""
    return {k: after.get(k, 0) - before.get(k, 0) for k in after.keys() | before.keys()
            if after.get(k, 0) != before.get(k, 0)}


def add_counts(delta: dict, sign: int = 1) -> None:
    """Add ``sign * delta`` to the modules' counters (a per-shape count
    that reaches 0 is dropped)."""
    for key, n in delta.items():
        mod = sys.modules[key[0]]
        if key[1] == "launches_by_shape":
            d = mod.launches_by_shape
            d[key[2]] = d.get(key[2], 0) + sign * n
            if d[key[2]] == 0:
                del d[key[2]]
        else:
            setattr(mod, key[1], getattr(mod, key[1]) + sign * n)


# -- static buffers and the step bodies -----------------------------------

class ChunkBuffers:
    """The static inputs and outputs of :func:`chunk_step` for ``b`` rows:
    the input token ``tok`` (B,) int32 (each step writes its sample here),
    the position ``pos`` (0-d int64, the step's cache position; each step
    adds one), the ring ``out`` (seq_len, B) int32 (the step at position
    ``p`` writes row ``p``), ``coins``/``temps``/``topps`` (B,) f32, the
    ragged batch's ``offsets`` (B,) int64 or None, and the step's
    ``logits`` (B, V) f32."""

    def __init__(self, b: int, vocab: int, seq_len: int, dev, ragged: bool):
        self.tok = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.pos = torch.zeros((), dtype=torch.int64, device=dev)
        self.out = torch.zeros((seq_len, b), dtype=torch.int32, device=dev)
        self.coins = torch.zeros((b,), dtype=torch.float32, device=dev)
        self.temps = torch.zeros((b,), dtype=torch.float32, device=dev)
        self.topps = torch.zeros((b,), dtype=torch.float32, device=dev)
        self.offsets = torch.zeros((b,), dtype=torch.int64, device=dev) if ragged else None
        self.logits = torch.zeros((b, vocab), dtype=torch.float32, device=dev)
        self.windows: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}

    def window(self, t: int) -> tuple[torch.Tensor, torch.Tensor]:
        """A PLD window's static (B, ``t``) input tokens and its (B,
        ``t`` + 1) output: the predictions, then the accepted count."""
        if t not in self.windows:
            b, dev = self.tok.shape[0], self.tok.device
            self.windows[t] = (torch.zeros((b, t), dtype=torch.int32, device=dev),
                               torch.zeros((b, t + 1), dtype=torch.int32, device=dev))
        return self.windows[t]


class SlotBuffers:
    """The static inputs and outputs of :func:`slot_step` for ``b`` slot
    rows: ``tok`` (B,) int32, per-row positions ``pos_rows`` and valid
    counts ``nvalid`` (B,) int32 (a dispatch's first step consumes
    ``nvalid``, later ones one token), the step index ``i`` (1,) int64 into
    the ring ``out`` (seq_len, B) int32, ``coins``/``temps``/``topps`` (B,)
    f32, ``topks`` (B,) int32, the page table (B, maxp) int32 of a paged
    engine (else None) and ``logits`` (B, V) f32; ``wide`` holds a mixed
    or verify step's (B, T) input tokens, one buffer a width, and ``vout``
    a verify step's (B, T + 1) output (predictions, then the accepted
    count)."""

    def __init__(self, b: int, vocab: int, seq_len: int, dev, max_pages: int | None):
        self.tok = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.pos_rows = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.nvalid = torch.ones((b,), dtype=torch.int32, device=dev)
        self.i = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.out = torch.zeros((seq_len, b), dtype=torch.int32, device=dev)
        self.coins = torch.zeros((b,), dtype=torch.float32, device=dev)
        self.temps = torch.zeros((b,), dtype=torch.float32, device=dev)
        self.topps = torch.zeros((b,), dtype=torch.float32, device=dev)
        self.topks = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.ptab = (torch.zeros((b, max_pages), dtype=torch.int32, device=dev)
                     if max_pages else None)
        self.logits = torch.zeros((b, vocab), dtype=torch.float32, device=dev)
        self.wide: dict[int, torch.Tensor] = {}
        self.vout: dict[int, torch.Tensor] = {}

    def tokens(self, t: int) -> torch.Tensor:
        """The static (B, t) input of a mixed step of width ``t``."""
        if t not in self.wide:
            self.wide[t] = torch.zeros((self.tok.shape[0], t), dtype=torch.int32,
                                       device=self.tok.device)
        return self.wide[t]

    def verify_out(self, t: int) -> torch.Tensor:
        """The static (B, ``t`` + 1) output of a verify step of width ``t``."""
        if t not in self.vout:
            self.vout[t] = torch.zeros((self.tok.shape[0], t + 1), dtype=torch.int32,
                                       device=self.tok.device)
        return self.vout[t]


def _sample(logits, buf, greedy: bool, topks) -> torch.Tensor:
    if greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return sample_on_device(logits, buf.coins, buf.temps, buf.topps, topks)


def chunk_step(params, cfg, cache, buf: ChunkBuffers, walk: int, greedy: bool) -> None:
    """One step of ``decode_loop.decode_chunk`` on ``buf``: the forward of
    ``buf.tok`` at the device position ``buf.pos`` (the decode walk fixed
    at bucket ``walk``), its sample written to ``out[pos]`` and ``tok``,
    its logits to ``logits``, and ``pos`` advanced."""
    s = cache.k.shape[3]
    logits, _ = forward_last(params, cfg, buf.tok[:, None], cache,
                             DevicePos(buf.pos, walk_bound(walk, s)), 0,
                             offsets=buf.offsets)
    topks = None if greedy else torch.zeros_like(buf.tok)
    tok = _sample(logits, buf, greedy, topks)
    buf.out.index_copy_(0, buf.pos.view(1), tok[None])
    buf.tok.copy_(tok)
    buf.logits.copy_(logits)
    buf.pos.add_(1)


def slot_step(params, cfg, cache, buf: SlotBuffers, greedy: bool,
              tokens: torch.Tensor | None = None) -> None:
    """One step of ``decode_loop.slot_chunk`` on ``buf``: the slot forward
    of ``tokens`` (B, T), by default ``buf.tok`` (one token a row), at
    ``pos_rows`` with ``nvalid`` valid tokens (through the page table when
    the engine is paged), its sample written to ``out[i]`` and ``tok``, its
    logits to ``logits``; the clocks advance by ``nvalid`` and every later
    step of the dispatch feeds one token."""
    if tokens is None:
        tokens = buf.tok[:, None]
    logits, _ = forward_slots(params, cfg, tokens, cache, buf.pos_rows,
                              buf.nvalid, page_table=buf.ptab)
    tok = _sample(logits, buf, greedy, buf.topks)
    buf.out.index_copy_(0, buf.i, tok[None])
    buf.i.add_(1)
    buf.tok.copy_(tok)
    buf.logits.copy_(logits)
    buf.pos_rows.add_(buf.nvalid)
    buf.nvalid.fill_(1)


def mixed_step(params, cfg, cache, buf: SlotBuffers, greedy: bool, t: int) -> None:
    """The first forward of a mixed ``decode_loop.slot_chunk``: the slot
    step (:func:`slot_step`) of the static (B, ``t``) tokens
    ``buf.tokens(t)``, row ``r`` consuming its first ``nvalid[r]``."""
    slot_step(params, cfg, cache, buf, greedy, tokens=buf.tokens(t))


def verify_step(params, cfg, cache, buf: SlotBuffers, greedy: bool, t: int) -> None:
    """``decode_loop.slot_verify_chunk`` on ``buf``: the slot forward of the
    static (B, ``t``) window ``buf.tokens(t)`` at ``pos_rows`` with
    ``nvalid`` valid tokens a row, every position's logits, their argmax (a
    sampled batch's column 0 drawn with ``coins``), the accepted counts
    and ``last`` on the device: ``verify_out(t)`` gets the predictions and
    the counts, ``tok`` the last row, ``logits`` each row's logits at its
    last emitted position.  The clocks are the host's (the scheduler
    advances each row by its own accepted count)."""
    tokens = buf.tokens(t)
    logits, _ = forward_slots_all(params, cfg, tokens, cache, buf.pos_rows, buf.nvalid,
                                  page_table=buf.ptab)
    preds = torch.argmax(logits, dim=-1).to(torch.int32)
    if not greedy:
        preds[:, 0] = _sample(logits[:, 0], buf, False, buf.topks)
    accepted, last = verify_accept(tokens, preds, buf.nvalid)
    out = buf.verify_out(t)
    out[:, :t].copy_(preds)
    out[:, t].copy_(accepted)
    buf.tok.copy_(last)
    b = tokens.shape[0]
    buf.logits.copy_(logits[torch.arange(b, device=logits.device), accepted.long()])


def pld_step(params, cfg, cache, buf: ChunkBuffers, t: int) -> None:
    """A batch-1 prompt-lookup window on ``buf``: the forward of the static
    (1, ``t``) window at the device position ``buf.pos`` (the contiguous
    t > 1 read over the whole cache), the argmax at every position and the
    count of leading drafts matched (:func:`decode_loop.verify_accept`,
    every draft column valid), written to the window's output."""
    tokens, out = buf.window(t)
    s = cache.k.shape[3]
    logits, _ = forward(params, cfg, tokens, cache, DevicePos(buf.pos, s - 1))
    preds = torch.argmax(logits, dim=-1).to(torch.int32)
    nvalid = torch.full((tokens.shape[0],), t, dtype=torch.int32, device=tokens.device)
    accepted, _ = verify_accept(tokens, preds, nvalid)
    out[:, :t].copy_(preds)
    out[:, t].copy_(accepted)


# -- the graph cache -------------------------------------------------------

class _Captured(NamedTuple):
    graph: object      # torch.cuda.CUDAGraph
    delta: dict        # the launch counts of one step


class DecodeGraphs:
    """One engine's decode-step graphs and their buffers (module
    docstring).  ``capture=False`` runs every step's body eagerly.
    Counts: ``captures`` graphs captured, ``replays`` steps replayed,
    ``eager_steps`` steps run eagerly (each key's first on the card);
    ``cost`` maps each captured key to (capture seconds, bytes its memory
    pool reserved)."""

    def __init__(self, device: torch.device, capture: bool = True):
        if capture and device.type != "cuda":
            raise ValueError(f"CUDA graphs need a cuda device, got {device}")
        self.device = device
        self.capture = capture
        self.graphs: dict[GraphKey, _Captured] = {}
        self.cost: dict[GraphKey, tuple[float, int]] = {}
        self._buffers: dict[str, object] = {}
        self._stream = None
        self.captures = self.replays = self.eager_steps = 0

    def _step(self, key: GraphKey, body) -> None:
        """Run one step of ``key``: replay its graph, or (its first step,
        or with ``capture`` off) run ``body`` eagerly, then capture it."""
        g = self.graphs.get(key) if self.capture else None
        if g is not None:
            g.graph.replay()
            with COUNT_LOCK:
                add_counts(g.delta)
            self.replays += 1
            return
        body()
        self.eager_steps += 1
        if self.capture:
            # one capture at a time in the process, and no launch counted
            # on another thread meanwhile (several servers share it): the
            # capture's counter delta is its own
            with COUNT_LOCK:
                # the capture empties the allocator's cache first; so does
                # this, so the reserved bytes grow by the graph's own pool
                torch.cuda.synchronize(self.device)
                torch.cuda.empty_cache()
                t0, pool0 = time.perf_counter(), torch.cuda.memory_reserved(self.device)
                self.graphs[key] = self._capture(body)
                self.cost[key] = (time.perf_counter() - t0,
                                  torch.cuda.memory_reserved(self.device) - pool0)

    def _capture(self, body) -> _Captured:
        """Capture ``body`` once into a graph with its own memory pool on
        this cache's capture stream; the capture's counter deltas are
        taken back and kept for the replays."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        before = counter_snapshot()
        graph = torch.cuda.CUDAGraph()
        with _no_collection(), torch.cuda.graph(graph, stream=self._stream,
                                                capture_error_mode="thread_local"):
            body()
        delta = counter_delta(before, counter_snapshot())
        add_counts(delta, -1)
        self.captures += 1
        return _Captured(graph, delta)

    def _chunk_buffers(self, engine, ragged: bool) -> ChunkBuffers:
        name = "ragged" if ragged else "chunk"
        buf = self._buffers.get(name)
        if buf is None:
            buf = self._buffers[name] = ChunkBuffers(
                engine.batch, engine.cfg.vocab_size, engine.seq_len, self.device, ragged)
        return buf

    def chunk(self, engine, token, p0: int, steps: int, temperature: float,
              topp: float):
        """``steps`` decode steps of ``engine`` from position ``p0`` fed
        ``token`` (B,) — a device tensor or host ids; ``engine.offsets``
        makes them the ragged batch's.  Each step takes the graph of its
        own walk bucket.  Returns (ids (steps, B), last row (B,), logits
        (B, V)) on the device: a view of the ring (the caller copies it out
        before a later dispatch can overwrite it), and copies of the
        fed-back token and of the last step's logits."""
        ragged = engine.offsets is not None
        greedy = temperature == 0.0
        buf = self._chunk_buffers(engine, ragged)
        if isinstance(token, torch.Tensor):
            buf.tok.copy_(token)
        else:
            buf.tok.copy_(upload(np.asarray(token), torch.int32, self.device))
        buf.pos.fill_(p0)
        if ragged:
            buf.offsets.copy_(engine.offsets)
        if not greedy:
            buf.temps.fill_(temperature)
            buf.topps.fill_(topp)
        s = engine.cache.k.shape[3]
        path = "ragged" if ragged else "chunk"
        for i in range(steps):
            if not greedy:
                buf.coins.uniform_(0.0, 1.0, generator=engine._gen)
            walk = walk_bucket(p0 + i, s)
            self._step(GraphKey(path, engine.batch, greedy, walk),
                       lambda: chunk_step(engine.params, engine.cfg, engine.cache,
                                          buf, walk, greedy))
        return buf.out[p0:p0 + steps], buf.tok.clone(), buf.logits.clone()

    def _slot_buffers(self, engine, pos_rows_np, n_valid_np, temps_np, topps_np,
                      topks_np, page_tables_np) -> SlotBuffers:
        """The slot buffers with a dispatch's host rows copied in (the
        input tokens are the caller's)."""
        buf = self._buffers.get("slot")
        if buf is None:
            buf = self._buffers["slot"] = SlotBuffers(
                engine.batch, engine.cfg.vocab_size, engine.seq_len, self.device,
                engine.max_pages_per_slot if engine.paged else None)
        dev = self.device
        buf.pos_rows.copy_(upload(pos_rows_np, torch.int32, dev))
        buf.nvalid.copy_(upload(n_valid_np, torch.int32, dev))
        buf.temps.copy_(upload(temps_np, torch.float32, dev))
        buf.topps.copy_(upload(topps_np, torch.float32, dev))
        buf.topks.copy_(upload(topks_np, torch.int32, dev))
        if buf.ptab is not None:
            buf.ptab.copy_(upload(page_tables_np, torch.int32, dev))
        buf.i.zero_()
        return buf

    def _decode_steps(self, engine, buf: SlotBuffers, steps: int, greedy: bool) -> None:
        for _ in range(steps):
            if not greedy:
                buf.coins.uniform_(0.0, 1.0, generator=engine._gen)
            self._step(GraphKey("slot", engine.batch, greedy, 0),
                       lambda: slot_step(engine.params, engine.cfg, engine.cache, buf, greedy))

    def slot(self, engine, feed_dev, tokens_np, pos_rows_np, n_valid_np, temps_np,
             topps_np, topks_np, steps: int, page_tables_np, greedy: bool):
        """A pure-decode slot dispatch of ``steps`` steps: the host's rows
        (or ``feed_dev``, a prior dispatch's last row on the device) copied
        into the static buffers, then one replay a step.  Returns (ids
        (steps, B), last row (B,), logits (B, V)) as :meth:`chunk`."""
        buf = self._slot_buffers(engine, pos_rows_np, n_valid_np, temps_np, topps_np,
                                 topks_np, page_tables_np)
        if feed_dev is not None:
            buf.tok.copy_(feed_dev)
        else:
            buf.tok.copy_(upload(tokens_np[:, 0], torch.int32, self.device))
        self._decode_steps(engine, buf, steps, greedy)
        return buf.out[:steps], buf.tok.clone(), buf.logits.clone()

    def mixed(self, engine, tokens_np, pos_rows_np, n_valid_np, temps_np, topps_np,
              topks_np, steps: int, page_tables_np, greedy: bool):
        """A mixed slot dispatch: the (B, T) host tokens (T > 1) copied into
        the width's static buffer, the mixed step replayed (its key
        ``GraphKey("mixed", B, greedy, T)``), then ``steps - 1`` replays of
        the slot graph fed its last row on the device (the slot buffers are
        the mixed step's, so its sample, clocks and step index carry over).
        Returns (ids (steps, B), last row (B,), logits (B, V)) as
        :meth:`chunk`."""
        t = int(tokens_np.shape[1])
        buf = self._slot_buffers(engine, pos_rows_np, n_valid_np, temps_np, topps_np,
                                 topks_np, page_tables_np)
        buf.tokens(t).copy_(upload(tokens_np, torch.int32, self.device))
        if not greedy:
            buf.coins.uniform_(0.0, 1.0, generator=engine._gen)
        self._step(GraphKey("mixed", engine.batch, greedy, t),
                   lambda: mixed_step(engine.params, engine.cfg, engine.cache, buf, greedy, t))
        self._decode_steps(engine, buf, steps - 1, greedy)
        return buf.out[:steps], buf.tok.clone(), buf.logits.clone()

    def verify(self, engine, tokens_np, pos_rows_np, n_valid_np, temps_np, topps_np,
               topks_np, page_tables_np, greedy: bool):
        """A slot verify dispatch: the (B, T) window copied into the
        width's static buffer and the verify step replayed (its key
        ``GraphKey("verify", B, greedy, T)``).  Returns (the (B, T + 1)
        predictions and accepted counts, the last row (B,), logits (B, V))
        on the device: a view of the static output (the caller lands it
        before a later dispatch can overwrite it), and copies."""
        t = int(tokens_np.shape[1])
        buf = self._slot_buffers(engine, pos_rows_np, n_valid_np, temps_np, topps_np,
                                 topks_np, page_tables_np)
        buf.tokens(t).copy_(upload(tokens_np, torch.int32, self.device))
        if not greedy:
            buf.coins.uniform_(0.0, 1.0, generator=engine._gen)
        self._step(GraphKey("verify", engine.batch, greedy, t),
                   lambda: verify_step(engine.params, engine.cfg, engine.cache, buf, greedy, t))
        return buf.verify_out(t), buf.tok.clone(), buf.logits.clone()

    def pld(self, engine, window_np, p0: int) -> torch.Tensor:
        """A batch-1 PLD window of T tokens at position ``p0``: copied into
        the width's static buffer, the PLD step replayed (its key
        ``GraphKey("pld", 1, True, T)``).  Returns the (1, T + 1) output
        (predictions, then the accepted count) on the device, a view the
        caller lands before the next window."""
        t = int(window_np.shape[1])
        buf = self._chunk_buffers(engine, False)
        tokens, out = buf.window(t)
        tokens.copy_(upload(window_np, torch.int32, self.device))
        buf.pos.fill_(p0)
        self._step(GraphKey("pld", engine.batch, True, t),
                   lambda: pld_step(engine.params, engine.cfg, engine.cache, buf, t))
        return out
