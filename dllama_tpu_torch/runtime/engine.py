"""Inference engine: prefill/decode + generation loop + G/I/T stats, the
lockstep batch of distinct prompts, and the slot step of continuous
batching — the port of ``dllama_tpu/runtime/engine.py`` (batch-1 streams,
``generate_batch`` and the slot engine).

Prefill pads the prompt up to a bucket (clamped to the cache) and runs it in
one forward; decode runs chunks of on-device steps (:meth:`Engine.decode`):
on ``cuda`` at tp = 1 each step replays a captured CUDA graph
(:mod:`runtime.graphs`), else :func:`decode_loop.decode_chunk` runs them
eagerly.  Stats keep the reference's per-token G/I/T contract: G =
whole-step wall ms, I = device compute ms, T = device→host transfer ms.

A decode dispatch (a chunk, or a slot dispatch) lands through a
:class:`Landing`: on CUDA an event right after its last op, then a
non-blocking copy of its token ids into pinned host memory and a second
event, all enqueued before anything later.  Fetching a dispatch waits on
its own events only, so the next one, enqueued first, stays in flight while
the host fans this one out; I and T are read at those events, so they are
the device's, not the enqueue's.

Every blocking edge (the batch-1 forward's sync, each landing's wait, a
page copy's wait) runs through :meth:`Engine._sync`: it fires the
``engine.device_step`` fault point (``runtime/faults.py``) and, with
``step_timeout`` set, waits on a watchdog thread so that a step that does
not land in time raises :class:`StepTimeout`.  ``numeric_checks`` checks
every host-fetched logits array (prefill, single-token decode, ragged
prefill) for NaN/Inf and raises :class:`NumericFault`; the on-device decode
chunks and slot dispatches ship token ids only, so a divergence there
shows at the next host-logits step, as in the JAX package.

Over a mesh that spans processes (a worker group, ``parallel/mesh.py``)
the engine keeps KV for its own ranks; process 0 picks every token
(greedy, or from its seeded generator) from the logits it gathered and
broadcasts it over the group, and the others feed it to their next
forward (:meth:`Engine._pick`).  Every process hashes the tokens it
picked or received; :meth:`Engine.check_agreement` compares the hashes
over the group at the end of a run.  Such an engine runs the batch-1
and lockstep-batch streams (``generate_stream``, ``generate_batch``,
``decode``), eagerly; the slot, speculative and scoring paths refuse it.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..device import resolve, synchronize, upload
from ..io.integrity import bump_counter
from ..models.config import ModelConfig
from ..models.params import Params, to_device
from ..models.transformer import (ShardedKV, forward, forward_last, init_kv_cache,
                                  init_kv_pool)
from ..obs import metrics as obs_metrics, trace as obs_trace
from ..ops import attention, q40
from ..parallel.mesh import Mesh
from ..parallel.sharding import Placed, check_ep_constraint, place_params
from ..sampling import Sampler
from . import snapshot as snapfmt
from .decode_loop import (decode_chunk, device_sample, slot_chunk, slot_verify_chunk,
                          verify_accept)
from .faults import FAULTS
from .graphs import DecodeGraphs


def _cuda_memory(read):
    """A per-card memory reader for a labeled gauge: ``{card: bytes}`` at
    scrape time, ``{}`` without a card (no samples, never zeros)."""
    def fn() -> dict:
        if not torch.cuda.is_available():
            return {}
        return {str(i): float(read(i)) for i in range(torch.cuda.device_count())}
    return fn


obs_metrics.HBM_BYTES_IN_USE.fn = _cuda_memory(torch.cuda.memory_allocated)
obs_metrics.HBM_BYTES_PEAK.fn = _cuda_memory(torch.cuda.max_memory_allocated)


def _observe(stats: "StepStats", sent: float, recv: float) -> None:
    """The engine-step histograms (the reference's G/I/T contract)."""
    obs_metrics.ENGINE_GENERATION_MS.observe(stats.generation_ms)
    obs_metrics.ENGINE_INFERENCE_MS.observe(stats.inference_ms)
    obs_metrics.ENGINE_TRANSFER_MS.observe(stats.transfer_ms)
    obs_metrics.HOST_DEVICE_SENT_BYTES.observe(sent)
    obs_metrics.HOST_DEVICE_RECV_BYTES.observe(recv)


def _next_bucket(n: int, minimum: int = 16) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


class ContextOverflow(ValueError):
    """The requested tokens do not fit the engine's context window."""


class NumericFault(RuntimeError):
    """NaN/Inf in the host-fetched logits under ``numeric_checks``: names
    the step, the sequence position and a hint.  Detection is at the
    logits (the one tensor the host already fetches), so it cannot name
    the layer that produced the NaN.  The server answers 500 and resets
    the engine (a NaN anywhere implies the KV cache may be poisoned)."""

    def __init__(self, step: str, pos: int, hint: str = ""):
        self.step = step
        self.pos = pos
        self.hint = hint
        msg = f"non-finite logits at {step}, pos={pos}"
        super().__init__(msg + (f" ({hint})" if hint else ""))


class StepTimeout(RuntimeError):
    """A device step did not land within the engine's watchdog deadline
    (``step_timeout``, or ``DLLAMA_STEP_TIMEOUT``): a diagnosable error
    naming the step and position instead of a thread parked forever.  A
    wait on the card cannot be cancelled: the watchdog's helper thread stays
    parked in it, and the card may be unusable, so the server marks itself
    degraded (``/health`` 503) for the router to eject it and a supervisor
    to replace the process."""


@dataclass
class StepStats:
    generation_ms: float = 0.0  # G: total wall time for the token
    inference_ms: float = 0.0   # I: device execution
    transfer_ms: float = 0.0    # T: device → host boundary
    sent_bytes: float = 0.0     # S: host → device (fractional per token when
    recv_bytes: float = 0.0     # R: device → host   averaged over a chunk)


@dataclass
class RunStats:
    tokens: list[StepStats] = field(default_factory=list)
    _g_sum: float = field(default=0.0, repr=False)
    _i_sum: float = field(default=0.0, repr=False)
    _t_sum: float = field(default=0.0, repr=False)
    _s_sum: float = field(default=0.0, repr=False)
    _r_sum: float = field(default=0.0, repr=False)

    def add(self, s: StepStats):
        self.tokens.append(s)
        self._g_sum += s.generation_ms
        self._i_sum += s.inference_ms
        self._t_sum += s.transfer_ms
        self._s_sum += s.sent_bytes
        self._r_sum += s.recv_bytes

    def _avg(self, total: float) -> float:
        return total / len(self.tokens) if self.tokens else 0.0

    @property
    def avg_generation_ms(self):
        return self._avg(self._g_sum)

    @property
    def avg_inference_ms(self):
        return self._avg(self._i_sum)

    @property
    def avg_transfer_ms(self):
        return self._avg(self._t_sum)

    @property
    def avg_sent_bytes(self):
        return self._avg(self._s_sum)

    @property
    def avg_recv_bytes(self):
        return self._avg(self._r_sum)

    @property
    def tokens_per_second(self):
        g = self.avg_generation_ms
        return 1000.0 / g if g > 0 else 0.0


class Landing:
    """A dispatch's sampled ids (a device tensor) on their way to the host.
    On CUDA: an event right after the dispatch's last op, then a
    non-blocking copy into pinned memory and an event after it, enqueued
    at once, before any later work; :meth:`wait` blocks on these two
    events alone.  On the CPU the ids are already there (copied, as a
    later step may reuse their storage)."""

    __slots__ = ("_done", "_copied", "_host")

    def __init__(self, ids: torch.Tensor):
        if ids.is_cuda:
            stream = torch.cuda.current_stream(ids.device)
            self._done = torch.cuda.Event()
            self._done.record(stream)
            self._host = torch.empty(ids.shape, dtype=ids.dtype, pin_memory=True)
            self._host.copy_(ids, non_blocking=True)
            self._copied = torch.cuda.Event()
            self._copied.record(stream)
        else:
            self._done = self._copied = None
            self._host = ids.clone()

    def wait(self) -> tuple[float, float, np.ndarray]:
        """Block until the ids are on the host: returns the host clock when
        the dispatch had run, when its ids had arrived, and the ids."""
        if self._done is not None:
            self._done.synchronize()
        t1 = time.perf_counter()
        if self._copied is not None:
            self._copied.synchronize()
        return t1, time.perf_counter(), self._host.numpy()


class _Ready:
    """A host array that is already there (a CPU engine's page read)."""

    __slots__ = ("_a",)

    def __init__(self, a):
        self._a = a

    def wait(self) -> np.ndarray:
        return self._a


class _Copied:
    """A pinned host tensor being filled on a side stream; :meth:`wait`
    blocks on the copy's event (under the engine's watchdog) and returns it
    as a host array."""

    __slots__ = ("_host", "_done", "_engine")

    def __init__(self, host: torch.Tensor, done, engine: "Engine"):
        self._host = host
        self._done = done
        self._engine = engine

    def wait(self) -> np.ndarray:
        self._engine._sync(self._done.synchronize, "page copy", point=None)
        return snapfmt.to_numpy(self._host)


def record_rng_kind(extra: dict, arrays: dict) -> str | None:
    """The generator kind a snapshot or record's draws came from: the
    port's records name it; the JAX package's carry a threefry key."""
    if extra.get("rng_kind"):
        return str(extra["rng_kind"])
    return "jax-threefry" if "rng_key" in arrays else None


def on_device(device: torch.device):
    """Make ``device`` the current CUDA device for the block (work issued
    from a thread other than the one that made the engine names its
    card); a no-op on the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class Engine:
    """Owns the params on the device, the KV cache, the position and the
    sampling generator.  ``device`` defaults to ``cuda`` (see
    :mod:`dllama_tpu_torch.device`).

    ``batch`` > 1 makes a slot engine for :meth:`slot_step_async`: each
    row is a slot with its own clock.  ``kv_pages`` > 0 replaces its
    per-row contiguous cache with a paged pool of that many
    ``kv_page_size``-token pages (page 0 is scratch), addressed through
    per-slot page tables; ``kv_dtype="q8"`` stores the pool (or the
    contiguous cache) in int8 with per-position scales; a slot engine
    refuses a contiguous int8 cache, as the JAX package does.  Params
    already on ``device`` are shared, not copied, so a slot engine built
    from a batch-1 engine's params adds only its cache.  With a contiguous cache, ``batch`` > 1 also serves
    :meth:`generate_batch` (distinct prompts in lockstep).

    ``DLLAMA_Q40_LAYOUT=blocked`` (the JAX package's knob) converts every
    2-D and layer-stacked Q40 weight to the tile-contiguous layout before
    the upload (:func:`q40.blocked_params`; idempotent), so their matmuls
    run kernel 3.

    ``mesh`` (a :class:`parallel.mesh.Mesh` of more than one rank) slices
    the params over its ranks (``parallel.sharding.place_params``; a
    ``Placed`` made for the same mesh is shared) and gives every rank at
    expert shard 0 its own cache or pool of ``n_kv_heads/tp`` heads,
    ``batch/dp`` rows and ``seq_len/sp`` positions (:class:`ShardedKV`);
    ``device`` is then rank 0's, where logits land and sampling runs.  The
    blocked layout is single-device, as in the JAX package: on a mesh the
    weights stay row-major, with a warning.  The JAX Engine's refusals of
    the mesh's axes hold: sp needs a seq_len it divides and a dense,
    contiguous cache, and refuses ragged batches, slot serving, scoring and
    speculative decoding; ep needs a MoE model whose experts it divides.
    ``batch`` must divide over dp; a paged pool over dp is not yet ported.
    A from-scratch prefill on an sp mesh whose width sp divides runs ring
    attention (``cfg.ring_prefill``).

    ``graphs`` (default: on for ``cuda`` at tp = 1) replays the decode
    steps of :meth:`decode` and every slot dispatch, pure decode and mixed,
    as captured CUDA graphs (:mod:`runtime.graphs`, kept in
    :attr:`graphs`; None runs every step eagerly).  It needs ``cuda`` and
    tp = 1; the batch-1 and lockstep prefill forwards and tp > 1 run
    eagerly.

    A ``mesh`` that spans processes gives the engine its local ranks only
    (``params`` may be the ``Placed`` that ``models.params.load_placed``
    read) and reserves its largest forward's rows (batch × seq_len, × the
    active experts of a MoE model) for kernel 4's communication region.

    ``step_timeout`` (seconds; default ``DLLAMA_STEP_TIMEOUT``, else off)
    and ``numeric_checks`` (default ``DLLAMA_NUMERIC_CHECKS``, else off):
    see :meth:`_sync` and :meth:`_numeric_guard`."""

    def __init__(self, cfg: ModelConfig, params: Params | Placed,
                 seq_len: int | None = None, kv_dtype=None, device=None,
                 batch: int = 1, kv_pages: int = 0, kv_page_size: int = 16,
                 mesh: Mesh | None = None, graphs: bool | None = None,
                 step_timeout: float | None = None, numeric_checks: bool | None = None):
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        #: the process group of a mesh that spans processes, else None
        self.group = mesh.group if mesh is not None and mesh.multi else None
        #: the tokens this engine picked or received (a multi-process check)
        self._stream_hash, self._stream_tokens = hashlib.sha256(), 0
        # the step watchdog (StepTimeout) and the logits guard
        # (NumericFault); the environment arms them on a live server
        if step_timeout is None:
            step_timeout = float(os.environ.get("DLLAMA_STEP_TIMEOUT", "0"))
        self.step_timeout = step_timeout if step_timeout > 0 else None
        if numeric_checks is None:
            numeric_checks = os.environ.get("DLLAMA_NUMERIC_CHECKS", "") not in (
                "", "0", "false")
        self.numeric_checks = bool(numeric_checks)
        self.device = resolve(mesh.device if mesh is not None else device)
        self.cfg = cfg
        self.batch = int(batch)
        self.seq_len = min(seq_len or cfg.seq_len, cfg.seq_len)
        # the JAX Engine's refusals of the mesh's axes (its messages)
        if self.sp > 1 and self.seq_len % self.sp:
            raise ValueError(f"seq_len {self.seq_len} not divisible by sp={self.sp}")
        check_ep_constraint(cfg, self.ep)
        if self.batch % self.dp:
            raise ValueError(f"batch {self.batch} does not shard over dp={self.dp}")
        if self.group is not None:
            self.group.reserve_rows(self.batch * self.seq_len
                                    * (cfg.n_active_experts if cfg.is_moe else 1))
        if os.environ.get("DLLAMA_Q40_LAYOUT", "") == "blocked":
            if self.mesh is None:
                params = q40.blocked_params(params)
            else:
                q40._warn_once(f"DLLAMA_Q40_LAYOUT=blocked is ignored on a tp={self.tp} "
                               "mesh: blocked storage is single-device; the weights "
                               "stay row-major, which slices over the ranks")
        if self.mesh is None:
            self.params = to_device(params, self.device)
        elif isinstance(params, Placed):
            if params.mesh != self.mesh:
                raise ValueError(f"params placed over {params.mesh}, engine mesh {self.mesh}")
            self.params = params
        else:
            self.params = place_params(params, cfg, self.mesh)
        # "q8" (or int8, a quantized engine's own cache dtype) selects int8
        # values with per-position f32 scales
        kv_quant = kv_dtype == "q8" or kv_dtype == torch.int8
        if kv_quant and self.sp > 1:
            raise ValueError("quantized KV cache is not supported on sp "
                             "meshes (shard-local sp cache writes are "
                             "dense); use sp=1 or a dense cache dtype")
        self.paged = kv_pages > 0
        self.kv_pages = int(kv_pages)
        self.kv_page_size = int(kv_page_size)
        if self.paged:
            if self.sp > 1:
                raise ValueError("paged KV is not supported on sp meshes "
                                 "(sequence-sharded pools are not wired)")
            if self.dp > 1:
                raise ValueError(f"a paged KV pool over dp={self.dp} is not yet ported to "
                                 "dllama_tpu_torch (its pages would ride the dp axis)")
            if self.kv_pages < 2:
                raise ValueError("kv_pages must be >= 2 (page 0 is the "
                                 "reserved scratch page)")
            if self.kv_page_size < 1:
                raise ValueError(f"kv_page_size must be >= 1, got {self.kv_page_size}")
            # per-slot table width: enough logical pages to cover seq_len
            self.max_pages_per_slot = -(-self.seq_len // self.kv_page_size)
            self.cache = self._per_rank(lambda dev, tp: init_kv_pool(
                cfg, self.kv_pages, self.kv_page_size, dtype=None if kv_quant else kv_dtype,
                quant=kv_quant, device=dev, tp=tp))
            # a mixed slot step reads the pool through the prefill kernel:
            # refuse a pool it cannot read now, not on the first prompt
            self.check_prefill_read()
        else:
            self.cache = self._per_rank(lambda dev, tp: init_kv_cache(
                cfg, self.batch // self.dp, self.seq_len // self.sp,
                dtype=None if kv_quant else kv_dtype, quant=kv_quant, device=dev, tp=tp))
        self.pos = 0
        #: a ragged batch's left padding (B,) on the device, set by
        #: prefill_ragged and cleared by reset
        self.offsets: torch.Tensor | None = None
        #: model forwards run (prefill passes + decode steps)
        self.forwards = 0
        #: single-token forwards of slot dispatches (each reads attention
        #: once per layer through the decode route)
        self.slot_decode_forwards = 0
        #: slot verify forwards (speculative decoding; t > 1 a row, so a
        #: paged pool is read through the prefill kernel)
        self.verify_forwards = 0
        #: the newest prompt-lookup run's windows verified, drafts proposed
        #: and drafts accepted (:meth:`pld_windows`)
        self.pld_stats = {"windows": 0, "proposed": 0, "accepted": 0}
        #: enqueue-to-ready ms of the newest landed slot dispatch
        self.last_slot_dispatch_ms = 0.0
        #: logits (B, V) of the newest forward, left on the device
        self.last_logits: torch.Tensor | None = None
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(0)
        #: which sampler draws this engine's sampled tokens; rides snapshots
        #: and hand-off records (the JAX package's default name: its draws
        #: are made on the device too)
        self.sampling_path = "device"
        #: arrays of the newest :meth:`restore` that were the caller's
        #: ``extra_arrays`` (the paged scheduler's page tables)
        self.restored_arrays: dict = {}
        self._copy_stream = None  # side stream of read_pool_pages_async
        if self.paged:
            obs_metrics.KV_PAGE_CODEC.set(
                "int8" if kv_quant else snapfmt.dtype_of(self.cache.k.dtype), 1)
        if graphs is None:
            graphs = self.device.type == "cuda" and self.mesh is None
        if graphs and (self.device.type != "cuda" or self.mesh is not None):
            raise ValueError(f"CUDA graphs need a cuda engine at tp = 1, not {self.device} "
                             f"at tp = {self.tp}")
        #: the decode-step graph cache (runtime.graphs); None: every step eager
        self.graphs: DecodeGraphs | None = DecodeGraphs(self.device) if graphs else None

    def check_prefill_read(self) -> None:
        """Raise when a paged engine on the card could not run its slot
        steps: the paged kernels read f32, bf16, f16 and int8 pools at any
        step width (:func:`attention.check_prefill_config`: a head dim that
        is not a multiple of 16 up to 256 has no body, since TMA copies rows
        of multiples of 16 bytes and wgmma's k is 16) unless ``attn_impl``
        is ``"plain"``.  A contiguous or CPU engine takes any pool."""
        if self.paged and self.device.type == "cuda" and self.cfg.attn_impl != "plain":
            attention.check_prefill_config(self.cache.k.dtype, self.cfg.head_size)

    @property
    def tp(self) -> int:
        return 1 if self.mesh is None else self.mesh.tp

    @property
    def sp(self) -> int:
        return 1 if self.mesh is None else self.mesh.sp

    @property
    def dp(self) -> int:
        return 1 if self.mesh is None else self.mesh.dp

    @property
    def ep(self) -> int:
        return 1 if self.mesh is None else self.mesh.ep

    def _pick(self, logits: torch.Tensor | None, temperature: float, topp: float,
              rows: int) -> torch.Tensor:
        """The next token of each of ``rows`` rows (int32 on the engine's
        device), sampled on the device.  Over a process group process 0
        samples its gathered ``logits`` and broadcasts the ids; the other
        processes (``logits`` None) receive them.  Every id goes into the
        stream hash (:meth:`check_agreement`)."""
        if self.group is None:
            return device_sample(logits, self._gen, temperature, topp)
        if self.group.index == 0:
            tok = device_sample(logits, self._gen, temperature, topp)
        else:
            tok = torch.zeros((rows,), dtype=torch.int32, device=self.device)
        tok = self.group.broadcast(tok)
        self._stream_hash.update(tok.cpu().numpy().astype(np.int32).tobytes())
        self._stream_tokens += rows
        return tok

    def check_agreement(self) -> None:
        """Over a process group: raise on every process unless every
        process picked or received the same token stream (its hash and
        length); a no-op in one process."""
        if self.group is not None:
            self.group.agree((self._stream_tokens, self._stream_hash.hexdigest()),
                             "the token stream (count, sha256)")

    def _one_process(self, what: str) -> None:
        if self.group is not None:
            raise ValueError(f"{what} runs in one process; this engine's mesh spans "
                             f"{self.group.count} processes")

    def _per_rank(self, make):
        """``make(device, tp)`` once (one device), or once a rank at expert
        shard 0 (the ranks that attend), in rank order."""
        if self.mesh is None:
            return make(self.device, 1)
        m = self.mesh
        return ShardedKV(tuple(make(dev, self.tp) for r, dev in zip(m.ranks, m.devices)
                               if m.coords(r)[2] == 0))

    def _kv_coords(self) -> list[tuple[int, int, int]]:
        """Each cache rank's (d, s, t), in :attr:`cache`'s order."""
        if self.mesh is None:
            return [(0, 0, 0)]
        return [(d, s, t) for d, s, e, t in map(self.mesh.coords, self.mesh.ranks) if e == 0]

    def reset(self):
        """Restart the sequence; cache memory is reused."""
        self.pos = 0
        self.offsets = None

    # -- state snapshot and restore (runtime/snapshot.py) ---------------
    @property
    def rng_kind(self) -> str:
        """The generator this engine's sampled draws come from; a sampled
        stream continues only on an engine of the same kind (the JAX
        package's records carry a threefry key: ``jax-threefry``)."""
        return f"torch-{self.device.type}"

    def kv_planes(self) -> dict[str, list[torch.Tensor]]:
        """The cache's (or pool's) planes by name, one tensor a rank:
        ``k``, ``v``, and for int8 the ``k_scale``/``v_scale`` planes."""
        ranks = self.cache.ranks if isinstance(self.cache, ShardedKV) else (self.cache,)
        names = ("k", "v") + (("k_scale", "v_scale") if self.cache.quantized else ())
        return {n: [getattr(r, n) for r in ranks] for n in names}

    def kv_layout(self) -> dict[str, tuple[str, list[int]]]:
        """Each plane's dtype name and global shape: a rank holds
        ``n_kv_heads/tp`` of the heads on axis 2 (``batch/dp`` rows on axis
        1, ``seq_len/sp`` positions on axis 3), so the mesh never shows (a
        snapshot or record taken at one tp restores at another)."""
        out = {}
        for n, ts in self.kv_planes().items():
            shape = list(ts[0].shape)
            shape[1] *= self.dp
            shape[2] *= len(ts) // (self.dp * self.sp)
            shape[3] *= self.sp
            out[n] = (snapfmt.dtype_of(ts[0].dtype), shape)
        return out

    def _global(self, ts: list[torch.Tensor]) -> torch.Tensor:
        """One plane's ranks joined on the engine's device: heads (axis 2)
        over tp, positions (axis 3) over sp, rows (axis 1) over dp."""
        if len(ts) == 1:
            return ts[0]
        at = {c: t.to(self.device) for c, t in zip(self._kv_coords(), ts)}
        tps = sorted({c[2] for c in at})
        return torch.cat([torch.cat([torch.cat([at[(d, s, t)] for t in tps], dim=2)
                                     for s in range(self.sp)], dim=3)
                          for d in range(self.dp)], dim=1)

    def config_fingerprint(self) -> str:
        """Digest of everything that must match for a snapshot to mean
        something here: the model's hyperparameters, batch, context and the
        cache's dtype names and global shapes, and the pool geometry (page
        ids are physical).  The JAX package's fields and dtype names
        (``bfloat16``, ``int8``, ``float32``), so the digests agree; the
        mesh is left out."""
        return snapfmt.fingerprint(dict(
            self._model_fields(), batch=self.batch, seq_len=self.seq_len,
            cache=[[f"cache.{n}", dt, shape] for n, (dt, shape) in self.kv_layout().items()],
            paged=[self.kv_pages, self.kv_page_size] if self.paged else None))

    def handoff_fingerprint(self) -> str:
        """Geometry digest for a per-request hand-off: the model, the
        context window and the page's dtype and shape (Hkv, ps, Dh) with its
        codec; batch width and pool size are left out (the importer
        allocates its own pages), and so is the mesh."""
        if not self.paged:
            raise ValueError("per-request hand-off needs a paged KV cache (kv_pages > 0)")
        dt, shape = self.kv_layout()["k"]
        return snapfmt.fingerprint(dict(
            self._model_fields(), seq_len=self.seq_len, page=[dt, shape[2:]],
            codec="int8" if self.cache.quantized else "dense", handoff=1))

    def _model_fields(self) -> dict:
        """The model's hyperparameters, as both fingerprints hash them."""
        c = self.cfg
        return {k: getattr(c, k) for k in (
            "arch", "dim", "hidden_dim", "n_layers", "n_heads", "n_kv_heads", "n_experts",
            "n_active_experts", "vocab_size", "hidden_act", "rope_theta")}

    def rng_arrays(self) -> dict[str, np.ndarray]:
        """The generator's state as a record array (``rng_state``)."""
        return {"rng_state": self._gen.get_state().numpy().copy()}

    def set_rng(self, state_np) -> None:
        """Rebase the generator from a record's ``rng_state``: a sampled
        stream continues where the exporter stopped."""
        self._gen.set_state(torch.from_numpy(np.array(state_np, np.uint8)))

    def snapshot(self, path, extra: dict | None = None,
                 extra_arrays: dict | None = None) -> str:
        """Write the engine's state (the cache or pool, ``pos``, the ragged
        ``offsets``, the generator) to a DLSNAP02 file, atomically;
        ``extra`` (JSON) and ``extra_arrays`` come back from
        :meth:`restore` (the latter in :attr:`restored_arrays`).  Returns
        the path."""
        with on_device(self.device):
            arrays = {f"cache.{n}": snapfmt.to_numpy(self._global(ts))
                      for n, ts in self.kv_planes().items()}
        arrays.update(self.rng_arrays())
        meta_extra = dict(extra or {})
        meta_extra.setdefault("sampling_path", self.sampling_path)
        meta_extra.setdefault("rng_kind", self.rng_kind)
        if self.offsets is not None:
            arrays["offsets"] = self.offsets.cpu().numpy()
            meta_extra["has_offsets"] = True
        for n, a in (extra_arrays or {}).items():
            if n in arrays:
                raise ValueError(f"extra array name {n!r} collides")
            arrays[n] = np.asarray(a)
        return snapfmt.save(path, fingerprint=self.config_fingerprint(), pos=self.pos,
                            chunk_counter=0, arrays=arrays, extra=meta_extra)

    def restore(self, path) -> dict:
        """Restore the state :meth:`snapshot` saved, writing the cache in
        place (captured graphs keep reading the same tensors: no capture
        follows).  Raises :class:`ArtifactError` on a corrupt file and
        :class:`snapshot.SnapshotMismatch` on one from an engine of another
        shape, before touching anything.  The generator is restored when
        the file's came from an engine of the same :attr:`rng_kind` (else
        it is reseeded with 0: a greedy stream continues exactly, a sampled
        one on fresh draws).  Returns the file's ``extra``."""
        meta, arrays = snapfmt.load(path)
        want = self.config_fingerprint()
        if meta["fingerprint"] != want:
            raise snapfmt.SnapshotMismatch(
                path, "fingerprint", "snapshot is from a differently-configured engine",
                expected=want, got=meta["fingerprint"])
        layout = self.kv_layout()
        for n, (dt, shape) in layout.items():
            arr = arrays.get(f"cache.{n}")
            if arr is None:
                raise snapfmt.SnapshotMismatch(path, f"array 'cache.{n}'",
                                               "missing cache array")
            if list(arr.shape) != shape or snapfmt.dtype_name(arr) != dt:
                raise snapfmt.SnapshotMismatch(
                    path, f"array 'cache.{n}'", "cache array layout mismatch",
                    expected=f"{dt}{tuple(shape)}",
                    got=f"{snapfmt.dtype_name(arr)}{tuple(arr.shape)}")
        pos = int(meta["pos"])
        if not 0 <= pos <= self.seq_len:
            raise snapfmt.SnapshotMismatch(
                path, "pos", "restored position outside the context window",
                expected=f"0..{self.seq_len}", got=pos)
        extra = dict(meta.get("extra", {}))
        snap_sp = extra.get("sampling_path")
        if snap_sp is not None and snap_sp != self.sampling_path:
            raise snapfmt.SnapshotMismatch(
                path, "sampling_path", "snapshot sampled on a different sampling path",
                expected=self.sampling_path, got=snap_sp)
        with on_device(self.device):
            for n, ts in self.kv_planes().items():
                self._write_global(ts, arrays[f"cache.{n}"], None)
        self.pos = pos
        if record_rng_kind(extra, arrays) == self.rng_kind and "rng_state" in arrays:
            self.set_rng(arrays["rng_state"])
        else:
            self._gen.manual_seed(0)
        self.offsets = upload(arrays["offsets"], torch.int64, self.device) \
            if extra.get("has_offsets") else None
        known = {f"cache.{n}" for n in layout} | {"rng_state", "rng_key", "rng_dev_key",
                                                   "offsets"}
        self.restored_arrays = {n: a for n, a in arrays.items() if n not in known}
        bump_counter("snapshot_restores")
        return extra

    # -- pages of the pool on their way off the card and back -----------
    def _write_global(self, ranks: list[torch.Tensor], arr: np.ndarray, idx) -> None:
        """Write the global array ``arr`` into one plane in place: the whole
        plane (``idx`` None) or its pages ``idx`` (a device index on axis
        1); a rank takes its heads' slice of axis 2 (and of a whole plane,
        its rows' of axis 1 and its positions' of axis 3)."""
        src = snapfmt.to_torch(arr, ranks[0].dtype)
        tps = sorted({c[2] for c in self._kv_coords()})
        for dst, (d, s, t) in zip(ranks, self._kv_coords()):
            b, h, n = dst.shape[1], dst.shape[2], dst.shape[3]
            h0 = tps.index(t) * h
            part = src[:, :, h0:h0 + h] if len(ranks) > 1 else src
            if idx is None and len(ranks) > 1:
                part = part[:, d * b:(d + 1) * b, :, s * n:(s + 1) * n]
            if idx is None:
                dst.copy_(part)
            else:
                dst.index_copy_(1, idx.to(dst.device), part.to(dst.device))

    def read_pool_pages(self, pages) -> dict[str, np.ndarray]:
        """Copy the physical pages ``pages`` of the pool to the host, every
        layer at once: ``pages.k``/``pages.v`` of shape (L, n, Hkv, ps, Dh)
        (the ranks' heads joined on axis 2), and for an int8 pool the
        (L, n, Hkv, ps, 1) f32 ``pages.k_scale``/``pages.v_scale``."""
        return {k: h.wait() for k, h in self.read_pool_pages_async(pages).items()}

    def read_pool_pages_async(self, pages) -> dict:
        """Start the copies of :meth:`read_pool_pages`; returns ``{name:
        handle}``, ``handle.wait()`` the host array.  On the card the pages
        are gathered on the engine's stream, behind whatever is queued
        there, an event is recorded, and a side stream waits on it and
        copies the gather into pinned host memory; ``wait()`` blocks on that
        copy's own event.  The caller frees or reuses the pages only after
        ``wait()``, so no later write can reach them before the copy
        lands."""
        if not self.paged:
            raise ValueError("read_pool_pages needs a paged engine")
        dev = self.device
        with on_device(dev):
            idx = upload(np.asarray(pages, np.int64), torch.int64, dev)
            gathered = {}
            for n, ts in self.kv_planes().items():
                parts = [t.index_select(1, idx.to(t.device)) for t in ts]
                gathered[f"pages.{n}"] = parts[0] if len(parts) == 1 else torch.cat(
                    [p.to(dev) for p in parts], dim=2)
            if dev.type != "cuda":
                return {n: _Ready(snapfmt.to_numpy(g)) for n, g in gathered.items()}
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(dev))
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(dev)
            side = self._copy_stream
            out = {}
            with torch.cuda.stream(side):
                side.wait_event(ready)
                for n, g in gathered.items():
                    host = torch.empty(g.shape, dtype=g.dtype, pin_memory=True)
                    host.copy_(g, non_blocking=True)
                    # the gather's memory returns to the allocator only
                    # once the side stream's copy has read it
                    g.record_stream(side)
                    out[n] = host
                done = torch.cuda.Event()
                done.record(side)
        return {n: _Copied(h, done, self) for n, h in out.items()}

    def write_pool_pages(self, pages, arrays: dict[str, np.ndarray]) -> None:
        """Write page slices (from :meth:`read_pool_pages` here or on a
        peer, at any tp) into the pool at the physical pages ``pages``, in
        place (``index_copy_``): the captured graphs read the same tensors,
        so nothing is captured again.  Every plane of the pool must be
        given."""
        if not self.paged:
            raise ValueError("write_pool_pages needs a paged engine")
        with on_device(self.device):
            idx = upload(np.asarray(pages, np.int64), torch.int64, self.device)
            for n, ts in self.kv_planes().items():
                self._write_global(ts, arrays[f"pages.{n}"], idx)

    def _sync(self, wait, what: str, point: str | None = "engine.device_step"):
        """Run ``wait`` — a blocking edge of a device step — after firing
        ``point`` (the ``engine.device_step`` fault point); returns ``(the
        actions that ask the caller to transform its value, wait's
        result)``.  With ``step_timeout`` set the two run on a watchdog
        thread, and a wait that outlives the deadline raises
        :class:`StepTimeout`; the helper stays parked (a daemon), since a
        wait on the card cannot be cancelled.  Unset, this adds no wait
        and no thread."""
        def run():
            actions = FAULTS.fire(point) if point else []
            return actions, wait()

        if not self.step_timeout:
            return run()
        box: dict = {}

        def watched():
            try:
                box["out"] = run()
            except BaseException as e:  # re-raised below, on the caller
                box["error"] = e

        t = threading.Thread(target=watched, daemon=True,
                             name=f"dllama-step-watchdog({what})")
        t.start()
        t.join(self.step_timeout)
        if t.is_alive():
            raise StepTimeout(
                f"{what} did not become ready within {self.step_timeout}s "
                f"(pos={self.pos}, batch={self.batch}, device={self.device}, tp={self.tp})")
        if "error" in box:
            raise box["error"]
        return box["out"]

    def _numeric_guard(self, host_logits: np.ndarray, step: str) -> np.ndarray:
        """Check a host-fetched logits array for NaN/Inf under
        ``numeric_checks`` (:class:`NumericFault`), after firing the
        ``engine.numeric`` fault point (its ``nan`` action poisons the
        checked array).  Off, it returns the array untouched."""
        if not self.numeric_checks:
            return host_logits
        if "nan" in FAULTS.fire("engine.numeric"):
            host_logits = np.full_like(host_logits, np.nan)
        if not np.isfinite(host_logits).all():
            bump_counter("numeric_faults")
            bad = int(np.size(host_logits) - np.count_nonzero(np.isfinite(host_logits)))
            raise NumericFault(
                step, self.pos,
                hint=f"{bad}/{host_logits.size} non-finite logits; detection is at the "
                     "output logits (no layer attribution) — bisect with "
                     "--verify-weights and a bf16 KV cache")
        return host_logits

    def _run(self, tokens_np: np.ndarray, last_index: int,
             offsets: torch.Tensor | None = None) -> tuple[np.ndarray, StepStats]:
        stats = StepStats()
        t0 = time.perf_counter()
        toks = torch.from_numpy(tokens_np).to(self.device)
        # a from-scratch prefill on an sp mesh: ring attention over the
        # window's tokens cut over the shards (the JAX Engine's choice)
        t = tokens_np.shape[1]
        use_ring = self.sp > 1 and self.pos == 0 and t > 1 and t % self.sp == 0
        cfg = self.cfg.with_(ring_prefill=True) if use_ring else self.cfg
        logits, self.cache = forward_last(self.params, cfg, toks, self.cache,
                                          self.pos, last_index, offsets=offsets)
        self.forwards += 1
        fired = self._sync(lambda: synchronize(self.device), "prefill/decode step")[0]
        t1 = time.perf_counter()
        if "nan" in fired and logits is not None:  # injected device fault
            logits = torch.full_like(logits, float("nan"))
        self.last_logits = logits
        # a worker process other than 0 gathers no logits (None)
        host_logits = None if logits is None else self._numeric_guard(
            logits.cpu().numpy(), "prefill" if tokens_np.shape[1] > 1 else "decode")  # (B, V)
        t2 = time.perf_counter()
        stats.inference_ms = (t1 - t0) * 1000
        stats.transfer_ms = (t2 - t1) * 1000
        stats.generation_ms = (t2 - t0) * 1000
        stats.sent_bytes = tokens_np.nbytes + 8  # token ids + pos/last scalars
        stats.recv_bytes = 0 if host_logits is None else host_logits.nbytes
        obs_trace.record("prefill" if tokens_np.shape[1] > 1 else "decode_step", t0, t2,
                         pos=self.pos, n_tokens=int(tokens_np.shape[1]))
        _observe(stats, stats.sent_bytes, stats.recv_bytes)
        return host_logits, stats

    def prefill(self, prompt_tokens: list[int]) -> tuple[np.ndarray, StepStats]:
        """Process the whole prompt; returns logits for its last token."""
        n = len(prompt_tokens)
        if n == 0:
            raise ValueError("empty prompt")
        if self.pos + n > self.seq_len:
            raise ContextOverflow(
                f"prompt of {n} exceeds seq_len {self.seq_len} at pos {self.pos}")
        # the padded bucket must also fit the cache
        bucket = max(n, min(_next_bucket(n), self.seq_len - self.pos))
        # every row the prompt (a dp mesh's replicas; the JAX package's rows)
        toks = np.zeros((self.batch, bucket), np.int64)
        toks[:, :n] = prompt_tokens
        logits, stats = self._run(toks, n - 1)
        self.pos += n
        return logits, stats

    def prefill_ragged(self, prompts: list[list[int]]) -> tuple[np.ndarray, StepStats]:
        """Prefill B distinct prompts, right-aligned in one bucket: every
        row's last real token lands on index ``longest - 1``, and
        ``offsets[r] = longest - len(prompt_r)`` is kept on the engine for
        every later decode step (per-row RoPE positions and key floors), so
        each row sees exactly the keys and angles it would see alone.  The
        batch shares one clock from ``longest``: a short row batched with a
        long one has ``longest - len(prompt_r)`` fewer context slots than it
        would alone.  Returns the (B, V) logits of the last index."""
        if len(prompts) != self.batch:
            raise ValueError(f"{len(prompts)} prompts for batch={self.batch}")
        if self.sp > 1:
            raise ValueError("ragged batches are not supported on sp meshes "
                             "(sequence-sharded cache); use sp=1")
        if self.paged:
            raise ValueError("ragged batches run on a contiguous cache (kv_pages=0)")
        if any(len(p) == 0 for p in prompts):
            raise ValueError("empty prompt")
        if self.pos != 0:
            raise ValueError("ragged prefill starts a fresh batch; call reset()")
        longest = max(len(p) for p in prompts)
        if longest > self.seq_len:
            raise ContextOverflow(f"prompt of {longest} exceeds seq_len {self.seq_len}")
        bucket = max(longest, min(_next_bucket(longest), self.seq_len))
        toks = np.zeros((self.batch, bucket), np.int64)
        offsets = np.zeros((self.batch,), np.int64)
        for r, p in enumerate(prompts):
            toks[r, longest - len(p):longest] = p
            offsets[r] = longest - len(p)
        self.offsets = torch.from_numpy(offsets).to(self.device)
        logits, stats = self._run(toks, longest - 1, offsets=self.offsets)
        self.pos = longest
        return logits, stats

    def decode_one(self, token: int) -> tuple[np.ndarray, StepStats]:
        """One autoregressive step at the current position."""
        if self.pos >= self.seq_len:
            raise ContextOverflow(f"position {self.pos} at seq_len limit {self.seq_len}")
        logits, stats = self._run(np.full((self.batch, 1), token, np.int64), 0)
        self.pos += 1
        return logits, stats

    def decode(self, token, steps: int, *, temperature: float, topp: float):
        """``steps`` decode steps from ``self.pos`` fed ``token`` (B,) — a
        device tensor, or host ids: every row samples its next token on the
        device (``temperature`` 0: the argmax; else one coin a row from the
        engine's generator), a ragged batch with its ``offsets``.  Enqueues
        the steps without waiting for them; returns (ids (steps, B), the
        last row (B,)) on the device, advances ``self.pos`` and leaves the
        last step's logits in ``last_logits``.  With :attr:`graphs` each
        step replays its captured graph, else
        :func:`decode_loop.decode_chunk` runs them."""
        p0 = self.pos
        with on_device(self.device):
            if self.graphs is not None:
                toks, last, logits = self.graphs.chunk(self, token, p0, steps,
                                                       temperature, topp)
            else:
                tok = token if isinstance(token, torch.Tensor) else \
                    upload(np.asarray(token), torch.int64, self.device)
                pick = None if self.group is None else \
                    (lambda lg: self._pick(lg, temperature, topp, tok.shape[0]))
                toks, self.cache, last, _, logits = decode_chunk(
                    self.params, self.cfg, self.cache, tok, p0, self._gen, steps=steps,
                    temperature=temperature, topp=topp, offsets=self.offsets, pick=pick)
        self.forwards += steps
        self.last_logits = logits
        self.pos = p0 + steps
        return toks, last

    def generate_stream(self, prompt_tokens: list[int], steps: int, *,
                        temperature: float = 0.0, topp: float = 0.9,
                        seed: int | None = 0, eos_ids: tuple[int, ...] = (),
                        chunk: int = 16):
        """Prefill, then decode on the device in chunks; yields
        ``(token_id, StepStats)``.  Prompt tokens are echoed first; the
        per-token stats of a chunk are the chunk averages.  ``seed=None``
        continues the engine's generator instead of reseeding it.

        Chunk N+1 is enqueued (fed the on-device last token) before chunk
        N's ids are fetched, and the fetch waits for chunk N alone
        (:class:`Landing`), so the host's Python work overlaps the device.
        An EOS inside a chunk rewinds the position past the unconsumed
        overshoot and returns the speculative chunk's random draws."""
        steps = min(steps, self.seq_len - self.pos)
        if seed is not None:
            self._gen.manual_seed(seed)

        _, pstats = self.prefill(prompt_tokens[:])
        for i, t in enumerate(prompt_tokens):
            yield t, pstats if i == len(prompt_tokens) - 1 else StepStats()
        produced = len(prompt_tokens)
        if produced >= steps:
            return
        token = int(self._pick(self.last_logits, temperature, topp, 1)[0])
        yield token, StepStats()  # prefill cost already attributed above
        produced += 1
        if token in eos_ids or produced >= steps or self.pos >= self.seq_len:
            return

        def dispatch(in_tok, done):
            k = min(chunk, steps - done, self.seq_len - self.pos)
            gen_state = self._gen.get_state()
            p0 = self.pos
            sent = 8 + (in_tok.nbytes if isinstance(in_tok, np.ndarray) else 0)
            t0 = time.perf_counter()
            toks_dev, last_dev = self.decode(in_tok, k, temperature=temperature, topp=topp)
            return k, p0, Landing(toks_dev), last_dev, t0, sent, gen_state

        pending = dispatch(np.full((self.batch,), token, np.int64), produced)
        expected = produced
        boundary = None
        try:
            while pending is not None:
                k, p0, landing, last_dev, t0, sent, _ = pending
                expected += k
                pending = dispatch(last_dev, expected) \
                    if expected < steps and self.pos < self.seq_len else None
                t1, t2, toks = self._sync(landing.wait, f"decode chunk at pos {p0}")[1]
                toks = toks[:, 0]  # (k,)
                # steady-state chunk wall = boundary to boundary
                g0 = t0 if boundary is None else max(boundary, t0)
                boundary = t2
                per = StepStats(generation_ms=(t2 - g0) * 1000 / k,
                                inference_ms=(t1 - g0) * 1000 / k,
                                transfer_ms=(t2 - t1) * 1000 / k,
                                sent_bytes=sent / k, recv_bytes=toks.nbytes / k)
                obs_trace.record("decode_chunk", g0, t2, pos=p0, k=k)
                _observe(per, sent, toks.nbytes)
                for j, tk in enumerate(toks.tolist()):
                    token = int(tk)
                    yield token, per
                    produced += 1
                    if token in eos_ids:
                        self.pos = p0 + j + 1
                        return
                    if produced >= steps:
                        return
        finally:
            # on EOS, or a consumer that abandons the generator: the
            # in-flight chunk is dead rows past the live position; give its
            # random draws back so a later turn's stream does not depend on
            # the pipelining
            if pending is not None:
                self._gen.set_state(pending[-1])

    def generate_batch(self, prompts: list[list[int]], steps: int, *,
                       temperature: float = 0.0, topp: float = 0.9,
                       seed: int | None = 0, eos_ids: tuple[int, ...] = (),
                       chunk: int = 16) -> list[list[int]]:
        """Decode B distinct prompts in lockstep (``batch`` = B): the decode
        matmuls read each weight once for all B rows.  Returns B token
        lists, each prompt followed by its continuation, cut per row at
        ``steps`` total tokens or the row's EOS.  Greedy rows equal the
        single-stream ``generate_stream`` output while the steps fit the
        shared clock (see :meth:`prefill_ragged`).  Rows that finish early
        keep decoding in lockstep, their tokens ignored, until every row is
        done: the batch is one-shot."""
        if steps <= 0:
            raise ValueError("steps must be positive")
        steps = min(steps, self.seq_len)
        outs = [list(p) for p in prompts]
        done = [len(o) >= steps for o in outs]
        for row_tokens in self.generate_batch_stream(
                prompts, steps, temperature=temperature, topp=topp, seed=seed,
                chunk=chunk):
            for r, t in enumerate(row_tokens.tolist()):
                if done[r]:
                    continue
                outs[r].append(int(t))
                if int(t) in eos_ids or len(outs[r]) >= steps:
                    done[r] = True
            if all(done):
                break
        return outs

    def generate_batch_stream(self, prompts: list[list[int]], steps: int, *,
                              temperature: float = 0.0, topp: float = 0.9,
                              seed: int | None = 0, chunk: int = 16):
        """The lockstep core of :meth:`generate_batch`: yields one (B,)
        int array per decoded step, every row's sampled token, as each
        on-device chunk lands; ``steps`` yields at most, or the context
        window.  EOS and length are the consumer's.  Chunk N+1 is enqueued
        on the device-carried last row before chunk N is fetched, and the
        fetch waits for chunk N alone (depth-1 pipelining, as
        :meth:`generate_stream`); a consumer that stops early gets the
        speculative chunk's random draws returned."""
        if steps <= 0:
            raise ValueError("steps must be positive")
        if seed is not None:
            self._gen.manual_seed(seed)
        self.prefill_ragged(prompts)
        tok_vec = self._pick(self.last_logits, temperature, topp, self.batch)
        yield tok_vec.cpu().numpy()

        def dispatch(in_tok, done):
            k = min(chunk, steps - done, self.seq_len - self.pos)
            gen_state = self._gen.get_state()
            toks_dev, last_dev = self.decode(in_tok, k, temperature=temperature, topp=topp)
            return k, Landing(toks_dev), last_dev, gen_state

        expected = 1  # the prefill's sample is out
        if expected >= steps or self.pos >= self.seq_len:
            return
        pending = dispatch(tok_vec, expected)
        try:
            while pending is not None:
                k, landing, last_dev, _ = pending
                expected += k
                pending = dispatch(last_dev, expected) \
                    if expected < steps and self.pos < self.seq_len else None
                t0 = time.perf_counter()
                toks = self._sync(landing.wait, "batch decode chunk")[1][2]  # (k, B)
                obs_trace.record("decode_chunk", t0, time.perf_counter(),
                                 pos=self.pos - k, k=k, batch=True)
                for j in range(toks.shape[0]):
                    yield toks[j]
        finally:
            if pending is not None:
                self._gen.set_state(pending[-1])

    def slot_step_async(self, tokens_np: np.ndarray | None,
                        pos_rows_np: np.ndarray, n_valid_np: np.ndarray, *,
                        temps_np: np.ndarray, topps_np: np.ndarray,
                        topks_np: np.ndarray | None = None, steps: int = 1,
                        page_tables_np: np.ndarray | None = None,
                        feed_dev: torch.Tensor | None = None) -> "SlotDispatch":
        """Enqueue one continuous-batching dispatch without waiting for it:
        row ``r`` consumes its first ``n_valid_np[r]`` tokens of
        ``tokens_np`` (B, T) at its own positions ``pos_rows_np[r]..``,
        then ``steps - 1`` pure decode steps run on the device
        (:func:`decode_loop.slot_chunk`).  ``feed_dev`` (B,) replaces
        ``tokens_np`` with a prior dispatch's on-device last row, so the
        sampled tokens never visit the host on the input side.  A paged
        engine needs ``page_tables_np`` (B, max_pages) int32.  Sampled
        rows draw from the engine's generator.  With :attr:`graphs` on, a
        pure-decode dispatch (one token a row) replays the engine's
        slot-step graph, and a mixed step (t > 1) replays the mixed-step
        graph of its width, then the slot graph for its later steps.  The host
        arrays go up non-blocking and the ids come back through a
        :class:`Landing`, so an enqueue never waits for an earlier
        dispatch.  Does not touch
        ``self.pos``: the batch-1 path and the slot path may share an
        engine as long as their uses do not overlap in time (the
        scheduler's ``exclusive()``)."""
        self._one_process("the slot step")
        if self.sp > 1:
            raise ValueError("slot serving is not supported on sp meshes "
                             "(sequence-sharded cache); use sp=1")
        if self.cache.quantized and not self.paged:
            raise ValueError("slot serving needs a dense or paged-int8 KV "
                             "cache (contiguous per-row quantized writes "
                             "are not wired)")
        if self.paged and page_tables_np is None:
            raise ValueError("paged engine: slot_step needs page_tables_np")
        if not self.paged and page_tables_np is not None:
            raise ValueError("page tables passed to a contiguous engine")
        if feed_dev is not None:
            if tokens_np is not None:
                raise ValueError("feed_dev replaces tokens_np; pass one")
            t = 1
        elif tokens_np is None:
            raise ValueError("slot step needs tokens_np or feed_dev")
        else:
            t = int(tokens_np.shape[1])
        if steps < 1:
            raise ValueError("steps must be positive")
        # a write past seq_len would land outside a contiguous row (or
        # clamp into the scratch page) — refuse instead
        hi = max(int(np.max(pos_rows_np)) + t,
                 int(np.max(pos_rows_np + n_valid_np)) + (steps - 1))
        if hi > self.seq_len:
            raise ContextOverflow(
                f"slot step would write position {hi - 1} past seq_len "
                f"{self.seq_len}; retire rows at the context edge first")
        greedy = bool(np.all(temps_np == 0.0))
        if topks_np is None:
            topks_np = np.zeros(len(pos_rows_np), np.int32)
        dev = self.device

        def put(a, dt):
            return upload(np.asarray(a), dt, dev)

        t0 = time.perf_counter()
        with on_device(dev):
            if self.graphs is not None and t == 1:
                toks_dev, last_dev, logits = self.graphs.slot(
                    self, feed_dev, tokens_np, pos_rows_np, n_valid_np, temps_np, topps_np,
                    topks_np, steps, page_tables_np, greedy)
            elif self.graphs is not None:
                toks_dev, last_dev, logits = self.graphs.mixed(
                    self, tokens_np, pos_rows_np, n_valid_np, temps_np, topps_np,
                    topks_np, steps, page_tables_np, greedy)
            else:
                toks = (feed_dev.to(torch.int32)[:, None] if feed_dev is not None
                        else put(tokens_np, torch.int32))
                ptab = put(page_tables_np, torch.int32) if self.paged else None
                toks_dev, self.cache, last_dev, logits = slot_chunk(
                    self.params, self.cfg, self.cache, toks,
                    put(pos_rows_np, torch.int32), put(n_valid_np, torch.int32),
                    self._gen, put(temps_np, torch.float32),
                    put(topps_np, torch.float32), put(topks_np, torch.int32),
                    steps=steps, greedy=greedy, page_table=ptab)
            landing = Landing(toks_dev)
        self.forwards += steps
        self.slot_decode_forwards += steps if t == 1 else steps - 1
        self.last_logits = logits
        return SlotDispatch(self, landing, last_dev, t=t, steps=steps, enqueued_at=t0)

    def slot_step(self, tokens_np: np.ndarray, pos_rows_np: np.ndarray,
                  n_valid_np: np.ndarray, *, temps_np: np.ndarray,
                  topps_np: np.ndarray, topks_np: np.ndarray | None = None,
                  steps: int = 1, page_tables_np: np.ndarray | None = None
                  ) -> np.ndarray:
        """:meth:`slot_step_async`, then wait: the sampled ids (steps, B)."""
        return self.slot_step_async(
            tokens_np, pos_rows_np, n_valid_np, temps_np=temps_np,
            topps_np=topps_np, topks_np=topks_np, steps=steps,
            page_tables_np=page_tables_np).wait()

    def slot_verify_async(self, tokens_np: np.ndarray, pos_rows_np: np.ndarray,
                          n_valid_np: np.ndarray, *, temps_np: np.ndarray,
                          topps_np: np.ndarray, topks_np: np.ndarray | None = None,
                          page_tables_np: np.ndarray | None = None) -> "SlotVerifyDispatch":
        """Enqueue one ragged slot-verify dispatch (speculative decoding):
        row ``r`` feeds its previous sample and ``n_valid_np[r] - 1``
        drafts at positions ``pos_rows_np[r]..``; the landed result holds
        the model's prediction at every fed position and the count of
        leading drafts accepted (:func:`decode_loop.slot_verify_chunk`).
        A row with ``n_valid`` 1 rides as one plain decode step.  Rejected
        drafts wrote KV above their row's ceiling, dead under the causal
        mask (or in the scratch page when paged).  With :attr:`graphs` the
        step replays the graph of its width (``GraphKey("verify", B,
        greedy, T)``), whose outputs include the accepted counts and the
        last row; the host reads them after the landing.  ``last_dev`` on
        the handle stays on the device.  Slot clocks are the caller's;
        ``self.pos`` is untouched."""
        self._one_process("the slot step")
        if self.sp > 1:
            raise ValueError("slot serving is not supported on sp meshes "
                             "(sequence-sharded cache); use sp=1")
        if self.cache.quantized and not self.paged:
            raise ValueError("slot serving needs a dense or paged-int8 KV "
                             "cache (contiguous per-row quantized writes "
                             "are not wired)")
        if self.paged and page_tables_np is None:
            raise ValueError("paged engine: slot_verify needs page_tables_np")
        if not self.paged and page_tables_np is not None:
            raise ValueError("page tables passed to a contiguous engine")
        t = int(tokens_np.shape[1])
        if t < 2:
            raise ValueError("slot_verify needs T >= 2 (a previous sample "
                             "plus at least one proposal column)")
        if int(np.max(n_valid_np)) > t:
            raise ValueError("n_valid exceeds the verify window width")
        # every fed column writes KV at pos..pos+T-1, so the whole window
        # must fit, as slot_step_async refuses
        hi = int(np.max(pos_rows_np)) + t
        if hi > self.seq_len:
            raise ContextOverflow(
                f"slot verify would write position {hi - 1} past seq_len "
                f"{self.seq_len}; retire rows at the context edge first")
        greedy = bool(np.all(temps_np == 0.0))
        if topks_np is None:
            topks_np = np.zeros(len(pos_rows_np), np.int32)
        dev = self.device

        def put(a, dt):
            return upload(np.asarray(a), dt, dev)

        t0 = time.perf_counter()
        with on_device(dev):
            if self.graphs is not None:
                out_dev, last_dev, logits = self.graphs.verify(
                    self, tokens_np, pos_rows_np, n_valid_np, temps_np, topps_np,
                    topks_np, page_tables_np, greedy)
            else:
                preds, self.cache, accepted, last_dev, logits = slot_verify_chunk(
                    self.params, self.cfg, self.cache, put(tokens_np, torch.int32),
                    put(pos_rows_np, torch.int32), put(n_valid_np, torch.int32),
                    self._gen, put(temps_np, torch.float32), put(topps_np, torch.float32),
                    put(topks_np, torch.int32), greedy=greedy,
                    page_table=put(page_tables_np, torch.int32) if self.paged else None)
                out_dev = torch.cat([preds, accepted[:, None]], dim=1)
            landing = Landing(out_dev)
        self.forwards += 1
        self.verify_forwards += 1
        self.last_logits = logits
        return SlotVerifyDispatch(self, landing, last_dev, t=t, enqueued_at=t0)

    def generate_pld(self, prompt_tokens: list[int], steps: int, *, ngram: int = 2,
                     k: int = 7, eos_ids: tuple[int, ...] = ()) -> list[int]:
        """Greedy decode with prompt-lookup speculation: propose the ``k``
        tokens that followed the latest earlier occurrence of the current
        ``ngram`` suffix, verify the window in one ``T = k + 1`` forward and
        emit the accepted leading drafts plus the model's next token.  Every
        emitted token is an argmax at its position, so the stream is the
        plain greedy one wherever the two forwards' sums agree (on the card
        the window's matmuls take the tensor-core body at 9 rows and more,
        the decode step the decode body: a near-tie can resolve otherwise).
        Returns the prompt and the continuation, ``steps`` tokens at most."""
        return list(self.generate_pld_stream(prompt_tokens, steps, ngram=ngram, k=k,
                                             eos_ids=eos_ids))

    def generate_pld_stream(self, prompt_tokens: list[int], steps: int, *,
                            ngram: int = 2, k: int = 7, eos_ids: tuple[int, ...] = ()):
        """Generator core of :meth:`generate_pld`: yields the prompt echo,
        then each verified token as its window lands."""
        for toks, _ in self.pld_windows(prompt_tokens, steps, ngram=ngram, k=k,
                                        eos_ids=eos_ids):
            yield from toks

    def pld_windows(self, prompt_tokens: list[int], steps: int, *, ngram: int = 2,
                    k: int = 7, eos_ids: tuple[int, ...] = ()):
        """:meth:`generate_pld_stream` a window at a time: yields ``(tokens,
        StepStats)``, the prompt echo with the prefill's stats first, then
        each window's emitted tokens with that window's stats (per token:
        the window's wall over the tokens it emitted).  Batch-1, greedy and
        contiguous only (the JAX package's refusals).  With :attr:`graphs`
        each window replays the PLD graph of its width
        (``GraphKey("pld", 1, True, k + 1)``); the tail that no longer fits
        a window runs single-token steps (:meth:`decode_one`)."""
        self._one_process("prompt-lookup decoding")
        if self.sp > 1:
            raise ValueError("speculative decode is not supported on sp meshes")
        if self.batch != 1:
            raise ValueError("speculative decode is single-stream (batch=1)")
        if self.paged:
            raise ValueError("paged engine is slot-only; speculative decode "
                             "uses contiguous addressing")
        steps = min(steps, self.seq_len - self.pos)
        self.pld_stats = dict.fromkeys(self.pld_stats, 0)
        out = list(prompt_tokens)
        # latest-occurrence n-gram index, kept incrementally: value = the
        # position after the match; only positions <= len(out) - 1 are
        # indexed, so a lookup never matches the suffix against itself
        index: dict[tuple, int] = {}
        indexed = ngram - 1

        def extend_index():
            nonlocal indexed
            hi = len(out) - 1
            for p in range(max(indexed + 1, ngram), hi + 1):
                index[tuple(out[p - ngram:p])] = p
            indexed = max(indexed, hi)

        logits, pstats = self.prefill(prompt_tokens[:])
        yield list(out), pstats
        if len(out) >= steps:
            return  # the prompt always echoes whole
        cur = int(np.asarray(logits)[0].argmax())
        out.append(cur)
        yield [cur], StepStats()
        if cur in eos_ids:
            return

        def propose() -> list[int]:
            """The continuation after the latest earlier occurrence of the
            current suffix; zeros when none (wrong guesses verify short)."""
            if len(out) > ngram:
                i = index.get(tuple(out[-ngram:]))
                if i is not None:
                    cand = out[i:i + k]
                    return cand + [0] * (k - len(cand))
            return [0] * k

        while len(out) < steps and self.pos + k + 1 <= self.seq_len:
            extend_index()
            window = np.asarray([[cur] + propose()], np.int32)  # (1, k+1)
            p0 = self.pos
            t0 = time.perf_counter()
            with on_device(self.device):
                if self.graphs is not None:
                    packed = self.graphs.pld(self, window, p0)
                else:
                    toks = upload(window, torch.int64, self.device)
                    logits_all, self.cache = forward(self.params, self.cfg, toks,
                                                     self.cache, p0)
                    preds = torch.argmax(logits_all, dim=-1).to(torch.int32)
                    accepted, _ = verify_accept(
                        toks, preds, torch.full((1,), k + 1, dtype=torch.int32,
                                                device=self.device))
                    packed = torch.cat([preds, accepted[:, None]], dim=1)
                t1, t2, host = self._sync(Landing(packed).wait, "pld verify window")[1]
            self.forwards += 1
            preds_h, accepted = host[0, :k + 1], int(host[0, k + 1])
            self.pld_stats["windows"] += 1
            self.pld_stats["proposed"] += k
            self.pld_stats["accepted"] += accepted
            # every verified position's argmax is a true greedy token: the
            # accepted drafts plus the model's own next token
            emit = [int(x) for x in preds_h[:accepted + 1]]
            base = len(out)
            out.extend(emit)
            # the window's first accepted + 1 tokens join the sequence; rows
            # written past them are dead (the causal mask reads <= pos)
            self.pos = p0 + accepted + 1
            cur = emit[-1]
            for j, tk in enumerate(emit):
                if tk in eos_ids or base + j + 1 >= steps:
                    del out[base + j + 1:]
                    self.pos = p0 + j + 1
                    emit = emit[:j + 1]
                    break
            n = len(emit)
            stats = StepStats(generation_ms=(t2 - t0) * 1e3 / n,
                              inference_ms=(t1 - t0) * 1e3 / n,
                              transfer_ms=(t2 - t1) * 1e3 / n,
                              sent_bytes=window.nbytes / n, recv_bytes=host.nbytes / n)
            obs_trace.record("pld_window", t0, t2, pos=p0, k=k, accepted=accepted)
            _observe(stats, window.nbytes, host.nbytes)
            yield emit, stats
            if emit[-1] in eos_ids or len(out) >= steps:
                return
        # tail: single-token steps when a window no longer fits
        while len(out) < steps and self.pos < self.seq_len:
            logits, stats = self.decode_one(cur)
            cur = int(np.asarray(logits)[0].argmax())
            out.append(cur)
            yield [cur], stats
            if cur in eos_ids:
                break

    def score_batch(self, sequences: list[list[int]], top_k: int = 0
                    ) -> tuple[np.ndarray, np.ndarray | None, np.ndarray | None]:
        """Teacher-force B sequences through one left-padded ragged forward
        and return per-token log-probabilities (the API's ``logprobs``).

        Returns ``(token_lp, top_ids, top_lp)``: ``token_lp[r, j]`` is
        ``log P(sequences[r][j+1] | prefix)`` for ``j+1 < len(seq_r)``;
        rows are right-aligned in a bucketed width, so entry ``j`` lives at
        padded column ``token_lp.shape[1] - len(seq_r) + j`` and pad columns
        hold garbage (callers slice by their own lengths).  With ``top_k``
        the per-position top-k ids (int32) and log-probs come back too.
        The forward runs eagerly on a scratch cache of the engine's cache
        dtype (bf16 or f32; an int8 engine scores on a ``cfg.dtype``
        scratch, as the JAX package does), so the engine's own cache,
        position and graphs are untouched."""
        self._one_process("scoring")
        if self.sp > 1:
            raise ValueError("score_batch is not supported on sp meshes")
        if self.paged:
            raise ValueError("paged engine is slot-only; scoring needs a "
                             "contiguous scratch cache")
        if len(sequences) != self.batch:
            raise ValueError(f"{len(sequences)} sequences for batch={self.batch}")
        if any(len(s) < 2 for s in sequences):
            raise ValueError("scoring needs ≥2 tokens per sequence")
        longest = max(len(s) for s in sequences)
        if longest > self.seq_len:
            raise ContextOverflow(f"sequence of {longest} exceeds seq_len {self.seq_len}")
        # bucket the padded length as a prefill does: extra left padding is
        # invisible (offsets grow, masks and RoPE follow)
        bucket = max(longest, min(_next_bucket(longest), self.seq_len))
        toks = np.zeros((self.batch, bucket), np.int64)
        offsets = np.zeros((self.batch,), np.int64)
        for r, s in enumerate(sequences):
            toks[r, bucket - len(s):] = s
            offsets[r] = bucket - len(s)
        dtype = None if self.cache.quantized else self.cache.k.dtype
        cache = self._per_rank(lambda dev, tp: init_kv_cache(
            self.cfg, self.batch // self.dp, bucket, dtype=dtype, device=dev, tp=tp))
        with on_device(self.device):
            tk = torch.from_numpy(toks).to(self.device)
            logits, _ = forward(self.params, self.cfg, tk, cache, 0,
                                offsets=torch.from_numpy(offsets).to(self.device))
            lg = logits.to(torch.float32)
            # normalize by a (B, T) logsumexp instead of a second full-vocab
            # log_softmax buffer beside the logits
            lse = torch.logsumexp(lg, dim=-1)
            # log P of the NEXT fed token, at the position producing it
            nxt = torch.roll(tk, -1, dims=1)  # (B, T); the last column is garbage
            tok_lp = torch.gather(lg, -1, nxt[..., None])[..., 0] - lse
            ti = tl = None
            if top_k > 0:
                tl, ti = torch.topk(lg, top_k, dim=-1)  # (B, T, k)
                tl = (tl - lse[..., None]).cpu().numpy()
                ti = ti.to(torch.int32).cpu().numpy()
            tok_lp = tok_lp.cpu().numpy()
        self.forwards += 1
        return tok_lp, ti, tl

    def generate(self, prompt_tokens: list[int], steps: int, sampler: Sampler,
                 eos_ids: tuple[int, ...] = ()):
        """Yield ``(token_id, stats)`` for up to ``steps`` tokens with the
        host sampler, one decode step per token (the reference loop)."""
        self._one_process("the host sampler's loop")
        steps = min(steps, self.seq_len - self.pos)
        logits, stats = self.prefill(prompt_tokens[:])
        produced = len(prompt_tokens)
        for i, t in enumerate(prompt_tokens):
            yield t, stats if i == len(prompt_tokens) - 1 else StepStats()
        if produced >= steps:
            return
        token = int(sampler.sample(logits[0]))
        stats = StepStats()
        while True:
            yield token, stats
            produced += 1
            if produced >= steps or self.pos >= self.seq_len or token in eos_ids:
                return
            logits, stats = self.decode_one(token)
            token = int(sampler.sample(logits[0]))


class SlotDispatch:
    """Completion handle of one :meth:`Engine.slot_step_async` dispatch:
    its sampled ids (steps, B) on their way to the host (a
    :class:`Landing`), and ``last_dev``, the (B,) final row kept on the
    device for a ``feed_dev`` successor.  ``wait()`` (idempotent) blocks
    on this dispatch alone; it stamps the engine's
    ``last_slot_dispatch_ms``."""

    __slots__ = ("_engine", "_landing", "last_dev", "t", "steps",
                 "enqueued_at", "ready_at", "_out")

    def __init__(self, engine, landing: Landing, last_dev, *, t: int, steps: int,
                 enqueued_at: float):
        self._engine = engine
        self._landing = landing
        self.last_dev = last_dev
        self.t = t
        self.steps = steps
        self.enqueued_at = enqueued_at  # perf_counter at enqueue
        self.ready_at: float | None = None
        self._out: np.ndarray | None = None

    def wait(self) -> np.ndarray:
        """Block until the dispatch lands; returns the (steps, B) ids."""
        if self._out is None:
            self._out = self._engine._sync(self._landing.wait, "slot step")[1][2]
            self.ready_at = time.perf_counter()
            self._engine.last_slot_dispatch_ms = (self.ready_at - self.enqueued_at) * 1e3
            obs_trace.record("slot_step", self.enqueued_at, self.ready_at,
                             t=self.t, steps=self.steps)
        return self._out


class SlotVerifyDispatch:
    """Completion handle of one :meth:`Engine.slot_verify_async` dispatch:
    the (B, T + 1) predictions and accepted counts on their way to the host
    (a :class:`Landing`), and ``last_dev`` (B,), the verified next token
    ``preds[r, accepted[r]]`` kept on the device.  ``wait()`` (idempotent)
    returns ``(preds (B, T), accepted (B,))`` as host int32 arrays and
    stamps the engine's ``last_slot_dispatch_ms``."""

    __slots__ = ("_engine", "_landing", "last_dev", "t", "steps", "enqueued_at",
                 "ready_at", "_out")

    def __init__(self, engine, landing: Landing, last_dev, *, t: int, enqueued_at: float):
        self._engine = engine
        self._landing = landing
        self.last_dev = last_dev
        self.t = t
        self.steps = 1
        self.enqueued_at = enqueued_at
        self.ready_at: float | None = None
        self._out: tuple[np.ndarray, np.ndarray] | None = None

    def wait(self) -> tuple[np.ndarray, np.ndarray]:
        """Block until the verify lands; returns ``(preds, accepted)``."""
        if self._out is None:
            host = self._engine._sync(self._landing.wait, "slot verify")[1][2]
            self.ready_at = time.perf_counter()
            self._engine.last_slot_dispatch_ms = (self.ready_at - self.enqueued_at) * 1e3
            obs_trace.record("slot_verify", self.enqueued_at, self.ready_at, t=self.t)
            self._out = (host[:, :self.t], host[:, self.t].copy())
        return self._out
