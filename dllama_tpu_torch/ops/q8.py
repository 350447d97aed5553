"""Q80 weights on the device: packed storage + dequant-matmul.

The port of ``dllama_tpu/ops/q8.py``'s single-device half, the Q80 twin of
:mod:`.q40`.  Weights stay packed on the device; the CUDA kernel
``csrc/q8_matmul.cu`` widens int8 values, applies the per-block scales and
accumulates in one pass, so a decode step streams 1.0625 bytes/weight
instead of 2 (bf16).

Device layout (the same bytes as the JAX package's):

* ``qpacked`` int8 ``(..., padded_n, d)`` — one row per input position;
* ``scales`` float16 ``(..., padded_n/32, d)`` — the per-block f16 deltas
  as the `.m` file stores them, a bit-identical view of the JAX package's
  uint16 planes.

Rows past ``n`` (the ``padded_n`` padding, as :func:`.q40.padded_n`) have
zero values and zero scales.  Leading dims stack planes (layers, or
layer × expert), addressed by a flat index as in :mod:`.q40`.

:func:`matmul` computes the JAX kernel's contract: weights
``bf16(f32(v)·f32(s))`` (one bf16 round of the file codec's dequant),
activations cast to bf16, products summed in f32, an f32 result.  Dispatch
and counters (``kernel_launches``, ``launches_by_shape``, ``plain_calls``)
are :mod:`.q40`'s.  The kernel has two bodies, chosen by :func:`route` from
the row count, each a template it shares with the Q40 kernel: the GEMV
body below ``T_MMA`` rows (``csrc/gemv_common.cuh``), and from ``T_MMA``
rows up the Hopper tensor-core body (``csrc/wgmma_matmul.cuh``: the int8
tile and its scales by a TMA ring on mbarriers, the weights dequantized
into wgmma's A registers; :func:`mma_plan`, :func:`mma_tma`; counted in
``mma_launches``).

Tensor parallelism: on a mesh the JAX package runs Q80 as an XLA dequant
and lets GSPMD insert the all-reduce (its ``q8.py:309-365``).  The port
computes the same function with its kernels: kernels 5–6 on every rank's
slice, then, for a column-sliced weight, ``q40.tp_allreduce`` (kernel 4)
on the f32 partials before the cast (``models/transformer``).
"""

from __future__ import annotations

import ctypes
import functools
import sys
from dataclasses import dataclass

import numpy as np
import torch

from .. import quants
from . import COUNT_LOCK
from . import q40
from .q40 import (MMA_BK, MMA_BN, MmaPlan, _launch_wgmma, _planes, dispatch, gemv_plan,
                  launch, padded_n, plan_wgmma)

kernel_launches = 0
mma_launches = 0
plain_calls = 0
launches_by_shape: dict[tuple, int] = {}

# Rows from which a call takes the tensor-core body (``q8_matmul_mma`` in
# csrc/q8_matmul.cu); fewer rows take the decode body (the Q40 kernel's
# template, csrc/gemv_common.cuh).  Phase 9 of chip_smoke.py times both at
# every t and prints the crossover (PERF.md): the decode body wins over a
# 7B layer's four matmuls at t = 1; the tensor-core body's 16-row tile
# wins them by 4 % at t = 4 (two of the four sites slower) and by 9-15 %
# from t = 5 to 8, where the decode body still reads each weight once
# (Q40's crossover stays at 9: ops/q40.py T_MMA).
T_MMA = 5
# The tensor-core body's block (csrc/wgmma_matmul.cuh WgShape<Q8, BM>):
# the tile heights (rows of x a block), each height's ring stages and
# dynamic shared memory (a stage: the BM x 64 bf16 x tile, the 64 x 128
# int8 tile, two 128-wide f16 scale rows, two barriers; no block sums).
# 288 threads a block, as Q40's (ops/q40.py, whose MMA_BN and MMA_BK it
# shares); Q80 adds the 16-row tile (wgmma m64n16k16), which took 2-16 %
# less time than the 32-row one at every 7B site at t = 16 (PERF.md).  The decode
# body's plan (gemv_plan) is the Q40 kernel's, imported above.
MMA_BMS = (16, 32, 128)
MMA_STAGES = {bm: 8 for bm in MMA_BMS}
MMA_SMEM = {bm: MMA_STAGES[bm] * (bm * MMA_BK * 2 + MMA_BK * MMA_BN + 4 * MMA_BN + 16) + 1024
            for bm in MMA_BMS}
# The plan's cost model (ops/q40.py plan_wgmma) at this codec's step: a
# block's 64-row step takes about MMA_STEP_US[bm] microseconds whatever the
# shape (chip_ab_q40.py --codec q8 --plans, H100 80GB HBM3: a one-split
# grid's time over its steps; any value from 0.6 to 0.9 at 128 rows picks
# the measured best grid at every 7B site)
MMA_STEP_US = {16: 0.6, 32: 0.6, 128: 0.74}


def mma_plan(t: int, n: int, d: int, n_sms: int) -> MmaPlan:
    """The Q80 tensor-core body's grid: :func:`.q40.plan_wgmma` at this
    codec's ``MMA_STEP_US``."""
    return plan_wgmma(t, n, d, n_sms, MMA_STEP_US)


def mma_tma(row_bytes: int, vptr: int, sptr: int) -> bool:
    """Can the tensor-core body read a plane's int8 values and scales by
    TMA boxes?  Value rows ``row_bytes`` (d) apart, scale rows twice that,
    both pointers on 16 bytes (:func:`.q40.mma_tma`); else the producer
    warp copies them."""
    return q40.mma_tma(row_bytes, vptr, sptr, False)


def mma_layout(bm: int) -> dict:
    """The tensor-core body's block at tile height ``bm`` as the build
    reports it (``q8_mma_layout``): threads, dynamic shared memory, ring
    stages."""
    return q40.mma_layout(bm, "q8_mma_layout")


def reset_counters() -> None:
    global kernel_launches, mma_launches, plain_calls
    kernel_launches = mma_launches = plain_calls = 0
    launches_by_shape.clear()


def counters() -> dict:
    """``kernel_launches`` counts every launch of the Q80 kernel, of which
    ``mma_launches`` took the tensor-core body; ``launches_by_shape`` is
    keyed ``(n, d)`` for the GEMV body and ``("mma", n, d)`` for the
    tensor-core body."""
    return {"kernel_launches": kernel_launches, "mma_launches": mma_launches,
            "plain_calls": plain_calls,
            "launches_by_shape": dict(launches_by_shape)}


def route(t: int) -> str:
    """The body a call of ``t`` rows takes: ``"gemv"`` below ``T_MMA``
    rows, else ``"mma"``."""
    return "mma" if t >= T_MMA else "gemv"


@dataclass(frozen=True)
class Q8Tensor:
    """A Q80 tensor of logical shape ``(..., n, d)``; storage rows cover
    ``padded_n(n)`` input positions.  Field names match ``q40.QTensor``."""

    qpacked: torch.Tensor       # int8    (..., padded_n, d)
    scales: torch.Tensor        # float16 (..., padded_n/32, d)
    logical_nd: tuple[int, int]

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.qpacked.shape[:-2]) + self.logical_nd

    def to(self, device) -> "Q8Tensor":
        return Q8Tensor(self.qpacked.to(device), self.scales.to(device),
                        self.logical_nd)


def alloc_value_plane(lead: tuple, np_: int, d: int) -> np.ndarray:
    """One int8 row per input position (Q40 packs two a byte)."""
    return np.zeros((*lead, np_, d), np.int8)


def from_np(qv: np.ndarray, sc: np.ndarray, nd: tuple[int, int]) -> Q8Tensor:
    return Q8Tensor(torch.from_numpy(np.ascontiguousarray(qv, np.int8)),
                    torch.from_numpy(np.ascontiguousarray(sc, np.float16)), nd)


def pack_planes_np(qvals: np.ndarray, scales: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray, tuple[int, int]]:
    """int8 values ``(..., n, d)`` + f16 scales ``(..., n/32, d)`` → padded
    host planes (zero pad values and scales: the padded region adds exactly
    0 to every dot)."""
    *lead, n, d = qvals.shape
    np_ = padded_n(n)
    q = np.asarray(qvals, np.int8)
    s = np.asarray(scales, np.float16)
    if np_ != n:
        q = np.concatenate([q, np.zeros((*lead, np_ - n, d), np.int8)], axis=-2)
        s = np.concatenate([s, np.zeros((*lead, (np_ - n) // 32, d), np.float16)], axis=-2)
    return q, s, (n, d)


def quantize(w: np.ndarray) -> Q8Tensor:
    """Quantize a float array ``(..., n, d)`` along the input axis with the
    file codec's math: ``delta = absmax/127``, ``q = round(x/delta)`` half
    away from zero (``quants.round_half_away``)."""
    w = np.asarray(w, np.float32)
    *lead, n, d = w.shape
    if n % quants.BLOCK_SIZE:
        raise ValueError(f"input dim {n} not divisible by {quants.BLOCK_SIZE}")
    g = w.reshape(*lead, n // 32, 32, d)
    deltas = np.abs(g).max(axis=-2) / 127.0
    inv = np.where(deltas != 0, np.divide(1.0, deltas, where=deltas != 0), 0.0)
    q = quants.round_half_away(g * inv[..., None, :]).astype(np.int8).reshape(*lead, n, d)
    with np.errstate(over="ignore"):  # overflow becomes inf → caught below
        sc = deltas.astype(np.float16)
    if not np.isfinite(sc).all():
        raise ValueError("Q80 scale overflowed f16 — values too large to pack")
    return from_np(*pack_planes_np(q, sc))


def repack_file_bytes_into(raw: np.ndarray, d: int, n: int,
                           qv2: np.ndarray, sc2: np.ndarray, col: int = 0) -> None:
    """One (d, n) tensor's `.m` Q80 bytes → preallocated planes (``qv2``
    int8 (padded_n, ld), ``sc2`` f16 (padded_n/32, ld)) at output column
    ``col``: a byte transpose of the file's (f16 delta, 32 int8) blocks.
    Padding rows are left as the caller zeroed them."""
    nb = n // 32
    blocks = np.asarray(raw, np.uint8).reshape(d, nb, quants.Q80_BLOCK_BYTES)
    sc2[:nb, col:col + d] = (
        np.ascontiguousarray(blocks[:, :, :2]).view(np.float16).reshape(d, nb).T)
    vals = np.ascontiguousarray(blocks[:, :, 2:]).view(np.int8)  # (d, nb, 32)
    qv2[:nb * 32, col:col + d] = np.moveaxis(vals, 0, 2).reshape(nb * 32, d)


def check_finite(sc: np.ndarray, what: str) -> None:
    # the kernel widens f16 bits as they are: an inf/NaN scale from a
    # corrupt or overflowed file would give silently wrong weights
    if not np.isfinite(sc).all():
        raise ValueError(f"Q80 {what} contains inf/NaN f16 scales — corrupt or "
                         "overflowed .m tensor (delta exceeded f16 range at conversion)")


def pack_file_groups(groups: list[list[tuple[np.ndarray, int, int]]],
                     stacked: bool = True) -> Q8Tensor:
    """Layer-stacked Q8Tensor straight from `.m` file bytes, the Q80 twin of
    :func:`.q40.pack_file_groups`: ``groups[l]`` lists ``(raw_bytes, d_out,
    n_in)`` whose output dims concatenate into one fused weight;
    ``stacked=False`` with one group returns the 2-D tensor (wcls)."""
    n = groups[0][0][2]
    d_total = sum(g[1] for g in groups[0])
    L = len(groups)
    np_ = padded_n(n)
    qv = np.zeros((L, np_, d_total), np.int8)
    sc = np.zeros((L, np_ // 32, d_total), np.float16)
    for l, group in enumerate(groups):
        col = 0
        for raw, d, gn in group:
            if gn != n:
                raise ValueError(f"fused group mixes input dims {gn} != {n}")
            repack_file_bytes_into(raw, d, n, qv[l], sc[l], col)
            col += d
    check_finite(sc, "scale plane")
    if not stacked:
        if L != 1:
            raise ValueError("stacked=False needs exactly one group")
        return from_np(qv[0], sc[0], (n, d_total))
    return from_np(qv, sc, (n, d_total))


def dequantize(qt: Q8Tensor, dtype=torch.bfloat16, layer=None) -> torch.Tensor:
    """The dense logical array (of one plane when ``layer`` is given, see
    :func:`.q40.plane`): ``f32(v)·f32(s)`` cast once to ``dtype`` —
    bit-identical to the JAX package's ``dequantize``."""
    qv, sc = (qt.qpacked, qt.scales) if layer is None else _planes(qt, layer)
    *lead, np_, d = qv.shape
    v = qv.to(torch.float32).reshape(*lead, np_ // 32, 32, d)
    w = (v * sc.to(torch.float32)[..., :, None, :]).to(dtype).reshape(*lead, np_, d)
    return w[..., :qt.logical_nd[0], :]


def matmul_plain(x2: torch.Tensor, qt: Q8Tensor, layer=None) -> torch.Tensor:
    """The plain version: ``bf16(x) (t, n) @ bf16(W) (n, d)`` with products
    summed in f32, result f32 (both bf16 operands widened to f32 first, as
    in :func:`.q40.matmul_plain`)."""
    w = dequantize(qt, torch.bfloat16, layer)
    return torch.matmul(x2.to(torch.bfloat16).to(torch.float32), w.to(torch.float32))


def matmul(x: torch.Tensor, qt: Q8Tensor, layer=None, out_dtype=None,
           impl: str = "auto") -> torch.Tensor:
    """``x @ dequantize(qt)`` with f32 accumulation: x (..., n) → (...,
    d) in ``out_dtype`` (default ``x.dtype``).  ``layer`` is a flat plane
    index (a Python int or an int32 device tensor).  A CPU tensor or
    ``impl="plain"`` runs :func:`matmul_plain`; a CUDA tensor of any row
    count launches the kernel; the routing is :func:`.q40.dispatch`."""
    return dispatch(sys.modules[__name__], _kernel, x, qt, layer, out_dtype, impl)


def _kernel(x2: torch.Tensor, qt: Q8Tensor, layer) -> torch.Tensor:
    return q8_matmul(x2, qt.qpacked, qt.scales, qt.logical_nd[0], layer)


def q8_matmul(x2: torch.Tensor, qvals: torch.Tensor, scales: torch.Tensor,
              n: int, layer=None, body: str | None = None) -> torch.Tensor:
    """Launch the Q80 dequant-matmul kernel: ``bf16(x2) (t, n) @ W`` → f32
    ``(t, d)``, reading plane ``layer`` of stacked ``(..., np, d)`` planes
    in place (:func:`.q40.plane_index`), or the 2-D plane when ``layer`` is
    None.  The body is :func:`route`'s for ``t`` rows; ``body`` ("gemv" or
    "mma") names one, to time the two against each other.  CUDA tensors
    only: it launches the kernel or raises (:func:`.q40.launch` checks the
    operands)."""
    global kernel_launches, mma_launches
    body = body or route(x2.shape[0])
    if body == "gemv":
        out = launch("q8_matmul", x2, qvals, scales, n, layer, torch.int8, 1)
        key = (n, out.shape[1])
    elif body == "mma":
        out = launch("q8_matmul_mma", x2, qvals, scales, n, layer, torch.int8, 1,
                     mma=functools.partial(_launch_wgmma, codec=sys.modules[__name__]))
        key = ("mma", n, out.shape[1])
    else:
        raise ValueError(f"q8_matmul: unknown body {body!r}")
    with COUNT_LOCK:
        mma_launches += body == "mma"
        kernel_launches += 1
        launches_by_shape[key] = launches_by_shape.get(key, 0) + 1
    return out


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry point's signature (pointers and the stream as
    ``c_void_p``, so ctypes never cuts a 64-bit pointer)."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.q8_matmul.argtypes = [vp] * 7 + [ci] * 8 + [vp]
    lib.q8_matmul.restype = ci
    lib.q8_matmul_mma.argtypes = [vp] * 6 + [ci] * 11 + [vp]
    lib.q8_matmul_mma.restype = ci
    lib.q8_mma_layout.argtypes = [ci, ctypes.POINTER(ci)]
    lib.q8_mma_layout.restype = ci
    return lib
