"""Q40 weights on the device: packed storage + dequant-matmul.

The port of ``dllama_tpu/ops/q40.py``'s single-device half.  Weights stay
packed on the device; the CUDA kernel ``csrc/q40_matmul.cu`` unpacks
nibbles, applies the per-block scales and accumulates in one pass, so a
decode step streams 0.5625 bytes/weight instead of 2 (bf16).

Device layout (block-local, the same bytes as the JAX package's):

* ``qpacked`` uint8 ``(..., padded_n/2, d)`` — for block ``b`` along the
  input axis, packed row ``16b + r`` holds logical row ``32b + r`` in its
  low nibble and logical row ``32b + 16 + r`` in its high nibble, biased +8.
* ``scales`` float16 ``(..., padded_n/32, d)`` — the per-block f16 deltas
  as the `.m` file stores them, a bit-identical view of the JAX package's
  uint16 planes.  Rows past ``n`` (the ``padded_n`` padding) have zero
  scales.

Leading dims stack planes: ``(L, ...)`` for layers, ``(L, E, ...)`` for
MoE expert stacks.  One plane is addressed by a flat index over the
leading dims (``layer·E + expert``), a Python int or an int32 tensor that
the kernel reads from device memory, so an expert id chosen on the card is
never read back by the host.  :func:`mm` dispatches any weight (Q40, Q80
or dense) to its matmul.

:func:`matmul` computes one of the JAX kernel's four dequant variants
(``DLLAMA_Q40_VARIANT``, read at import into :data:`KERNEL_VARIANT`, as
the JAX package reads it).  x is rounded to bf16, v is a nibble in
[0, 15], s the f16 scale of its 32-row block, every sum is f32:

* ``classic`` — ``x · bf16(f32(v-8)·s)``;
* ``fma`` — ``x · bf16(v·s + (-8·s))``: equal in value to ``classic``
  (both products are exact in f32), up to the sign of a zero; the kernel
  serves it with ``classic``'s arithmetic, under its own name and counts;
* ``folded`` — ``x · bf16(bf16(v)·bf16(s)) - 8·Σ_b bf16(bs_b)·bf16(s_b)``,
  bs_b the f32 sum of x over block b (its lo half's sum plus its hi
  half's);
* ``exact`` — ``Σ_b (p_b - 8·bs_b)·s_b``, p_b the dot of x with the raw
  nibbles of block b: no weight is rounded to bf16.

As in the JAX package, the variant governs row-major weights at up to
``PALLAS_MAX_ROWS`` = 128 rows (:func:`variant_for`); a call of more rows
(which the JAX package dequantizes in XLA) and a blocked plane compute
``classic``.  Dispatch:

* a CPU tensor → :func:`matmul_plain`, the plain PyTorch version;
* a CUDA tensor of any row count → the kernel (:func:`q40_matmul`), which
  launches or raises.  (The JAX package leaves products of more than 128
  rows to XLA; here a long prefill or a scoring forward runs the
  tensor-core body at its full width.)

Tile-contiguous ("blocked") storage, :class:`BlockedQTensor` (the JAX
package's ``DLLAMA_Q40_LAYOUT=blocked``): the same bytes re-cut into
``(tn/2, td)`` tiles, each one contiguous run of memory.  A CUDA tensor
takes kernel 3 (the ``q40_matmul_blocked`` entry of the same source), which reads the tiles in place; the plain route
unblocks the one plane it needs.

Tensor parallelism (the JAX package's ``_sharded_matmul``, ``kind=
"row"|"col"``): the model walks the ranks itself (``models/transformer``),
so a row-sliced matmul is each rank's kernel on its slice, and a
column-sliced one each rank's kernel, then :func:`tp_allreduce` on the f32
partials, then the cast.  :func:`tp_shardable` says which slices are
legal.  Kernel 4 (``csrc/tp_allreduce.cu``), its plain version
:func:`tp_allreduce_plain` and its counters live here, as the TPU ring
kernel lives in the JAX package's ``q40.py``.  Over a mesh that spans
processes (``parallel/mesh.py``) :func:`tp_allreduce` takes the mesh: on
the card it launches kernel 4's cross-process body
(:func:`tp_allreduce_ipc`, the peers' partials read through CUDA IPC), on
the CPU its plain version gathers every rank's partial over gloo
(:func:`tp_allreduce_group_plain`) and sums them in the same order.

The kernel has two bodies, chosen by :func:`route` from the row count:
the GEMV (decode) body below ``T_MMA`` rows, one launch a call on
:func:`gemv_plan` (shared with the Q80 kernel), and, from ``T_MMA`` rows
up, the Hopper tensor-core body (TMA ring, wgmma; :func:`mma_plan`), in
both layouts; both bodies are templates the Q80 kernel shares.

Module counters (plain ints, bumped under ``ops.COUNT_LOCK``) record
which route ran:
``kernel_launches`` (kernels 1–2 on row-major planes), ``blocked_launches``
(kernel 3 on blocked planes), ``mma_launches`` (those of either that took
the tensor-core body), ``launches_by_shape`` keyed by logical ``(n, d)``
for kernels 1–2, ``("blocked", n, d)`` for kernel 3 and ``("mma", n, d)``,
``("blocked-mma", n, d)`` for their tensor-core body, each key of a
variant other than ``classic`` ending in its name (``(n, d, "exact")``,
``("mma", n, d, "exact")``; :func:`launches_by_variant`), ``plain_calls``,
and kernel 4's ``allreduce_launches`` and
``allreduce_plain_calls`` (every launch and every plain call, in one
process or across processes), of which ``allreduce_ipc_launches`` and
``allreduce_gloo_calls`` crossed processes.  :func:`reset_counters`
zeroes them.
"""

from __future__ import annotations

import ctypes
import functools
import os
import sys
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .. import quants
from ..device import index_view
from . import COUNT_LOCK

# Pack-time padding granularity of the input dim (the JAX package's
# TILE_N default): padded rows carry zero scales, so the packed planes are
# byte-identical to the JAX package's.
TILE_N = 1024
# The dequant variant of kernels 1-2 (the module docstring), fixed for the
# process as the JAX package fixes it: every captured graph replays it.
KERNEL_VARIANT = os.environ.get("DLLAMA_Q40_VARIANT", "classic")
VARIANTS = ("classic", "fma", "folded", "exact")
# Rows up to which a row-major call takes the variant (the JAX package's
# PALLAS_MAX_ROWS: its Pallas kernel's reach; more rows dequantize in XLA,
# classic's numerics).
PALLAS_MAX_ROWS = 128

kernel_launches = 0
blocked_launches = 0
mma_launches = 0
plain_calls = 0
launches_by_shape: dict[tuple, int] = {}


def reset_counters() -> None:
    global kernel_launches, blocked_launches, mma_launches, plain_calls
    global allreduce_launches, allreduce_plain_calls
    global allreduce_ipc_launches, allreduce_gloo_calls
    kernel_launches = blocked_launches = mma_launches = plain_calls = 0
    allreduce_launches = allreduce_plain_calls = 0
    allreduce_ipc_launches = allreduce_gloo_calls = 0
    launches_by_shape.clear()


def counters() -> dict:
    return {"kernel_launches": kernel_launches, "blocked_launches": blocked_launches,
            "mma_launches": mma_launches,
            "plain_calls": plain_calls,
            "allreduce_launches": allreduce_launches,
            "allreduce_plain_calls": allreduce_plain_calls,
            "allreduce_ipc_launches": allreduce_ipc_launches,
            "allreduce_gloo_calls": allreduce_gloo_calls,
            "launches_by_shape": dict(launches_by_shape)}


def check_variant(variant: str | None = None) -> str:
    """``variant``, or :data:`KERNEL_VARIANT` when None; raises the JAX
    package's error on any other name."""
    v = variant or KERNEL_VARIANT
    if v not in VARIANTS:
        raise ValueError(f"unknown q40 kernel variant {v!r} "
                         "(expected classic | fma | folded | exact)")
    return v


def variant_for(t: int, blocked: bool = False) -> str:
    """The variant a call of ``t`` rows computes (the JAX package's rule):
    :data:`KERNEL_VARIANT` on a row-major weight at up to
    ``PALLAS_MAX_ROWS`` rows, else ``classic`` (more rows; ``blocked``
    planes)."""
    v = check_variant()
    return "classic" if blocked or t > PALLAS_MAX_ROWS else v


def launches_by_variant(by_shape: dict | None = None) -> dict[str, int]:
    """Kernel launches of ``by_shape`` (a ``launches_by_shape`` dict; the
    module's own when None) summed by the variant the body computed: a key
    ending in a variant's name counts under it, every other key (kernel 3
    too) under ``classic``."""
    out: dict[str, int] = {}
    for key, n in (launches_by_shape if by_shape is None else by_shape).items():
        v = key[-1] if isinstance(key[-1], str) else "classic"
        out[v] = out.get(v, 0) + n
    return out


def padded_n(n: int) -> int:
    """Storage row count: the input dim padded to a TILE_N multiple
    (Llama-2's 11008 hidden → 11264)."""
    if n <= TILE_N:
        return n
    return ((n + TILE_N - 1) // TILE_N) * TILE_N


@dataclass(frozen=True)
class QTensor:
    """A Q40 tensor of logical shape ``(..., n, d)``; storage rows cover
    ``padded_n(n)`` input positions."""

    qpacked: torch.Tensor       # uint8   (..., padded_n/2, d)
    scales: torch.Tensor        # float16 (..., padded_n/32, d)
    logical_nd: tuple[int, int]

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.qpacked.shape[:-2]) + self.logical_nd

    def to(self, device) -> "QTensor":
        return QTensor(self.qpacked.to(device), self.scales.to(device),
                       self.logical_nd)


def alloc_value_plane(lead: tuple, np_: int, d: int) -> np.ndarray:
    """Two nibbles a byte: ``np_/2`` packed rows per plane."""
    return np.zeros((*lead, np_ // 2, d), np.uint8)


def check_finite(sc: np.ndarray, what: str) -> None:
    # the kernel widens f16 bits as they are: an inf/NaN scale from a
    # corrupt or overflowed file would give silently wrong weights
    if not np.isfinite(sc).all():
        raise ValueError(f"Q40 {what} contains inf/NaN f16 scales — corrupt "
                         "or overflowed .m tensor")


def pack_planes_np(qvals: np.ndarray, scales: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray, tuple[int, int]]:
    """Pack int8 nibble values ``(..., n, d)`` in [-8, 7] + scales
    ``(..., n/32, d)`` into the block-local layout as host numpy arrays,
    padding the input dim to ``padded_n`` with zero scales."""
    *lead, n, d = qvals.shape
    np_ = padded_n(n)
    b = (qvals + 8).astype(np.uint8).reshape(*lead, n // 32, 32, d)
    lo = b[..., :16, :]
    hi = b[..., 16:, :]
    packed = (lo | (hi << 4)).reshape(*lead, n // 2, d)
    if np_ != n:
        packed = np.concatenate(
            [packed, np.zeros((*lead, (np_ - n) // 2, d), np.uint8)], axis=-2)
        scales = np.concatenate(
            [scales, np.zeros((*lead, (np_ - n) // 32, d), scales.dtype)], axis=-2)
    return packed, scales.astype(np.float16), (n, d)


def from_np(packed: np.ndarray, sc: np.ndarray, nd: tuple[int, int]) -> QTensor:
    return QTensor(torch.from_numpy(np.ascontiguousarray(packed)),
                   torch.from_numpy(np.ascontiguousarray(sc, np.float16)), nd)


def pack_planes(qvals: np.ndarray, scales: np.ndarray) -> QTensor:
    packed, sc, nd = pack_planes_np(qvals, scales)
    check_finite(sc, "scale (|block amax| > 8*65504, or NaN)")
    return from_np(packed, sc, nd)


def quantize(w: np.ndarray) -> QTensor:
    """Quantize a float array ``(..., n, d)`` to Q40 along the input axis:
    ``delta = amax/-8``, ``q = clamp(floor(x/delta + 8.5), 0, 15)``."""
    w = np.asarray(w, np.float32)
    *lead, n, d = w.shape
    if n % quants.BLOCK_SIZE:
        raise ValueError(f"input dim {n} not divisible by {quants.BLOCK_SIZE}")
    g = w.reshape(*lead, n // 32, 32, d)
    gmax = g.max(axis=-2)
    gmin = g.min(axis=-2)
    deltas = np.where(-gmin > gmax, gmin, gmax) / -8.0
    # q from the raw f32 delta, stored scale rounded to f16 (codec parity)
    inv = np.where(deltas != 0, np.divide(1.0, deltas, where=deltas != 0), 0.0)
    q = np.clip(g * inv[..., None, :] + 8.5, 0.0, 15.0).astype(np.uint8).astype(np.int8) - 8
    return pack_planes(q.reshape(*lead, n, d), deltas.astype(np.float16))


def repack_file_bytes_into(raw: np.ndarray, d: int, n: int,
                           qp2: np.ndarray, sc2: np.ndarray, col: int = 0) -> None:
    """Repack one (d, n) tensor's `.m` Q40 bytes into preallocated planes
    (``qp2`` u8 (padded_n/2, ld), ``sc2`` f16 (padded_n/32, ld)) at output
    column ``col``.  The file's per-block lo/hi nibble split is the runtime
    layout, so this is a pure byte transpose.  Padding rows are left as the
    caller zeroed them."""
    nb = n // 32
    blocks = np.asarray(raw, np.uint8).reshape(d, nb, quants.Q40_BLOCK_BYTES)
    sc2[:nb, col:col + d] = (
        np.ascontiguousarray(blocks[:, :, :2]).view(np.float16).reshape(d, nb).T)
    nib = np.moveaxis(blocks[:, :, 2:], 0, 2)       # (nb, 16, d)
    qp2[:nb * 16, col:col + d] = nib.reshape(nb * 16, d)


def pack_file_groups(groups: list[list[tuple[np.ndarray, int, int]]],
                     stacked: bool = True) -> QTensor:
    """Layer-stacked QTensor straight from `.m` file bytes.

    ``groups[l]`` is a list of ``(raw_bytes, d_out, n_in)`` whose output
    dims concatenate into one fused weight (e.g. q|k|v).  ``stacked=False``
    with a single group returns the 2-D QTensor (wcls)."""
    n = groups[0][0][2]
    d_total = sum(g[1] for g in groups[0])
    L = len(groups)
    np_ = padded_n(n)
    qp = np.zeros((L, np_ // 2, d_total), np.uint8)
    sc = np.zeros((L, np_ // 32, d_total), np.float16)
    for l, group in enumerate(groups):
        col = 0
        for raw, d, gn in group:
            if gn != n:
                raise ValueError(f"fused group mixes input dims {gn} != {n}")
            repack_file_bytes_into(raw, d, n, qp[l], sc[l], col)
            col += d
    check_finite(sc, "scale plane")
    if not stacked:
        if L != 1:
            raise ValueError("stacked=False needs exactly one group")
        return from_np(qp[0], sc[0], (n, d_total))
    return from_np(qp, sc, (n, d_total))


# ---------------------------------------------------------------------------
# Tile-contiguous ("blocked") storage — the port of the JAX package's
# BlockedQTensor / to_blocked / unblock / blocked_params
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class BlockedQTensor:
    """Layer-stacked Q40 storage re-cut so each ``(tn/2, td)`` tile of the
    packed plane is one contiguous run: ``qpacked`` ``(L, n2/bn, dp/td, bn,
    td)`` with ``bn = tn/2`` packed rows a tile and ``dp`` = d padded to a
    ``td`` multiple (zero scales in the pad columns); ``scales`` the same
    cut of the f16 plane, ``(L, n2/bn, dp/td, bn/16, td)``.  ``lead_2d``
    marks a tensor built from a 2-D ``(n2, d)`` one (wcls): storage carries
    L = 1 and the logical shape has no layer axis."""

    qpacked: torch.Tensor       # uint8   (L, n2/bn, dp/td, bn, td)
    scales: torch.Tensor        # float16 (L, n2/bn, dp/td, bn/16, td)
    logical_nd: tuple[int, int]
    tiles: tuple[int, int]      # (tn, td)
    lead_2d: bool = False

    @property
    def shape(self) -> tuple[int, ...]:
        if self.lead_2d:
            return self.logical_nd
        return (self.qpacked.shape[0],) + self.logical_nd

    def to(self, device) -> "BlockedQTensor":
        return BlockedQTensor(self.qpacked.to(device), self.scales.to(device),
                              self.logical_nd, self.tiles, self.lead_2d)


# default tiles (tn, td), the JAX package's: 512 logical rows by 2048 columns
DEFAULT_BLOCKED_TILES = (512, 2048)


def blocked_tiles_env() -> tuple[int, int]:
    """The ``DLLAMA_Q40_BLOCK_TILES`` override ("tn,td"), parsed at each
    :func:`to_blocked` call.  Anything but two positive ints prints one
    warning on stderr and keeps :data:`DEFAULT_BLOCKED_TILES`."""
    spec = os.environ.get("DLLAMA_Q40_BLOCK_TILES", "")
    if not spec:
        return DEFAULT_BLOCKED_TILES
    try:
        parts = tuple(int(v) for v in spec.split(","))
        if len(parts) != 2 or parts[0] <= 0 or parts[1] <= 0:
            raise ValueError(spec)
        return parts
    except ValueError:
        _warn_once(f"DLLAMA_Q40_BLOCK_TILES={spec!r} is not two positive ints "
                   f"'tn,td'; using {DEFAULT_BLOCKED_TILES}")
        return DEFAULT_BLOCKED_TILES


_warned: set[str] = set()


def _warn_once(msg: str) -> None:
    if msg not in _warned:
        _warned.add(msg)
        print(f"⚠️  {msg}", file=sys.stderr)


def to_blocked(qt: QTensor, tn: int | None = None, td: int | None = None
               ) -> BlockedQTensor:
    """Re-cut a 2-D ``(n2, d)`` or layer-stacked ``(L, n2, d)`` QTensor into
    tiles, on the tensor's own device.  The tiles clamp to the tensor as
    the JAX package clamps them: ``tn`` halves until ``tn/2`` divides the
    packed rows (never below 32), ``td`` shrinks to ``d`` rounded up to
    128.  The output is allocated once and filled one column tile at a time
    (no padded intermediate copy)."""
    env_tn, env_td = blocked_tiles_env()
    tn = tn or env_tn
    td = td or env_td
    lead_2d = qt.qpacked.dim() == 2
    qp0 = qt.qpacked[None] if lead_2d else qt.qpacked
    sc0 = qt.scales[None] if lead_2d else qt.scales
    if qp0.dim() != 3:
        raise ValueError("to_blocked expects a (n/2, d) or layer-stacked "
                         f"(L, n/2, d) QTensor, got {tuple(qt.qpacked.shape)}")
    L, n2, d = qp0.shape
    while tn > 32 and n2 % (tn // 2):
        tn //= 2
    td = min(td, -(-d // 128) * 128)
    bn, bnb = tn // 2, tn // 32
    if n2 % bn or tn % 32:
        raise ValueError(f"packed rows {n2} not divisible by tn/2={bn}")
    nI, nJ = n2 // bn, -(-d // td)
    qb = torch.zeros((L, nI, nJ, bn, td), dtype=qp0.dtype, device=qp0.device)
    sb = torch.zeros((L, nI, nJ, bnb, td), dtype=sc0.dtype, device=sc0.device)
    qv = qp0.reshape(L, nI, bn, d)
    sv = sc0.reshape(L, nI, bnb, d)
    for j in range(nJ):
        w = min(td, d - j * td)
        qb[:, :, j, :, :w] = qv[..., j * td:j * td + w]
        sb[:, :, j, :, :w] = sv[..., j * td:j * td + w]
    return BlockedQTensor(qb, sb, qt.logical_nd, (tn, td), lead_2d)


def _uncut(a: torch.Tensor, d: int) -> torch.Tensor:
    """``(..., nI, nJ, rows, td)`` tiles back to ``(..., nI·rows, d)``."""
    *lead, nI, nJ, rows, td = a.shape
    return a.transpose(-3, -2).reshape(*lead, nI * rows, nJ * td)[..., :d]


def unblock(bqt: BlockedQTensor) -> QTensor:
    """Inverse of :func:`to_blocked` (drops the d padding)."""
    d = bqt.logical_nd[1]
    qp, sc = _uncut(bqt.qpacked, d), _uncut(bqt.scales, d)
    if bqt.lead_2d:
        qp, sc = qp[0], sc[0]
    return QTensor(qp.contiguous(), sc.contiguous(), bqt.logical_nd)


def unblock_plane(bqt: BlockedQTensor, layer=None) -> QTensor:
    """The one plane ``layer`` of a blocked stack back in 2-D row-major
    form (plane 0 of a ``lead_2d`` tensor when ``layer`` is None): the plain
    route's input, which never re-lays out the other planes."""
    if layer is None:
        if not bqt.lead_2d:
            raise ValueError(f"a stacked BlockedQTensor {bqt.shape} needs a layer index")
        layer = 0
    elif bqt.lead_2d:
        raise ValueError(f"layer index given for a 2-D BlockedQTensor {bqt.shape}")
    d = bqt.logical_nd[1]
    qp, sc = (_uncut(plane(a.reshape(a.shape[0], -1, a.shape[-1]), layer)
                     .reshape(a.shape[1:]), d) for a in (bqt.qpacked, bqt.scales))
    return QTensor(qp, sc, bqt.logical_nd)


def blocked_params(params: dict) -> dict:
    """Every 2-D and layer-stacked 3-D Q40 weight of ``params`` in the
    blocked layout (``DLLAMA_Q40_LAYOUT=blocked``); 4-D expert stacks, Q80
    and dense tensors stay as they are, and a BlockedQTensor passes
    unchanged, so converting twice is converting once.  Converts on the
    device the params are on; the loader hands host params over, so the
    card never holds both layouts."""
    return {k: to_blocked(v) if isinstance(v, QTensor) and v.qpacked.dim() in (2, 3)
            else v for k, v in params.items()}


def plane(a: torch.Tensor, layer) -> torch.Tensor:
    """The 2-D plane of ``a`` at ``layer``: a flat index over the flattened
    leading dims (a layer of ``(L, n, d)``, or ``layer·E + expert`` of an
    ``(L, E, n, d)`` expert stack), as the JAX package's
    ``QLayerView.flat_planes`` takes it.  A Python int gives a view; a 0-d
    or 1-element int tensor is read on its device (``index_select``, no
    host read).  ``None`` returns ``a`` as it is."""
    if layer is None:
        return a
    a = a.reshape(-1, *a.shape[-2:])
    if isinstance(layer, torch.Tensor):
        return a.index_select(0, layer.reshape(1).to(a.device, torch.long))[0]
    return a[layer]


def _planes(qt, layer) -> tuple[torch.Tensor, torch.Tensor]:
    """``qt``'s two planes at ``layer`` (:func:`plane`); a Q40 or a Q80
    tensor (the same field names)."""
    if layer is None and qt.qpacked.dim() != 2:
        raise ValueError(f"a stacked {type(qt).__name__} {qt.shape} needs a layer index")
    if layer is not None and qt.qpacked.dim() < 3:
        raise ValueError(f"layer index given for a non-stacked {type(qt).__name__} {qt.shape}")
    return plane(qt.qpacked, layer), plane(qt.scales, layer)


def dequantize(qt: QTensor, dtype=torch.float32, layer=None) -> torch.Tensor:
    """Reconstruct the dense array (of one plane of a stacked QTensor when
    ``layer`` is given, see :func:`plane`): ``f32(v-8)·f32(s)``, then cast
    to ``dtype`` — bit-identical to the JAX package's ``dequantize``; the
    f16→f32 widening is exact, subnormals included."""
    if layer is None:
        qp, sc = qt.qpacked, qt.scales
    else:
        qp, sc = _planes(qt, layer)
    *lead, n2, d = qp.shape
    nb = n2 // 16
    v = qp.to(torch.int32).reshape(*lead, nb, 16, d)
    lo = (v & 0xF).to(torch.float32)
    hi = (v >> 4).to(torch.float32)
    w = torch.cat([lo, hi], dim=-2) - 8.0                 # (..., nb, 32, d)
    w = w * sc.to(torch.float32)[..., :, None, :]
    w = w.reshape(*lead, nb * 32, d)
    n = qt.logical_nd[0]
    if n != nb * 32:
        w = w[..., :n, :]  # drop the pack-time padding rows
    return w.to(dtype)


def _codes(qt: QTensor, layer) -> tuple[torch.Tensor, torch.Tensor]:
    """The raw nibbles ``v`` (nb, 32, d) f32 in [0, 15], logical row order,
    and the scales (nb, d) f32 of the plane at ``layer``, over the logical
    n's nb = n/32 blocks (the pack-time padding dropped)."""
    qp, sc = (qt.qpacked, qt.scales) if layer is None else _planes(qt, layer)
    nb = qt.logical_nd[0] // 32
    d = qp.shape[-1]
    v = qp[:nb * 16].to(torch.int32).reshape(nb, 16, d)
    v = torch.cat([v & 0xF, v >> 4], dim=-2).to(torch.float32)
    return v, sc[:nb].to(torch.float32)


def variant_weights(qt: QTensor, variant: str, layer=None) -> torch.Tensor:
    """The bf16 ``(n, d)`` matmul operand of ``classic`` (``bf16(f32(v-8)·
    s)``, :func:`dequantize`), ``fma`` (``bf16(v·s + (-8·s))``) or
    ``folded`` (``bf16(bf16(v)·bf16(s))``, the -8 left to the block sums);
    ``exact`` rounds no weight and has none."""
    if variant == "classic":
        return dequantize(qt, torch.bfloat16, layer)
    v, s = _codes(qt, layer)
    if variant == "fma":
        w = (v * s[:, None, :] + (-8.0 * s)[:, None, :]).to(torch.bfloat16)
    elif variant == "folded":
        w = v.to(torch.bfloat16) * s.to(torch.bfloat16)[:, None, :]  # one bf16 round
    else:
        raise ValueError(f"variant {variant!r} has no weight operand")
    return w.reshape(-1, w.shape[-1])


def matmul_plain(x2: torch.Tensor, qt: QTensor | BlockedQTensor,
                 layer=None, variant: str | None = None) -> torch.Tensor:
    """The plain version: ``bf16(x) (t, n) @ W`` with products summed in f32,
    result f32, in ``variant``'s numerics (the module docstring; None: the
    routing's, :func:`variant_for`).  bf16 operands are widened to f32
    before a product (exact), because a bf16×bf16 ``torch.matmul`` rounds
    its result to bf16.  A blocked tensor unblocks the one plane first."""
    t = x2.shape[0]
    variant = (check_variant(variant) if variant
               else variant_for(t, isinstance(qt, BlockedQTensor)))
    if isinstance(qt, BlockedQTensor):
        qt, layer = unblock_plane(qt, layer), None
    bf16, f32 = torch.bfloat16, torch.float32
    xb = x2.to(bf16).to(f32)
    if variant in ("classic", "fma"):
        return torch.matmul(xb, variant_weights(qt, variant, layer).to(f32))
    v, s = _codes(qt, layer)
    nb, _, d = v.shape
    xr = xb.reshape(t, nb, 32)
    bs = xr[..., :16].sum(-1) + xr[..., 16:].sum(-1)       # (t, nb) f32
    if variant == "folded":
        sb = s.to(bf16).to(f32)
        bias = 8.0 * torch.matmul(bs.to(bf16).to(f32), sb)
        return torch.matmul(xb, variant_weights(qt, variant, layer).to(f32)) - bias
    out = torch.zeros((t, d), dtype=f32, device=x2.device)
    step = max(1, (1 << 25) // (t * d))                      # blocks a pass
    for b0 in range(0, nb, step):
        b1 = min(nb, b0 + step)
        p = torch.einsum("tbk,bkd->tbd", xr[:, b0:b1], v[b0:b1])
        out += ((p - 8.0 * bs[:, b0:b1, None]) * s[None, b0:b1]).sum(1)
    return out


def matmul(x: torch.Tensor, qt: QTensor | BlockedQTensor, layer=None,
           out_dtype=None, impl: str = "auto") -> torch.Tensor:
    """``x @ dequantize(qt)`` with f32 accumulation.

    x: (..., n); ``qt`` logical (n, d), 2-D, or stacked with ``layer`` the
    flat index of one of its planes, a Python int or an int32 device
    tensor (:func:`plane`; the counterpart of the JAX package's
    ``QLayerView``).  Returns (..., d) in ``out_dtype`` (default
    ``x.dtype``).  ``impl="plain"`` runs the plain version on any device —
    the reference path that a comparison on the card holds the kernel
    against; ``"auto"`` dispatches as the module docstring says.  ``qt`` may
    be a :class:`BlockedQTensor`: kernel 3 then reads its tiles."""
    return dispatch(sys.modules[__name__], _kernel, x, qt, layer, out_dtype, impl)


def _kernel(x2: torch.Tensor, qt, layer) -> torch.Tensor:
    if isinstance(qt, BlockedQTensor):
        return q40_blocked_matmul(x2, qt.qpacked, qt.scales, qt.logical_nd, layer)
    return q40_matmul(x2, qt.qpacked, qt.scales, qt.logical_nd[0], layer,
                      variant=variant_for(x2.shape[0]))


def dispatch(codec, kernel, x: torch.Tensor, qt, layer, out_dtype, impl: str
             ) -> torch.Tensor:
    """The routing :func:`matmul` and ``q8.matmul`` share, counted on
    ``codec``'s (the module's) counters: a CPU tensor or ``impl="plain"`` →
    ``codec.matmul_plain``; a CUDA tensor → ``kernel(x2, qt, layer)``."""
    if impl not in ("auto", "plain"):
        raise ValueError(f"unknown {codec.__name__} matmul impl {impl!r}")
    n, d = qt.logical_nd
    lead = x.shape[:-1]
    rows = int(np.prod(lead)) if lead else 1
    x2 = x.reshape(rows, n)
    if impl == "plain" or x.device.type == "cpu":
        with COUNT_LOCK:
            codec.plain_calls += 1
        out = codec.matmul_plain(x2, qt, layer)
    else:
        out = kernel(x2, qt, layer)
    return out.reshape(*lead, d).to(out_dtype or x.dtype)


def mm(x: torch.Tensor, w, layer=None, impl: str = "auto",
       out_dtype=None) -> torch.Tensor:
    """Generic matmul: a packed weight (Q40 or Q80, bare or at a flat plane
    index ``layer``) goes to its codec's :func:`matmul`, a dense tensor (its
    plane at ``layer``, see :func:`plane`) to ``x @ w`` — the JAX package's
    ``q40.mm``.  ``out_dtype`` defaults to ``x.dtype`` for packed weights
    and to the product's dtype for dense ones."""
    from . import q8
    if isinstance(w, (QTensor, BlockedQTensor)):
        return matmul(x, w, layer, out_dtype=out_dtype, impl=impl)
    if isinstance(w, q8.Q8Tensor):
        return q8.matmul(x, w, layer, out_dtype=out_dtype, impl=impl)
    if not isinstance(w, torch.Tensor):
        raise TypeError(f"mm: unsupported weight type {type(w).__name__}")
    out = x @ plane(w, layer)
    return out.to(out_dtype) if out_dtype is not None else out


# ---------------------------------------------------------------------------
# The CUDA kernel (csrc/q40_matmul.cu) and its wrapper
# ---------------------------------------------------------------------------

# The decode body (t < T_MMA rows; csrc/gemv_common.cuh, shared with the
# Q80 kernel).  A block owns a column tile and a split of n, which its
# GEMV_WARPS warps walk, adding their partials in warp order; where a
# tile's n is split over blocks, the last of them to finish adds the
# splits' sums in split order: one launch a call, one fixed order.
GEMV_WARPS = 8
# a block's column tile by weights a byte (Q40 2: 8 lane groups of 16
# columns, a 16-byte piece of a packed row; Q80 1: 8 of 8); kCols * 8 in
# csrc/gemv_common.cuh
GEMV_COLS = {2: 128, 1: 64}
# blocks an SM runs at once (128 registers a thread, 32 KB of shared
# memory), and the least quantization blocks a split takes (two a warp)
GEMV_BLOCKS_PER_SM = 2
GEMV_MIN_SPLIT = 2 * GEMV_WARPS
# rows of x a launch (the mma's n: fewer leave rows of zeros; a call of
# more rows launches once a group of 8), and a block's shared memory: x
# pairs of a chunk of n, then the warps' partials
GEMV_ROWS = 8
GEMV_SMEM_BYTES = 32768


def gemv_plan(n: int, d: int, n_sms: int, per_byte: int = 2) -> tuple[int, int]:
    """The decode body's grid for the call's own ``(n, d)`` (a tensor-
    parallel rank's slice gets its own plan) and codec (``per_byte``
    weights a byte: 2 Q40, 1 Q80): returns ``(splits, blocks_per_split)``
    in 32-row quantization blocks.  The ``ceil(d / GEMV_COLS[per_byte])``
    column tiles take as many splits of n as one wave of
    ``GEMV_BLOCKS_PER_SM`` blocks an SM holds, none shorter than
    ``GEMV_MIN_SPLIT`` and none empty.  The plan is the same at every t.
    Llama-2-7B, Q40: wqkv 96 tiles × 2 splits, wo 32 × 8, wcls 250 × 1."""
    nb = n // 32
    tiles = -(-d // GEMV_COLS[per_byte])
    want = max(1, min(GEMV_BLOCKS_PER_SM * n_sms // tiles, nb // GEMV_MIN_SPLIT))
    per = -(-nb // want)
    return -(-nb // per), per


def _gemv_ws_sizes(splits: int, t: int, d: int, per_byte: int) -> tuple[int, int]:
    """f32 sums and int32 counts of the decode body's workspace: a sum of
    ``min(t, GEMV_ROWS)`` rows a split and column tile, a count a column
    tile; none when n is not split."""
    if splits == 1:
        return 0, 0
    cols = GEMV_COLS[per_byte]
    tiles = -(-d // cols)
    return splits * tiles * min(t, GEMV_ROWS) * cols, tiles


def gemv_workspace_bytes(splits: int, t: int, d: int, per_byte: int = 2) -> int:
    """The decode body's workspace for a call of ``t`` rows in ``splits``
    splits of n: where a tile's splits meet, the last to finish adding the
    others' sums and resetting the tile's count to 0."""
    return 4 * sum(_gemv_ws_sizes(splits, t, d, per_byte))


_gemv_ws: dict = {}
# workspaces a larger one replaced: kept alive, as a captured CUDA graph may
# still read them (their counts stay 0 like the live one's)
_gemv_ws_retired: list[torch.Tensor] = []


def _gemv_workspace(dev: torch.device, splits: int, t: int, d: int, per_byte: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The device's decode-body workspace (:func:`gemv_workspace_bytes`),
    grown to this call's need and kept for the next: the counts are zero
    at allocation and every launch leaves them zero.  Launches on one
    stream at a time share it.  A replaced workspace is never freed: a
    graph captured with it keeps its address."""
    n_part, n_count = _gemv_ws_sizes(splits, t, d, per_byte)
    part, count = _gemv_ws.get(dev, (None, None))
    if part is None or part.numel() < n_part:
        if part is not None:
            _gemv_ws_retired.append(part)
        part = torch.empty(max(n_part, 1), dtype=torch.float32, device=dev)
    if count is None or count.numel() < n_count:
        if count is not None:
            _gemv_ws_retired.append(count)
        count = torch.zeros(max(n_count, 1), dtype=torch.int32, device=dev)
    _gemv_ws[dev] = (part, count)
    return part, count


def _gemv_width(row_bytes: int, vptr: int, sptr: int, cols: int) -> int:
    """The widest value piece (``cols``, 8, 4 or 1 bytes: ``cols`` 16 for
    Q40, 8 for Q80) that a plane with rows ``row_bytes`` apart (d, or td
    blocked: a piece never crosses a column tile) allows at values ``vptr``
    and scales ``sptr``; a piece's scales are twice its bytes, read in loads
    of up to 16."""
    return next(w for w in (16, 8, 4, 1) if w <= cols and row_bytes % w == 0
                and vptr % w == 0 and sptr % min(16, 2 * w) == 0)


# Rows from which a call takes the tensor-core body (``q40_matmul_mma``,
# ``q40_matmul_blocked_mma`` in csrc/q40_matmul.cu); fewer rows take the
# decode body.  The crossover chip_smoke.py phase 2 measures at the five
# Llama-2-7B sites (PERF.md): up to t = 8 (one pass of the decode body's
# 8-row mma tile) the decode body is faster over a 7B layer's four
# matmuls; from t = 9 it makes a second pass over the weights.
T_MMA = 9
# The tensor-core body's block (csrc/wgmma_matmul.cuh kWgBN, kWgBK,
# WgShape): output columns and rows of n a step, the tile heights (rows of
# x a block), each height's copy-ring stages and dynamic shared memory (one
# block an SM at every height: 288 threads of up to 168 registers).  Q80's
# body is the same template on its own step (ops/q8.py: 64 int8 rows, no
# block sums), with its own step times and the same plan.
MMA_BN = 128
MMA_BK = 64
MMA_BMS = (32, 128)
MMA_STAGES = {32: 8, 128: 8}
MMA_SMEM = {bm: MMA_STAGES[bm] * (bm * MMA_BK * 2 + MMA_BK // 2 * MMA_BN + 4 * MMA_BN + 16)
            + 3 * 2 * bm * 4 + 1024 for bm in MMA_BMS}
# The plan's cost model, from chip_smoke-style timings of other grids
# (chip_ab_q40.py --plans, H100 80GB HBM3): a block's 64-row step takes
# about MMA_STEP_US[bm] microseconds whatever the shape, and the f32 split
# scratch is written, read and its sum written at about MMA_SCRATCH_RATE
# bytes a microsecond.
MMA_STEP_US = {32: 0.47, 128: 0.61}
MMA_SCRATCH_RATE = 3.0e6
# at most this many waves of split blocks
MMA_MAX_WAVES = 4


class MmaPlan(NamedTuple):
    """The tensor-core body's grid: tile height ``bm`` and width ``bn``,
    ``splits`` ranges of n of ``steps_per`` 64-row steps each."""

    bm: int
    bn: int
    splits: int
    steps_per: int


def route(t: int) -> str:
    """The body a Q40 call of ``t`` rows takes: ``"gemv"`` below ``T_MMA``
    rows, else ``"mma"``."""
    return "mma" if t >= T_MMA else "gemv"


def mma_plan(t: int, n: int, d: int, n_sms: int) -> MmaPlan:
    """The Q40 tensor-core body's grid (every variant alike):
    :func:`plan_wgmma` at this codec's ``MMA_STEP_US``."""
    return plan_wgmma(t, n, d, n_sms, MMA_STEP_US)


def plan_wgmma(t: int, n: int, d: int, n_sms: int, step_us: dict) -> MmaPlan:
    """The tensor-core body's grid (csrc/wgmma_matmul.cuh, both codecs).
    ``bm`` is the least tile height in ``step_us`` (the codec's tile
    heights and their measured step times) that covers ``t``, else the
    tallest; the ``ceil(t/bm)·ceil(d/128)`` output tiles take the split-K
    over the ``ceil(n/64)`` steps of n, each split ``steps_per`` steps and
    none empty, that the cost model puts first: the waves of blocks on
    ``n_sms`` SMs times a split's steps at ``step_us[bm]`` microseconds,
    plus the split scratch's traffic (``splits·t·d`` f32 written and read,
    the sum written) at ``MMA_SCRATCH_RATE``; at most ``MMA_MAX_WAVES``
    waves, and the fewest splits on a tie."""
    bm = next((b for b in sorted(step_us) if b >= t), max(step_us))
    tiles = -(-t // bm) * -(-d // MMA_BN)
    steps = -(-n // MMA_BK)
    best = None
    for splits in range(1, steps + 1):
        per = -(-steps // splits)
        if -(-steps // per) != splits:
            continue
        if splits > 1 and tiles * splits > MMA_MAX_WAVES * n_sms:
            break
        waves = -(-tiles * splits // n_sms)
        us = waves * per * step_us[bm]
        if splits > 1:
            us += (2 * splits + 1) * t * d * 4 / MMA_SCRATCH_RATE
        if best is None or us < best[0]:
            best = (us, MmaPlan(bm, MMA_BN, splits, per))
    return best[1]


def mma_tma(row_bytes: int, vptr: int, sptr: int, blocked: bool) -> bool:
    """Can the tensor-core body read a plane's weights by TMA boxes?  Value
    rows ``row_bytes`` apart (d, or kernel 3's td; scale rows twice that)
    and both pointers on 16 bytes, and blocked, a td that the 128-column
    tile divides (a box never crosses a column tile).  Else the producer
    warp copies them (:func:`_copy_width`)."""
    return (row_bytes % 16 == 0 and vptr % 16 == 0 and sptr % 16 == 0
            and (not blocked or row_bytes % MMA_BN == 0))


def _copy_width(row_bytes: int, ptr: int) -> int:
    """The widest cp.async (16, 8 or 4 bytes) that every row start of a
    plane with rows ``row_bytes`` apart from ``ptr`` allows; 0 when none
    does (the kernel then copies with plain loads)."""
    return next((w for w in (16, 8, 4) if row_bytes % w == 0 and ptr % w == 0), 0)


@functools.cache
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _require(cond: bool, msg: str, who: str = "q40_matmul") -> None:
    if not cond:
        raise ValueError(f"{who}: {msg}")


def plane_index(planes: torch.Tensor, layer, dev: torch.device, who: str,
                plane_dims: int = 2) -> tuple[torch.Tensor, int]:
    """The plane a kernel reads, as a (1,) int32 tensor on ``dev``, and the
    plane count of ``planes`` (the product of its leading dims; a plane has
    ``plane_dims`` trailing dims: 2 row-major, 4 blocked).  ``layer`` None
    is the one plane of an unstacked tensor; a Python int becomes a view
    into the device's index table (:func:`device.index_view`); an int32
    device tensor (an expert id computed on the card) passes as it is, and
    the kernel clamps it to the plane count.  No path reads the device."""
    if layer is None:
        if planes.dim() != plane_dims:
            raise ValueError(f"{who}: a stacked plane needs a layer index")
        return index_view(dev, 0, 1), 1
    if planes.dim() <= plane_dims:
        raise ValueError(f"{who}: layer index given for an unstacked "
                         f"{plane_dims}-D plane")
    n_planes = int(np.prod(planes.shape[:-plane_dims]))
    if isinstance(layer, torch.Tensor):
        if not (layer.device == dev and layer.dtype == torch.int32 and layer.numel() == 1):
            raise ValueError(f"{who}: a tensor index must be one int32 on {dev}, got "
                             f"{layer.dtype} {tuple(layer.shape)} on {layer.device}")
        return layer, n_planes
    layer = int(layer)
    if not 0 <= layer < n_planes:
        raise ValueError(f"{who}: layer {layer} outside 0..{n_planes - 1}")
    return index_view(dev, layer, n_planes), n_planes


def q40_matmul(x2: torch.Tensor, qpacked: torch.Tensor, scales: torch.Tensor,
               n: int, layer=None, body: str | None = None,
               variant: str | None = None) -> torch.Tensor:
    """Launch the Q40 dequant-matmul kernel: ``bf16(x2) (t, n) @ W`` → f32
    ``(t, d)``, reading plane ``layer`` of stacked ``(..., np/2, d)`` planes
    in place (a flat index over the leading dims, a Python int or an int32
    device tensor, see :func:`plane_index`), or the 2-D plane when
    ``layer`` is None.  The body is :func:`route`'s for ``t`` rows;
    ``body`` ("gemv" or "mma") names one, to time the two against each
    other.  ``variant`` names the numerics (the module docstring); None
    takes the routing's for ``t`` rows (:func:`variant_for`).  CUDA tensors
    only: it launches the kernel or raises; it never computes on another
    path."""
    global kernel_launches
    mma = _body(body, x2) == "mma"
    t = x2.shape[0]
    variant = check_variant(variant) if variant else variant_for(t)
    out = launch("q40_matmul_mma" if mma else "q40_matmul", x2, qpacked, scales, n, layer,
                 torch.uint8, 2, _launch_wgmma if mma else None,
                 tail=(VARIANTS.index(variant),))
    key = ("mma", n, out.shape[1]) if mma else (n, out.shape[1])
    with COUNT_LOCK:
        kernel_launches += 1
        _count(key if variant == "classic" else key + (variant,))
    return out


def _body(body: str | None, x2: torch.Tensor) -> str:
    """``body``, or :func:`route`'s for ``x2``'s rows; raises on a name
    that is neither body."""
    body = body or route(x2.shape[0])
    if body not in ("gemv", "mma"):
        raise ValueError(f"q40_matmul: unknown body {body!r}")
    return body


def _count(key: tuple) -> None:
    """One launch under ``launches_by_shape`` ``key``; a key of the
    tensor-core body also counts in ``mma_launches``."""
    global mma_launches
    launches_by_shape[key] = launches_by_shape.get(key, 0) + 1
    if key[0] in ("mma", "blocked-mma"):
        mma_launches += 1


def q40_blocked_matmul(x2: torch.Tensor, qpacked: torch.Tensor, scales: torch.Tensor,
                       nd: tuple[int, int], layer=None, body: str | None = None
                       ) -> torch.Tensor:
    """Launch kernel 3, the Q40 dequant-matmul over blocked planes:
    ``bf16(x2) (t, n) @ W`` → f32 ``(t, d)`` for logical ``nd = (n, d)``,
    reading plane ``layer`` of ``qpacked`` ``(L, n2/bn, dp/td, bn, td)`` and
    ``scales`` ``(L, n2/bn, dp/td, bn/16, td)`` in place (a Python int or an
    int32 device tensor; None for the one plane of an L = 1 tensor).  The
    kernel takes every tile :func:`to_blocked` makes with ``td`` a multiple
    of 4 (``tn`` is a multiple of 32 there); it writes only the ``d``
    logical columns.  ``body`` as :func:`q40_matmul`'s: both bodies run the
    plan of the logical ``(n, d)``, so each equals kernels 1–2's bit for
    bit.  CUDA tensors only: it launches the kernel or raises."""
    global blocked_launches
    body = _body(body, x2)
    fn = "q40_matmul_blocked" + ("_mma" if body == "mma" else "")
    n, d = nd

    def req(cond, msg):
        _require(cond, msg, fn)

    dev = _check_operands(fn, x2, qpacked, scales, n, torch.uint8)
    req(qpacked.dim() == 5, f"values {tuple(qpacked.shape)} are not (L, nI, nJ, bn, td)")
    L, nI, nJ, bn, td = qpacked.shape
    req(bn % 16 == 0 and td % 4 == 0,
        f"tiles (tn={2 * bn}, td={td}): the kernel needs tn a multiple of 32, td of 4")
    req(tuple(scales.shape) == (L, nI, nJ, bn // 16, td),
        f"scales shape {tuple(scales.shape)} does not match values {tuple(qpacked.shape)}")
    np_ = nI * bn * 2
    req(np_ >= n and d <= nJ * td,
        f"planes {tuple(qpacked.shape)} do not cover (n, d) = {tuple(nd)}")
    if layer is None:
        req(L == 1, "a stacked blocked plane needs a layer index")
        idx, n_planes = index_view(dev, 0, 1), 1
    else:
        idx, n_planes = plane_index(qpacked, layer, dev, fn, plane_dims=4)
    if body == "mma":
        out = _launch_wgmma(fn, x2, qpacked, scales, idx, n, np_, d, n_planes, td, bn, td, nJ)
    else:
        out = _launch_gemv(fn, x2, qpacked, scales, idx, n, np_, d, n_planes, 2, td,
                           bn, td, nJ)
    with COUNT_LOCK:
        blocked_launches += 1
        _count(("blocked-mma" if body == "mma" else "blocked", n, d))
    return out


def _check_operands(fn: str, x2: torch.Tensor, values: torch.Tensor,
                    scales: torch.Tensor, n: int, value_dtype: torch.dtype
                    ) -> torch.device:
    """The operand checks every matmul kernel shares; returns x's device.
    Raises on anything the kernel does not take, a CPU tensor first."""
    def req(cond, msg):
        _require(cond, msg, fn)

    req(x2.is_cuda, f"x must be a CUDA tensor, got device {x2.device}")
    dev = x2.device
    req(values.device == dev and scales.device == dev,
        "x, values and scales must be on one device")
    req(values.dtype == value_dtype, f"values dtype {values.dtype} != {value_dtype}")
    req(scales.dtype == torch.float16, f"scales dtype {scales.dtype} != float16")
    req(values.is_contiguous() and scales.is_contiguous(),
        "values and scales must be contiguous")
    req(values.data_ptr() % 4 == 0 and scales.data_ptr() % 8 == 0,
        "values/scales not aligned for the kernel's vector loads")
    req(x2.dim() == 2 and x2.shape[1] == n, f"x shape {tuple(x2.shape)} != (t, {n})")
    req(x2.shape[0] >= 1, "x has no rows")
    req(n % 32 == 0, f"n={n} not a multiple of 32")
    return dev


def launch(fn: str, x2: torch.Tensor, values: torch.Tensor, scales: torch.Tensor,
           n: int, layer, value_dtype: torch.dtype, per_byte: int,
           mma=None, tail: tuple = ()) -> torch.Tensor:
    """Check the operands of the Q40 or Q80 kernel over row-major planes (C
    entry point ``fn``, values of ``value_dtype`` holding ``per_byte``
    weights a byte: 2 for Q40's nibbles, 1 for Q80's int8) and launch its
    GEMV body, or with ``mma`` (the tensor-core launcher,
    :func:`_launch_wgmma`, with the codec's plan) its tensor-core body, on
    the current stream; ``tail`` ints follow the entry point's own
    (the Q40 variant's index in :data:`VARIANTS`).  Returns the f32 ``(t,
    d)`` output."""
    dev = _check_operands(fn, x2, values, scales, n, value_dtype)
    idx, n_planes = plane_index(values, layer, dev, fn)
    np_ = values.shape[-2] * per_byte
    d = values.shape[-1]
    _require(np_ >= n and np_ % 32 == 0,
             f"value rows {values.shape[-2]} do not cover n={n}", fn)
    _require(tuple(scales.shape) == tuple(values.shape[:-2]) + (np_ // 32, d),
             f"scales shape {tuple(scales.shape)} does not match values "
             f"{tuple(values.shape)}", fn)
    if mma:
        return mma(fn, x2, values, scales, idx, n, np_, d, n_planes, d, tail=tail)
    return _launch_gemv(fn, x2, values, scales, idx, n, np_, d, n_planes, per_byte, d,
                        tail=tail)


def _launch_gemv(fn: str, x2: torch.Tensor, values: torch.Tensor, scales: torch.Tensor,
                 idx: torch.Tensor, n: int, np_: int, d: int, n_planes: int, per_byte: int,
                 row_bytes: int, *layout: int, tail: tuple = ()) -> torch.Tensor:
    """Call decode-body entry point ``fn`` (the Q40 or Q80 kernel's, values
    of ``per_byte`` weights a byte) on checked operands with
    :func:`gemv_plan`; value rows start ``row_bytes`` apart (d row-major,
    td blocked), which sets the load width; ``layout`` ints follow it
    (kernel 3's tile shape), then ``tail`` ints (:func:`launch`).  One
    launch for up to ``GEMV_ROWS`` rows (one a group of them above); raises
    on a launch error."""
    from . import _build
    lib = _build.load()
    dev, t = x2.device, x2.shape[0]
    xb = x2.to(torch.bfloat16).contiguous()
    splits, per = gemv_plan(n, d, _sm_count(dev), per_byte)
    part, count = _gemv_workspace(dev, splits, t, d, per_byte)
    vw = _gemv_width(row_bytes, values.data_ptr(), scales.data_ptr(), GEMV_COLS[per_byte] // 8)
    out = torch.empty((t, d), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        for g0 in range(0, t, GEMV_ROWS):
            tg = min(GEMV_ROWS, t - g0)
            rc = getattr(lib, fn)(xb[g0:].data_ptr(), values.data_ptr(), scales.data_ptr(),
                                  out[g0:].data_ptr(), idx.data_ptr(), part.data_ptr(),
                                  count.data_ptr(), tg, n, np_, d, n_planes, splits, per, vw,
                                  *layout, *tail, stream)
            if rc != 0:
                raise RuntimeError(f"{fn} launch failed: CUDA error {rc} "
                                   f"({lib.q40_error_string(rc).decode()}) at t={t} n={n} "
                                   f"d={d} splits={splits}x{per} width={vw} layout={layout}"
                                   f" tail={tail}")
    return out


def _launch_wgmma(fn: str, x2: torch.Tensor, values: torch.Tensor, scales: torch.Tensor,
                  idx: torch.Tensor, n: int, np_: int, d: int, n_planes: int,
                  row_bytes: int, *layout: int, tail: tuple = (), codec=None) -> torch.Tensor:
    """Call the tensor-core entry point ``fn`` (Q40 kernels 1-2, kernel 3
    with its tile shape in ``layout``, or Q80 kernels 5-6) on checked
    operands with ``codec``'s ``mma_plan`` (this module's, or ``q8``'s;
    looked up at each call); value rows start ``row_bytes`` apart (d
    row-major, td blocked), which decides whether the weights go by TMA
    (:func:`mma_tma`) or by the producer's copies of the widths
    :func:`_copy_width` allows; ``tail`` holds the Q40 variant's index.
    Returns the f32 ``(t, d)`` output; raises on a blocked tile the body
    cannot copy and on a launch error."""
    from . import _build
    lib = _build.load()
    dev, t = x2.device, x2.shape[0]
    xb = x2.to(torch.bfloat16).contiguous()
    if xb.data_ptr() % 16:  # the x tiles are TMA boxes
        xb = xb.clone()
    tma = mma_tma(row_bytes, values.data_ptr(), scales.data_ptr(), bool(layout))
    w_al = _copy_width(row_bytes, values.data_ptr())
    s_al = _copy_width(2 * row_bytes, scales.data_ptr())
    _require(not layout or tma or (w_al and s_al),
             f"tiles of {row_bytes} columns: no copy width divides them", fn)
    plan = (codec or sys.modules[__name__]).mma_plan(t, n, d, _sm_count(dev))
    out = torch.empty((t, d), dtype=torch.float32, device=dev)
    scratch = (torch.empty((plan.splits, t, d), dtype=torch.float32, device=dev)
               if plan.splits > 1 else out)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = getattr(lib, fn)(xb.data_ptr(), values.data_ptr(), scales.data_ptr(),
                              out.data_ptr(), scratch.data_ptr(), idx.data_ptr(),
                              t, n, np_, d, n_planes, plan.bm, plan.splits, plan.steps_per,
                              int(tma), w_al, s_al, *layout, *tail, stream)
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed: CUDA error {rc} "
                           f"({lib.q40_error_string(rc).decode()}) at t={t} n={n} d={d} "
                           f"{plan} tma={tma} copies={w_al}/{s_al} layout={layout} "
                           f"tail={tail}")
    return out


def mma_layout(bm: int, fn: str = "q40_mma_layout") -> dict:
    """The tensor-core body's block at tile height ``bm`` as the build
    reports it (``fn``: this codec's ``q40_mma_layout``, or Q80's
    ``q8_mma_layout``): threads, dynamic shared memory, ring stages."""
    from . import _build
    out = (ctypes.c_int * 3)()
    rc = getattr(_build.load(), fn)(bm, out)
    if rc != 0:
        raise ValueError(f"{fn}: no tile of {bm} rows")
    return dict(zip(("threads", "smem", "stages"), out))


# ---------------------------------------------------------------------------
# Tensor parallelism: the slicing rule and kernel 4, the all-reduce of the
# column-sharded matmuls' f32 partial sums (csrc/tp_allreduce.cu)
# ---------------------------------------------------------------------------

# most ranks a call takes: must match kMaxTp in the source
TP_MAX = 8


def tp_shardable(n: int, d: int, kind: str | None, tp: int) -> bool:
    """Can a packed ``(n, d)`` weight be sliced over ``tp`` ranks (the JAX
    package's ``_tp_shardable``)?  ``"row"`` slices the output dim, which
    must divide; ``"col"`` slices the input dim, and a rank's slice must
    hold whole 32-row quantization blocks.  The port slices ``col`` at the
    logical ``n`` (the reference's ColMatmulSlice), not at the pack-time
    padded row count as the JAX package does, so every rank's slice of the
    activations meets its own rows."""
    if kind == "row":
        return d % tp == 0
    if kind == "col":
        return n % (32 * tp) == 0
    return False


def tp_allreduce_plain(parts: list[torch.Tensor], ranks=None) -> list[torch.Tensor]:
    """The plain version of kernel 4: rank ``r``'s sum of the ``tp``
    partials ``(..., d)`` on rank ``r``'s device, with the TPU ring's adds
    in its order — the first half of the columns from the left neighbour,
    ``((x_r + x_{r-1}) + x_{r-2}) + ...``, the second half from the right
    one, ``((x_r + x_{r+1}) + ...)`` (indices mod tp, ``h = d // 2``).
    ``ranks`` (default all) names the ranks whose sums are returned."""
    tp = len(parts)
    h = parts[0].shape[-1] // 2
    outs = []
    for r in (range(tp) if ranks is None else ranks):
        own = parts[r]
        lo, hi = own[..., :h].clone(), own[..., h:].clone()
        for s in range(1, tp):
            lo = lo + parts[(r - s) % tp][..., :h].to(own.device)
            hi = hi + parts[(r + s) % tp][..., h:].to(own.device)
        outs.append(torch.cat([lo, hi], dim=-1))
    return outs


allreduce_launches = 0
allreduce_plain_calls = 0
allreduce_ipc_launches = 0
allreduce_gloo_calls = 0
_peers_enabled: set[tuple[int, int]] = set()
# seconds the cross-process body waits for a peer's partial before it traps
IPC_TIMEOUT_S = 5.0


def tp_allreduce(parts: list[torch.Tensor], impl: str = "auto",
                 mesh=None) -> list[torch.Tensor]:
    """Sum the ranks' f32 partials: ``parts[j]`` ``(..., d)`` lies on local
    rank ``j``'s device; returns each local rank's sum
    (:func:`tp_allreduce_plain`'s function) on its device.  In one process
    (``mesh`` None, or of one process) CPU tensors, or ``impl="plain"``
    (the reference path of a comparison on the card, as :func:`matmul`'s),
    take the plain version; CUDA tensors launch kernel 4
    (:func:`tp_allreduce_kernel`), which raises on anything it does not
    take.  Over a mesh that spans processes: CPU tensors or ``"plain"``
    take :func:`tp_allreduce_group_plain`, CUDA tensors the cross-process
    body (:func:`tp_allreduce_ipc`)."""
    global allreduce_plain_calls, allreduce_gloo_calls
    if impl not in ("auto", "plain"):
        raise ValueError(f"unknown tp_allreduce impl {impl!r}")
    multi = mesh is not None and mesh.multi
    if impl == "plain" or all(p.device.type == "cpu" for p in parts):
        with COUNT_LOCK:
            allreduce_plain_calls += 1
            allreduce_gloo_calls += multi
        return tp_allreduce_group_plain(parts, mesh) if multi else tp_allreduce_plain(parts)
    return tp_allreduce_ipc(parts, mesh) if multi else tp_allreduce_kernel(parts)


def tp_allreduce_group_plain(parts: list[torch.Tensor], mesh) -> list[torch.Tensor]:
    """The plain version across processes: every rank's partial gathered
    over gloo (``all_gather``), then :func:`tp_allreduce_plain`'s adds for
    this process's ranks — the one-process plain version's sums, bit for
    bit."""
    from ..parallel import comm
    every = comm.all_gather(mesh, [p.cpu() for p in parts])
    sums = tp_allreduce_plain(every, mesh.ranks)
    return [s.to(p.device) for s, p in zip(sums, parts)]


def allreduce_regions(mesh, d: int):
    """The group's kernel-4 regions (``parallel.comm.RankRegions``), made at
    the first call (a collective point: every process makes the same
    calls) with two parities of ``max_rows × d`` f32 a rank, ``max_rows``
    the rows the group's engines reserved (``Group.reserve_rows``)."""
    from ..parallel import comm
    regions = mesh.group.regions
    if "allreduce" not in regions:
        rows = mesh.group.max_rows
        _require(rows > 0, "no rows reserved for the communication region "
                 "(Group.reserve_rows: an Engine over the mesh reserves its largest "
                 "forward)", "tp_allreduce_ipc")
        cap = -(-rows * d // 4) * 4
        regions["allreduce"] = comm.RankRegions(mesh, comm.REGION_HEAD + 2 * cap * 4)
    return regions["allreduce"]


def tp_allreduce_ipc(parts: list[torch.Tensor], mesh) -> list[torch.Tensor]:
    """Kernel 4 across processes: this process's ranks' partials (CUDA,
    on one card) copied into their IPC regions, every rank's read from the
    regions and summed in the ring order (one launch on the current
    stream; ``csrc/tp_allreduce.cu``).  Raises for a call larger than the
    region (no fallback) and for local ranks on more than one card.  Each
    launch adds one to ``allreduce_launches`` and to
    ``allreduce_ipc_launches``."""
    global allreduce_launches, allreduce_ipc_launches
    fn = "tp_allreduce_ipc"

    def req(cond, msg):
        _require(cond, msg, fn)

    tp = mesh.tp
    req(2 <= tp <= TP_MAX, f"{tp} ranks outside 2..{TP_MAX}")
    req(len(parts) == len(mesh.devices), f"{len(parts)} partials for "
        f"{len(mesh.devices)} local ranks")
    shape = parts[0].shape
    d = shape[-1] if len(shape) else 0
    for p in parts:
        req(p.is_cuda, f"every partial must be a CUDA tensor, got device {p.device}")
        req(p.dtype == torch.float32, f"partial dtype {p.dtype} != float32")
        req(p.shape == shape, f"partial shapes differ: {tuple(p.shape)} != {tuple(shape)}")
        req(p.is_contiguous(), "partials must be contiguous")
    req(d >= 2 and d % 2 == 0, f"d={d} must be even")
    dev = parts[0].device
    req(all(p.device == dev for p in parts), "this process's ranks must share one card "
        f"for the cross-process body, got {[p.device for p in parts]}")
    t = parts[0].numel() // d
    from ..parallel import comm
    reg = allreduce_regions(mesh, d)
    cap = (reg.nbytes - comm.REGION_HEAD) // 8  # f32 a parity
    req(t * d <= cap, f"a call of {t} rows at d={d} is more than the communication "
        f"region holds: max_rows {cap // d} at d={d} (the group reserved "
        f"{mesh.group.max_rows} rows)")
    outs = [torch.empty_like(p) for p in parts]
    vec = 4 if (d // 2) % 4 == 0 and all(o.data_ptr() % 16 == 0 for o in outs) else 1
    reg.gen += 1
    arr = ctypes.c_void_p
    ins = (arr * len(parts))(*(p.data_ptr() for p in parts))
    out_ptrs = (arr * len(outs))(*(o.data_ptr() for o in outs))
    bases = (arr * tp)(*reg.base)
    from . import _build
    lib = _build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.tp_allreduce_ipc(ins, out_ptrs, bases, tp, mesh.rank0, len(parts),
                                  cap, t, d, vec, reg.gen,
                                  int(IPC_TIMEOUT_S * 1e9), stream)
    if rc != 0:
        raise RuntimeError(f"{fn} launch failed: CUDA error {rc} "
                           f"({lib.q40_error_string(rc).decode()}) at tp={tp} t={t} d={d} "
                           f"ranks {mesh.rank0}..{mesh.rank0 + len(parts) - 1}")
    with COUNT_LOCK:
        allreduce_launches += 1
        allreduce_ipc_launches += 1
    return outs


def tp_allreduce_kernel(parts: list[torch.Tensor]) -> list[torch.Tensor]:
    """Launch kernel 4.  Ranks on one card: one launch on the current
    stream.  Ranks on distinct cards (one rank a card): one launch a rank
    on its card's current stream, ordered after every peer's partial and
    reading it through a peer pointer; raises when two cards have no peer
    access (nothing is staged through the host).  Each launch adds one to
    ``allreduce_launches``."""
    global allreduce_launches
    fn = "tp_allreduce"

    def req(cond, msg):
        _require(cond, msg, fn)

    tp = len(parts)
    req(2 <= tp <= TP_MAX, f"{tp} ranks outside 2..{TP_MAX}")
    shape = parts[0].shape
    d = shape[-1] if len(shape) else 0
    for p in parts:
        req(p.is_cuda, f"every partial must be a CUDA tensor, got device {p.device}")
        req(p.dtype == torch.float32, f"partial dtype {p.dtype} != float32")
        req(p.shape == shape, f"partial shapes differ: {tuple(p.shape)} != {tuple(shape)}")
        req(p.is_contiguous(), "partials must be contiguous")
    req(d >= 2 and d % 2 == 0, f"d={d} must be even")
    t = parts[0].numel() // d
    devs = [p.device for p in parts]
    one_card = len(set(devs)) == 1
    req(one_card or len(set(devs)) == tp,
        f"ranks must share one card or take one card each, got {devs}")
    outs = [torch.empty_like(p) for p in parts]
    vec = 4 if (d // 2) % 4 == 0 and all(
        a.data_ptr() % 16 == 0 for a in (*parts, *outs)) else 1
    arr = ctypes.c_void_p * tp
    ins = arr(*(p.data_ptr() for p in parts))
    out_ptrs = arr(*(o.data_ptr() for o in outs))
    from . import _build
    lib = _build.load()
    if one_card:
        launches = [(devs[0], 0, tp)]
    else:
        _enable_peers(lib, devs)
        ready = []
        for p in parts:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(p.device))
            ready.append(ev)
        for r, dev in enumerate(devs):
            stream = torch.cuda.current_stream(dev)
            for s, p in enumerate(parts):
                if s != r:
                    stream.wait_event(ready[s])
                    # the caching allocator must not hand a partial out
                    # again while a peer's launch still reads it
                    p.record_stream(stream)
        launches = [(dev, r, 1) for r, dev in enumerate(devs)]
    for dev, rank0, n_ranks in launches:
        stream = torch.cuda.current_stream(dev).cuda_stream
        with torch.cuda.device(dev):
            rc = lib.tp_allreduce(ins, out_ptrs, tp, rank0, n_ranks, t, d, vec, stream)
        if rc != 0:
            raise RuntimeError(f"{fn} launch failed: CUDA error {rc} "
                               f"({lib.q40_error_string(rc).decode()}) at tp={tp} "
                               f"t={t} d={d} ranks {rank0}..{rank0 + n_ranks - 1}")
        with COUNT_LOCK:
            allreduce_launches += 1
    return outs


def _enable_peers(lib: ctypes.CDLL, devs: list[torch.device]) -> None:
    """Peer access between every ordered pair of the ranks' cards, once."""
    for a in devs:
        for b in devs:
            key = (a.index, b.index)
            if a == b or key in _peers_enabled:
                continue
            rc = lib.tp_enable_peer(a.index, b.index)
            if rc == -1:
                raise RuntimeError(f"tp_allreduce: {a} cannot access {b}'s memory "
                                   "(no peer access between the cards); kernel 4 "
                                   "reads peers directly and has no host-staged path")
            if rc != 0:
                raise RuntimeError(f"tp_allreduce: enabling peer access {a} -> {b} "
                                   f"failed: CUDA error {rc} "
                                   f"({lib.q40_error_string(rc).decode()})")
            _peers_enabled.add(key)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' signatures (every pointer and the stream
    as ``c_void_p``, so ctypes never cuts a 64-bit pointer)."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    # the decode body: x, values, scales, out, the plane index, the
    # workspace (partials, counts); t, n, np, d, the plane count, the plan
    # (splits, blocks a split), the load width, the variant (VARIANTS index)
    lib.q40_matmul.argtypes = [vp] * 7 + [ci] * 9 + [vp]
    lib.q40_matmul.restype = ci
    # kernel 3: the same operands, then the tile shape (bn, td, nJ)
    lib.q40_matmul_blocked.argtypes = [vp] * 7 + [ci] * 11 + [vp]
    lib.q40_matmul_blocked.restype = ci
    # the tensor-core body: a scratch pointer before the plane index, the
    # plan (bm, splits, steps), TMA or not and the copy widths, then the
    # variant (kernels 1-2) or kernel 3's tile shape
    lib.q40_matmul_mma.argtypes = [vp] * 6 + [ci] * 12 + [vp]
    lib.q40_matmul_mma.restype = ci
    lib.q40_matmul_blocked_mma.argtypes = [vp] * 6 + [ci] * 14 + [vp]
    lib.q40_matmul_blocked_mma.restype = ci
    lib.q40_mma_layout.argtypes = [ci, ctypes.POINTER(ci)]
    lib.q40_mma_layout.restype = ci
    # kernel 4: host arrays of the tp input and output pointers
    lib.tp_allreduce.argtypes = [ctypes.POINTER(vp), ctypes.POINTER(vp)] + [ci] * 6 + [vp]
    lib.tp_allreduce.restype = ci
    lib.tp_enable_peer.argtypes = [ci, ci]
    lib.tp_enable_peer.restype = ci
    lib.q40_error_string.argtypes = [ci]
    lib.q40_error_string.restype = ctypes.c_char_p
    return lib
