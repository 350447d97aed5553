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

:func:`matmul` computes the ``classic`` contract of the JAX kernel: weights
``bf16(f32(v-8)·s)``, activations cast to bf16 first, products summed in
f32, an f32 result.  Dispatch:

* a CPU tensor → :func:`matmul_plain`, the plain PyTorch version;
* a CUDA tensor with ``rows <= PALLAS_MAX_ROWS`` → the kernel
  (:func:`q40_matmul`), which launches or raises;
* a CUDA tensor with more rows (long prefill) → dequantize to bf16 and one
  f32 ``torch.matmul`` — the JAX package's own dispatch rule, which leaves
  that product to XLA.

Module counters (plain ints) record which of the three ran:
``kernel_launches`` (and ``launches_by_shape`` keyed by logical ``(n, d)``),
``plain_calls`` and ``dense_prefill_calls``.  :func:`reset_counters` zeroes
them.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from .. import quants

# Pack-time padding granularity of the input dim (the JAX package's
# TILE_N default): padded rows carry zero scales, so the packed planes are
# byte-identical to the JAX package's.
TILE_N = 1024
# Row count up to which a CUDA tensor takes the kernel; above it the
# product is compute-bound and goes to one dense matmul.
PALLAS_MAX_ROWS = 128

kernel_launches = 0
plain_calls = 0
dense_prefill_calls = 0
launches_by_shape: dict[tuple[int, int], int] = {}


def reset_counters() -> None:
    global kernel_launches, plain_calls, dense_prefill_calls
    kernel_launches = plain_calls = dense_prefill_calls = 0
    launches_by_shape.clear()


def counters() -> dict:
    return {"kernel_launches": kernel_launches, "plain_calls": plain_calls,
            "dense_prefill_calls": dense_prefill_calls,
            "launches_by_shape": dict(launches_by_shape)}


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


def _check_finite(sc: np.ndarray, what: str) -> None:
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


def _from_np(packed: np.ndarray, sc: np.ndarray, nd: tuple[int, int]) -> QTensor:
    return QTensor(torch.from_numpy(np.ascontiguousarray(packed)),
                   torch.from_numpy(np.ascontiguousarray(sc, np.float16)), nd)


def pack_planes(qvals: np.ndarray, scales: np.ndarray) -> QTensor:
    packed, sc, nd = pack_planes_np(qvals, scales)
    _check_finite(sc, "scale (|block amax| > 8*65504, or NaN)")
    return _from_np(packed, sc, nd)


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
    _check_finite(sc, "scale plane")
    if not stacked:
        if L != 1:
            raise ValueError("stacked=False needs exactly one group")
        return _from_np(qp[0], sc[0], (n, d_total))
    return _from_np(qp, sc, (n, d_total))


def _planes(qt: QTensor, layer: int | None) -> tuple[torch.Tensor, torch.Tensor]:
    """The 2-D planes of ``qt`` (a view of layer ``layer`` of a stacked
    QTensor; no copy)."""
    if layer is None:
        if qt.qpacked.dim() != 2:
            raise ValueError(f"a stacked QTensor {qt.shape} needs a layer index")
        return qt.qpacked, qt.scales
    if qt.qpacked.dim() != 3:
        raise ValueError(f"layer index given for a non-stacked QTensor {qt.shape}")
    return qt.qpacked[layer], qt.scales[layer]


def dequantize(qt: QTensor, dtype=torch.float32, layer: int | None = None) -> torch.Tensor:
    """Reconstruct the dense array (of one layer of a stacked QTensor when
    ``layer`` is given): ``f32(v-8)·f32(s)``, then cast to ``dtype`` —
    bit-identical to the JAX package's ``dequantize``; the f16→f32 widening
    is exact, subnormals included."""
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


def matmul_plain(x2: torch.Tensor, qt: QTensor, layer: int | None = None) -> torch.Tensor:
    """The plain version: ``bf16(x) (t, n) @ bf16(W) (n, d)`` with products
    summed in f32, result f32.  Both bf16 operands are widened to f32 before
    the product (exact), because a bf16×bf16 ``torch.matmul`` rounds its
    result to bf16."""
    w = dequantize(qt, torch.bfloat16, layer)
    return torch.matmul(x2.to(torch.bfloat16).to(torch.float32),
                        w.to(torch.float32))


def matmul(x: torch.Tensor, qt: QTensor, layer: int | None = None,
           out_dtype=None, impl: str = "auto") -> torch.Tensor:
    """``x @ dequantize(qt)`` with f32 accumulation.

    x: (..., n); ``qt`` logical (n, d), 2-D, or stacked with ``layer`` the
    index into its ``(L, n/2, d)`` planes (the counterpart of the JAX
    package's ``QLayerView``).  Returns (..., d) in ``out_dtype`` (default
    ``x.dtype``).  ``impl="plain"`` runs the plain version on any device —
    the reference path that a comparison on the card holds the kernel
    against; ``"auto"`` dispatches as the module docstring says."""
    global plain_calls, dense_prefill_calls
    if impl not in ("auto", "plain"):
        raise ValueError(f"unknown q40 matmul impl {impl!r}")
    n, d = qt.logical_nd
    lead = x.shape[:-1]
    rows = int(np.prod(lead)) if lead else 1
    out_dtype = out_dtype or x.dtype
    x2 = x.reshape(rows, n)
    if impl == "plain" or x.device.type == "cpu":
        plain_calls += 1
        out = matmul_plain(x2, qt, layer)
    elif rows <= PALLAS_MAX_ROWS:
        out = q40_matmul(x2, qt.qpacked, qt.scales, n, layer)
    else:
        dense_prefill_calls += 1
        out = matmul_plain(x2, qt, layer)
    return out.reshape(*lead, d).to(out_dtype)


# ---------------------------------------------------------------------------
# The CUDA kernel (csrc/q40_matmul.cu) and its wrapper
# ---------------------------------------------------------------------------

# Output columns one thread block covers (128 threads × 4 columns): must
# match kThreads * kCols in the source.
BLOCK_COLS = 512
# Thread blocks per SM the reduction split aims for: enough resident warps
# to keep the packed-plane loads in flight at decode.
BLOCKS_PER_SM = 8


def split_plan(n: int, d: int, n_sms: int) -> tuple[int, int]:
    """How the kernel splits the reduction over ``n``: returns ``(splits,
    blocks_per_split)`` in 32-row quantization blocks.  At decode a grid of
    ``ceil(d / 512)`` column blocks alone is too few for the card's SMs
    (8 for d = 4096 against 132), so the reduction is cut into splits until
    the grid holds about ``BLOCKS_PER_SM`` blocks per SM; the splits'
    partial sums are added in a fixed order by a second pass, so results
    repeat bit for bit."""
    nb = n // 32
    col_blocks = -(-d // BLOCK_COLS)
    want = max(1, min(nb, -(-BLOCKS_PER_SM * n_sms // col_blocks)))
    per = -(-nb // want)
    return -(-nb // per), per


@functools.cache
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"q40_matmul: {msg}")


def q40_matmul(x2: torch.Tensor, qpacked: torch.Tensor, scales: torch.Tensor,
               n: int, layer: int | None = None) -> torch.Tensor:
    """Launch the Q40 dequant-matmul kernel: ``bf16(x2) (t, n) @ W`` → f32
    ``(t, d)``, reading layer ``layer`` of a stacked ``(L, np/2, d)`` plane
    in place (or the 2-D plane when ``layer`` is None).  CUDA tensors only:
    it launches the kernel or raises; it never computes on another path."""
    global kernel_launches
    _require(x2.is_cuda, f"x must be a CUDA tensor, got device {x2.device}")
    dev = x2.device
    _require(qpacked.device == dev and scales.device == dev,
             "x, qpacked and scales must be on one device")
    _require(qpacked.dtype == torch.uint8, f"qpacked dtype {qpacked.dtype} != uint8")
    _require(scales.dtype == torch.float16, f"scales dtype {scales.dtype} != float16")
    _require(qpacked.is_contiguous() and scales.is_contiguous(),
             "qpacked and scales must be contiguous")
    _require(qpacked.data_ptr() % 4 == 0 and scales.data_ptr() % 8 == 0,
             "qpacked/scales not aligned for the kernel's vector loads")
    _require(x2.dim() == 2 and x2.shape[1] == n, f"x shape {tuple(x2.shape)} != (t, {n})")
    t = x2.shape[0]
    _require(1 <= t <= PALLAS_MAX_ROWS, f"{t} rows outside 1..{PALLAS_MAX_ROWS}")
    _require(n % 32 == 0, f"n={n} not a multiple of 32")
    if layer is None:
        _require(qpacked.dim() == 2, "a stacked plane needs a layer index")
        layer_i = 0
    else:
        _require(qpacked.dim() == 3, "layer index given for a 2-D plane")
        layer_i = int(layer)
        _require(0 <= layer_i < qpacked.shape[0],
                 f"layer {layer_i} outside 0..{qpacked.shape[0] - 1}")
    np_ = qpacked.shape[-2] * 2
    d = qpacked.shape[-1]
    _require(np_ >= n and np_ % 32 == 0, f"packed rows {np_ // 2} do not cover n={n}")
    _require(tuple(scales.shape) == tuple(qpacked.shape[:-2]) + (np_ // 32, d),
             f"scales shape {tuple(scales.shape)} does not match qpacked "
             f"{tuple(qpacked.shape)}")
    from . import _build
    lib = _build.load()
    xb = x2.to(torch.bfloat16).contiguous()
    splits, per = split_plan(n, d, _sm_count(dev))
    out = torch.empty((t, d), dtype=torch.float32, device=dev)
    scratch = (torch.empty((splits, t, d), dtype=torch.float32, device=dev)
               if splits > 1 else out)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.q40_matmul(xb.data_ptr(), qpacked.data_ptr(), scales.data_ptr(),
                            out.data_ptr(), scratch.data_ptr(), t, n, np_, d,
                            layer_i, splits, per, stream)
    if rc != 0:
        raise RuntimeError(f"q40_matmul launch failed: CUDA error {rc} "
                           f"({lib.q40_error_string(rc).decode()}) at "
                           f"t={t} n={n} d={d} splits={splits}")
    kernel_launches += 1
    launches_by_shape[(n, d)] = launches_by_shape.get((n, d), 0) + 1
    return out


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' signatures (every pointer and the stream
    as ``c_void_p``, so ctypes never cuts a 64-bit pointer)."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.q40_matmul.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci,
                               ctypes.c_longlong, ci, ci, vp]
    lib.q40_matmul.restype = ci
    lib.q40_error_string.argtypes = [ci]
    lib.q40_error_string.restype = ctypes.c_char_p
    return lib
