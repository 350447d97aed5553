"""Block-quantization formats (Q40 / Q80 / F16 / F32).

A copy of ``dllama_tpu/quants.py`` (the port imports nothing of that
package), trimmed to what the port's loader and writer use:

* ``Q40``: blocks of 32 values stored as one f16 scale + 16 bytes of packed
  4-bit nibbles (18 bytes / block).  ``delta = amax/-8``,
  ``q = clamp(floor(x/delta + 8.5), 0, 15)``; value ``i`` goes into the low
  nibble of byte ``i`` and value ``i+16`` into the high nibble.
* ``Q80``: blocks of 32 values stored as one f16 scale + 32 int8
  (34 bytes / block).  ``delta = amax/127``, ``q = round(x/delta)``.

The storage layout is byte-compatible with the reference `.m` files.
"""

from __future__ import annotations

import numpy as np

# FloatType enum values — serialized into `.m` headers.
F32 = 0
F16 = 1
Q40 = 2
Q80 = 3

BLOCK_SIZE = 32
Q40_BLOCK_BYTES = 2 + BLOCK_SIZE // 2  # f16 scale + 16 nibble-pairs = 18
Q80_BLOCK_BYTES = 2 + BLOCK_SIZE      # f16 scale + 32 int8 = 34

FLOAT_TYPE_NAMES = {F32: "f32", F16: "f16", Q40: "q40", Q80: "q80"}
FLOAT_TYPE_BY_NAME = {v: k for k, v in FLOAT_TYPE_NAMES.items()}


def batch_bytes(ftype: int, n: int, d: int = 1) -> int:
    """Bytes needed to store a ``d × n`` tensor in ``ftype``.  For block
    formats ``n`` must be a multiple of the 32-element block size."""
    if ftype == F32:
        return 4 * n * d
    if ftype == F16:
        return 2 * n * d
    if ftype in (Q40, Q80):
        if n % BLOCK_SIZE != 0:
            raise ValueError(f"{FLOAT_TYPE_NAMES[ftype]} row length {n} not "
                             f"divisible by {BLOCK_SIZE}")
        per = Q40_BLOCK_BYTES if ftype == Q40 else Q80_BLOCK_BYTES
        return (n // BLOCK_SIZE) * per * d
    raise ValueError(f"unknown float type {ftype}")


def quantize_q40(x: np.ndarray) -> np.ndarray:
    """Quantize a flat f32 array to Q40 bytes; returns uint8 of length
    ``(x.size/32) * 18``."""
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    if x.size % BLOCK_SIZE != 0:
        raise ValueError(f"size {x.size} not divisible by {BLOCK_SIZE}")
    groups = x.reshape(-1, BLOCK_SIZE)
    gmax = groups.max(axis=1)
    gmin = groups.min(axis=1)
    deltas = np.where(-gmin > gmax, gmin, gmax) / -8.0
    deltas16 = deltas.astype(np.float16)
    inv = np.where(deltas != 0, np.divide(1.0, deltas, where=deltas != 0), 0.0)
    q = groups * inv[:, None] + 8.5
    q = np.where(q < 15.0, q, 15.0)
    q = q.astype(np.uint8)  # truncation == floor for the non-negative range here
    lo = q[:, : BLOCK_SIZE // 2]
    hi = q[:, BLOCK_SIZE // 2:]
    packed = (lo & 0xF) | ((hi & 0xF) << 4)
    out = np.empty((groups.shape[0], Q40_BLOCK_BYTES), dtype=np.uint8)
    out[:, :2] = deltas16.view(np.uint8).reshape(-1, 2)
    out[:, 2:] = packed
    return out.reshape(-1)


def dequantize_q40(raw: np.ndarray, n: int) -> np.ndarray:
    """Dequantize Q40 bytes back to f32."""
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    n_blocks = n // BLOCK_SIZE
    if n % BLOCK_SIZE != 0 or raw.size != n_blocks * Q40_BLOCK_BYTES:
        raise ValueError(f"bad Q40 buffer: {raw.size} bytes for {n} values")
    blocks = raw.reshape(n_blocks, Q40_BLOCK_BYTES)
    d = blocks[:, :2].copy().view(np.float16).astype(np.float32)  # (B, 1)
    qs = blocks[:, 2:]
    lo = (qs & 0xF).astype(np.int8) - 8
    hi = (qs >> 4).astype(np.int8) - 8
    out = np.empty((n_blocks, BLOCK_SIZE), dtype=np.float32)
    out[:, : BLOCK_SIZE // 2] = lo.astype(np.float32) * d
    out[:, BLOCK_SIZE // 2:] = hi.astype(np.float32) * d
    return out.reshape(-1)


def round_half_away(v: np.ndarray) -> np.ndarray:
    """``roundf`` semantics — half away from zero — computed in float64,
    where every f32 product is exact."""
    v = np.asarray(v, np.float64)
    return np.trunc(v + np.copysign(0.5, v))


def quantize_q80(x: np.ndarray) -> np.ndarray:
    """Quantize a flat f32 array to Q80 bytes."""
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    if x.size % BLOCK_SIZE != 0:
        raise ValueError(f"size {x.size} not divisible by {BLOCK_SIZE}")
    groups = x.reshape(-1, BLOCK_SIZE)
    absmax = np.abs(groups).max(axis=1)
    deltas = absmax / 127.0
    deltas16 = deltas.astype(np.float16)
    inv = np.where(deltas != 0, np.divide(1.0, deltas, where=deltas != 0), 0.0)
    q = round_half_away(groups * inv[:, None]).astype(np.int8)
    out = np.empty((groups.shape[0], Q80_BLOCK_BYTES), dtype=np.uint8)
    out[:, :2] = deltas16.view(np.uint8).reshape(-1, 2)
    out[:, 2:] = q.view(np.uint8)
    return out.reshape(-1)


def dequantize_q80(raw: np.ndarray, n: int) -> np.ndarray:
    """Dequantize Q80 bytes back to f32."""
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    n_blocks = n // BLOCK_SIZE
    if n % BLOCK_SIZE != 0 or raw.size != n_blocks * Q80_BLOCK_BYTES:
        raise ValueError(f"bad Q80 buffer: {raw.size} bytes for {n} values")
    blocks = raw.reshape(n_blocks, Q80_BLOCK_BYTES)
    d = blocks[:, :2].copy().view(np.float16).astype(np.float32)
    q = blocks[:, 2:].view(np.int8).astype(np.float32)
    return (q * d).reshape(-1)


def quantize_tensor(x: np.ndarray, ftype: int) -> bytes:
    """Serialize a tensor (row-major, flattened) into ``ftype`` bytes."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    if ftype == F32:
        return x.tobytes()
    if ftype == F16:
        return x.astype(np.float16).tobytes()
    if ftype == Q40:
        return quantize_q40(x).tobytes()
    if ftype == Q80:
        return quantize_q80(x).tobytes()
    raise ValueError(f"unknown float type {ftype}")


def dequantize_tensor(raw: bytes | np.ndarray, ftype: int, n: int) -> np.ndarray:
    """Deserialize ``n`` values of ``ftype`` from raw bytes into f32."""
    buf = np.frombuffer(raw, dtype=np.uint8) if isinstance(raw, (bytes, memoryview)) else raw
    if ftype == F32:
        return buf.view(np.float32)[:n].astype(np.float32)
    if ftype == F16:
        return buf[: 2 * n].copy().view(np.float16).astype(np.float32)
    if ftype == Q40:
        return dequantize_q40(buf, n)
    if ftype == Q80:
        return dequantize_q80(buf, n)
    raise ValueError(f"unknown float type {ftype}")
