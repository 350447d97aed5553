"""Grouped-query attention over a contiguous KV cache or a paged KV pool —
the port of ``dllama_tpu/ops/attention.py``.

The contiguous cache layout is the JAX package's stacked
``(L, B, Hkv, S, Dh)``; the slot and paged halves (continuous batching)
are at the end of the module, with the fused paged-attention kernel
(``csrc/paged_attention.cu``).  Three contiguous algorithms, chosen by the
same rules as the JAX package:

* one-shot causal GQA (:func:`gqa_attention`): the whole score tensor at
  once;
* blocked online-softmax prefill (:func:`blocked_gqa_attention`) once the
  score tensor passes ``_BLOCKED_THRESHOLD`` elements per kv-head group;
* the length-aware decode walk (:func:`decode_gqa_attention`) for one
  query token over a cache of at least ``_DECODE_BLOCKED_MIN_S`` positions
  (Llama-2-7B's 4096 is one): a Python loop over only the KV blocks that
  hold live positions, so a decode step reads O(pos) of the cache.

Operands keep the cache's dtype (the query is cast to it) and every dot
accumulates in f32; the mask fill is the finite ``_NEG``, so a fully masked
row softmaxes to garbage instead of NaN and live rows are unaffected.  Both
the bf16 operands and the f32 products are widened to f32 before each
``einsum``: the products of bf16 values are exact in f32, so this is the
JAX package's "bf16 in, f32 accumulate" on every device.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..device import index_view
from . import COUNT_LOCK
from .kernels import softmax_f32
from .q40 import _sm_count

_BLOCKED_THRESHOLD = 1 << 21
_NEG = -1e30  # finite -inf stand-in (f32 -1e30): keeps the running max finite
_DECODE_BLOCKED_MIN_S = 4096


def _sqrt_dh(dh: int) -> float:
    return float(np.sqrt(np.float32(dh)))


def _kv_chunk(s: int) -> int:
    for c in (1024, 512, 256, 128):
        if s % c == 0:
            return c
    return s


def _use_blocked_decode(t: int, s: int) -> bool:
    """The length-aware decode walk serves one query token over a long
    cache; ``_kv_chunk(s) == s`` would be one step over the whole cache."""
    return t == 1 and s >= _DECODE_BLOCKED_MIN_S and _kv_chunk(s) < s


class DevicePos(NamedTuple):
    """A decode step's position read on the device, as a captured CUDA
    graph needs it: ``at`` is a 0-d int64 tensor (the cache position of
    the step's first token), ``bound`` the host's upper bound on it.  The
    bound alone sets how many blocks the decode walk reads
    (:func:`walk_bucket`); the mask and the KV write read ``at``."""
    at: torch.Tensor
    bound: int


def walk_bucket(pos: int, s: int) -> int:
    """The walk bucket of a single-token step at ``pos`` over a cache of
    ``s`` positions: the live ``_kv_chunk(s)`` blocks the decode walk
    reads (1..s/chunk; 4 buckets at Llama-2-7B's 4096), or 0 where the step
    takes the one-shot attention, which reads the whole cache."""
    if not _use_blocked_decode(1, s):
        return 0
    return min(max(pos, 0), s - 1) // _kv_chunk(s) + 1


def walk_bound(bucket: int, s: int) -> int:
    """The last position of walk bucket ``bucket`` (``s - 1`` for 0)."""
    return bucket * _kv_chunk(s) - 1 if bucket else s - 1


def _pos_at(pos):
    """The position a mask compares with: a Python int, or a DevicePos's
    device scalar."""
    return pos.at if isinstance(pos, DevicePos) else pos


def update_kv_cache_at(k_cache: torch.Tensor, v_cache: torch.Tensor,
                       k_new: torch.Tensor, v_new: torch.Tensor,
                       layer: int, pos) -> tuple[torch.Tensor, torch.Tensor]:
    """Write one layer's step KV (B, Hkv, T, Dh) into the stacked
    (L, B, Hkv, S, Dh) caches at ``(layer, pos)``.  Unlike the JAX package's
    functional update, the write is in place (only the (B, Hkv, T, Dh)
    window moves); the caches are returned for symmetry with it.  A
    :class:`DevicePos` writes through a device index (``index_copy_``),
    so the host never reads the position."""
    t = k_new.shape[2]
    if isinstance(pos, DevicePos):
        idx = pos.at + torch.arange(t, device=k_new.device)
        k_cache[layer].index_copy_(2, idx, k_new.to(k_cache.dtype))
        v_cache[layer].index_copy_(2, idx, v_new.to(v_cache.dtype))
        return k_cache, v_cache
    k_cache[layer, :, :, pos:pos + t] = k_new.to(k_cache.dtype)
    v_cache[layer, :, :, pos:pos + t] = v_new.to(v_cache.dtype)
    return k_cache, v_cache


def _einsum_f32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.einsum(eq, a.to(torch.float32), b.to(torch.float32))


def _online_fold(qf, kb, vb, mask, m, l, acc, scale):
    """Fold one KV block into the running (max, denom, numerator); ``mask``
    is (T, S) broadcast over (B, Hkv, G), or (B, T, S) for per-row
    ceilings."""
    scores = _einsum_f32("bhgtd,bhsd->bhgts", qf.to(kb.dtype), kb) * scale
    if mask.dim() == 2:
        mask = mask[None]
    scores = torch.where(mask[:, None, None], scores, _NEG)
    m_new = torch.maximum(m, scores.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(scores - m_new[..., None])
    l_new = alpha * l + p.sum(dim=-1)
    acc_new = alpha[..., None] * acc + _einsum_f32(
        "bhgts,bhsd->bhgtd", p.to(vb.dtype), vb)
    return m_new, l_new, acc_new


def _fold_init(b, hkv, g, t, dh, device):
    return (torch.full((b, hkv, g, t), _NEG, dtype=torch.float32, device=device),
            torch.zeros((b, hkv, g, t), dtype=torch.float32, device=device),
            torch.zeros((b, hkv, g, t, dh), dtype=torch.float32, device=device))


def blocked_gqa_attention(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, pos: int, q_len: int,
                          start: torch.Tensor | None = None) -> torch.Tensor:
    """Flash-style causal GQA over KV chunks with an online softmax: peak
    memory O(T·chunk) instead of O(T·S).  ``start`` (B,) masks key
    positions below a per-row floor (a ragged batch's left padding)."""
    b, hq, t, dh = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    c = _kv_chunk(s)
    scale = float(np.float32(1.0) / np.sqrt(np.float32(dh)))
    qf = q.to(torch.float32).reshape(b, hkv, g, t, dh)
    t_idx = pos + torch.arange(t, device=q.device)[:, None]
    m, l, acc = _fold_init(b, hkv, g, t, dh, q.device)
    for base in range(0, s, c):
        s_idx = base + torch.arange(c, device=q.device)[None, :]
        mask = s_idx <= t_idx  # (T, c)
        if start is not None:
            mask = mask[None] & (s_idx[None] >= start[:, None, None])  # (B, T, c)
        m, l, acc = _online_fold(qf, k_cache[:, :, base:base + c],
                                 v_cache[:, :, base:base + c], mask,
                                 m, l, acc, scale)
    out = acc / torch.clamp(l, min=1e-38)[..., None]
    return out.reshape(b, hq, t, dh).to(q.dtype)


def _slice_seq(cache, start: int, length: int):
    return cache[:, :, start:start + length]


def blocked_live_fold(qf, slice_block, k, v, pos: int, c: int,
                      row_pos: torch.Tensor | None = None,
                      block: int | None = None,
                      row_start: torch.Tensor | None = None, base: int = 0):
    """Walk only the KV blocks of a cache of length ``c`` that cover live
    positions ≤ ``pos``, folding each into the running softmax state.
    ``slice_block(cache, start, length)`` cuts one (B, Hkv, length, Dh)
    block out of ``k``/``v``.  ``row_pos`` (B,) replaces the scalar causal
    ceiling with a per-row one (T must be 1): ``pos`` then only bounds the
    walk (pass the row max).  ``block`` fixes the block width where the
    storage does (a paged pool walks page-sized blocks).  ``row_start``
    (B,) adds a per-row key floor (a ragged batch's left padding).
    ``base`` is the global position of the cache's first key (a sequence
    shard's chunk start, ``ops.sp_attention``); ``pos`` stays global.
    Returns raw ``(m, l, acc)``; the caller normalizes."""
    b, hkv, g, t, dh = qf.shape
    block = block or _kv_chunk(c)
    scale = float(np.float32(1.0) / np.sqrt(np.float32(dh)))
    n_live = min(max(pos - base, 0), c - 1) // block + 1
    m, l, acc = _fold_init(b, hkv, g, t, dh, qf.device)
    for i in range(n_live):
        start = i * block
        s_idx = base + start + torch.arange(block, device=qf.device)
        if row_pos is not None:
            mask = s_idx[None, None, :] <= row_pos[:, None, None]  # (B, 1, blk)
        else:
            mask = (s_idx <= pos)[None, :]
        if row_start is not None:
            floor = s_idx[None, None, :] >= row_start[:, None, None]  # (B, 1, blk)
            mask = (mask if mask.dim() == 3 else mask[None]) & floor
        m, l, acc = _online_fold(qf, slice_block(k, start, block),
                                 slice_block(v, start, block), mask, m, l, acc,
                                 scale)
    return m, l, acc


def decode_gqa_attention(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, pos,
                         layer: int | None = None,
                         start: torch.Tensor | None = None,
                         scales: tuple[torch.Tensor, torch.Tensor] | None = None
                         ) -> torch.Tensor:
    """Single-token causal GQA that reads only the blocks covering
    positions ``0..pos``.  With ``layer`` the caches are the stacked
    (L, B, Hkv, S, Dh) buffers and the layer is a view (no copy);
    ``start`` (B,) is the ragged batch's per-row key floor.  A
    :class:`DevicePos` walks the blocks up to its bound and masks with its
    device position (the same mask values, so the same result).
    ``scales`` are an int8 cache's (k, v) scale planes, shaped as the
    caches with a trailing 1: each block is dequantized after its read."""
    if layer is not None:
        k_cache, v_cache = k_cache[layer], v_cache[layer]
        if scales is not None:
            scales = (scales[0][layer], scales[1][layer])
    b, hq, t, dh = q.shape
    hkv = k_cache.shape[1]
    qf = q.to(torch.float32).reshape(b, hkv, hq // hkv, t, dh)
    bound, row_pos = pos, None
    if isinstance(pos, DevicePos):
        bound, row_pos = pos.bound, pos.at.expand(b)
    sl, kc, vc = _slice_seq, k_cache, v_cache
    if scales is not None:
        def sl(pair, start, length):
            return dequant_kv(_slice_seq(pair[0], start, length),
                              _slice_seq(pair[1], start, length))

        kc, vc = (k_cache, scales[0]), (v_cache, scales[1])
    _, l, acc = blocked_live_fold(qf, sl, kc, vc, bound, k_cache.shape[2],
                                  row_pos=row_pos, row_start=start)
    out = acc / torch.clamp(l, min=1e-38)[..., None]
    return out.reshape(b, hq, t, dh).to(q.dtype)


def gqa_attention_at(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                     layer: int, pos, q_len: int,
                     start: torch.Tensor | None = None,
                     scales: tuple[torch.Tensor, torch.Tensor] | None = None
                     ) -> torch.Tensor:
    """:func:`gqa_attention` over the stacked caches at ``layer``; a decode
    step over a long cache walks the live blocks straight out of them.
    ``pos`` is a Python int or a :class:`DevicePos` (both algorithms then
    mask with the device position).  ``scales``: an int8 cache's (k, v)
    scale planes (L, B, Hkv, S, 1) f32; the decode walk dequantizes block
    by block, the other paths the layer's slice."""
    if _use_blocked_decode(q.shape[2], ck.shape[3]):
        return decode_gqa_attention(q, ck, cv, pos, layer=layer, start=start,
                                    scales=scales)
    k_l, v_l = ck[layer], cv[layer]
    if scales is not None:
        k_l = dequant_kv(k_l, scales[0][layer])
        v_l = dequant_kv(v_l, scales[1][layer])
    return gqa_attention(q, k_l, v_l, _pos_at(pos), q_len, start=start)


def gqa_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                  pos: int, q_len: int, start: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """Causal GQA over one layer's cache.

    q (B, Hq, T, Dh), already RoPE'd; k_cache/v_cache (B, Hkv, S, Dh),
    positions ≥ pos+T garbage and masked out; pos is the index of q's first
    token (a Python int, or a 0-d device tensor).  Returns (B, Hq, T, Dh).
    Scale 1/sqrt(head_size); GQA grouping is a reshape to (B, Hkv, G, T, Dh).  ``start`` (B,) is the ragged
    batch's key floor: row ``b`` sees only key positions ``>= start[b]``
    (its left padding holds other prompts' alignment)."""
    b, hq, t, dh = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    if t > 1 and g * t * s > _BLOCKED_THRESHOLD:
        return blocked_gqa_attention(q, k_cache, v_cache, pos, q_len, start=start)
    if _use_blocked_decode(t, s):
        return decode_gqa_attention(q, k_cache, v_cache, pos, start=start)
    qc = q.reshape(b, hkv, g, t, dh).to(k_cache.dtype)
    scores = _einsum_f32("bhgtd,bhsd->bhgts", qc, k_cache) / _sqrt_dh(dh)
    s_idx = torch.arange(s, device=q.device)[None, :]
    t_idx = pos + torch.arange(t, device=q.device)[:, None]
    mask = s_idx <= t_idx  # (T, S)
    if start is None:
        scores = torch.where(mask[None, None, None], scores, _NEG)
    else:
        mask = mask[None] & (s_idx[None] >= start[:, None, None])  # (B, T, S)
        scores = torch.where(mask[:, None, None], scores, _NEG)
    probs = softmax_f32(scores, dim=-1)
    out = _einsum_f32("bhgts,bhsd->bhgtd", probs.to(v_cache.dtype), v_cache)
    return out.reshape(b, hq, t, dh).to(q.dtype)


# ---------------------------------------------------------------------------
# Continuous-batching slots.  Every row of the batch belongs to its own
# request and keeps its own clock: a row's query tokens occupy positions
# pos_rows[r]..pos_rows[r]+T-1 and see keys up to its own causal ceiling.
#
# Paged KV: the pool is (L, n_pages, Hkv, page_size, Dh) — the stacked
# layout with the batch axis generalized to physical pages and the sequence
# axis shrunk to one page.  A slot's logical cache is one (max_pages,) int32
# row of the page table: logical position p of slot r lives at
# pool[:, table[r, p // ps], :, p % ps].  Physical page 0 is the scratch
# page: table entries past a slot's reserved pages point at it, and every
# invalid token write lands there, where no mask ever exposes it.  Writes
# are in place (the JAX package's functional updates become index_put_).

def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-position int8 quantization over the last axis: int8 values and
    f32 ``absmax / 127`` scales with a trailing axis of 1."""
    xf = x.to(torch.float32)
    scale = xf.abs().amax(dim=-1, keepdim=True) / 127.0
    live = scale > 0
    inv = torch.where(live, 1.0 / torch.where(live, scale, 1.0), 0.0)
    return torch.round(xf * inv).to(torch.int8), scale


def dequant_kv(vals: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 values × f32 per-position scale → bf16 (the dot operand)."""
    return (vals.to(torch.float32) * scale).to(torch.bfloat16)


def update_kv_cache_rows(k_cache: torch.Tensor, v_cache: torch.Tensor,
                         k_new: torch.Tensor, v_new: torch.Tensor,
                         layer: int, pos_rows: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Write one layer's step KV (B, Hkv, T, Dh) into the stacked
    (L, B, Hkv, S, Dh) caches at per-row positions (B,), in place.  Callers
    keep ``pos_rows[r] + T <= S`` (the engine refuses a step past it)."""
    b, _, t, _ = k_new.shape
    rows = torch.arange(b, device=k_new.device)[:, None]
    tpos = pos_rows.long()[:, None] + torch.arange(t, device=k_new.device)[None, :]
    k_cache[layer][rows, :, tpos] = k_new.transpose(1, 2).to(k_cache.dtype)
    v_cache[layer][rows, :, tpos] = v_new.transpose(1, 2).to(v_cache.dtype)
    return k_cache, v_cache


def _rows_ceiling_attention(q: torch.Tensor, k_l: torch.Tensor,
                            v_l: torch.Tensor, pos_rows: torch.Tensor
                            ) -> torch.Tensor:
    """One-shot causal GQA over one layer's K/V (B, Hkv, S, Dh) with a
    per-row causal ceiling: row r's token t sees keys at positions
    ``<= pos_rows[r] + t``.  Shared by the contiguous slot read and the
    paged gather read, so the two layouts cannot drift."""
    b, hq, t, dh = q.shape
    hkv, s = k_l.shape[1], k_l.shape[2]
    g = hq // hkv
    qc = q.reshape(b, hkv, g, t, dh).to(k_l.dtype)
    scores = _einsum_f32("bhgtd,bhsd->bhgts", qc, k_l) / _sqrt_dh(dh)
    s_idx = torch.arange(s, device=q.device)[None, None, :]
    t_idx = pos_rows.long()[:, None, None] + torch.arange(t, device=q.device)[None, :, None]
    scores = torch.where((s_idx <= t_idx)[:, None, None], scores, _NEG)
    probs = softmax_f32(scores, dim=-1)
    out = _einsum_f32("bhgts,bhsd->bhgtd", probs.to(v_l.dtype), v_l)
    return out.reshape(b, hq, t, dh).to(q.dtype)


def slot_gqa_attention_at(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                          layer: int, pos_rows: torch.Tensor) -> torch.Tensor:
    """Per-row-ceiling GQA over the stacked contiguous caches at ``layer``.
    A freed slot is reused by handing its row position 0 again: the last
    occupant's keys sit above the new ceiling until overwritten."""
    return _rows_ceiling_attention(q, ck[layer], cv[layer], pos_rows)


def paged_write_indices(page_table: torch.Tensor, pos_rows: torch.Tensor,
                        n_valid: torch.Tensor, t: int, page_size: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Physical (page, offset) indices, both (B, T) int32, of one slot
    step's KV writes.  Tokens at ``t_local >= n_valid[r]`` go to scratch
    page 0; logical pages past the table clamp into its last entry."""
    maxp = page_table.shape[1]
    ar = torch.arange(t, device=page_table.device)
    tpos = pos_rows.long()[:, None] + ar[None, :]
    valid = ar[None, :] < n_valid.long()[:, None]
    pslot = torch.clamp(tpos // page_size, 0, maxp - 1)
    pidx = torch.gather(page_table.long(), 1, pslot)
    pidx = torch.where(valid, pidx, 0)
    return pidx.to(torch.int32), (tpos % page_size).to(torch.int32)


def paged_update_kv_rows(pool_k: torch.Tensor, pool_v: torch.Tensor,
                         k_new: torch.Tensor, v_new: torch.Tensor, layer: int,
                         pidx: torch.Tensor, oidx: torch.Tensor
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Scatter one layer's step KV (B, Hkv, T, Dh) into the pools
    (L, P, Hkv, ps, Dh) at the (B, T) physical indices, in place.  Invalid
    tokens all target scratch page 0; which of them wins is unordered, and
    nothing reads that page unmasked."""
    pi, oi = pidx.long(), oidx.long()
    pool_k[layer][pi, :, oi] = k_new.transpose(1, 2).to(pool_k.dtype)
    pool_v[layer][pi, :, oi] = v_new.transpose(1, 2).to(pool_v.dtype)
    return pool_k, pool_v


def paged_gather_layer(pool: torch.Tensor, layer: int, page_table: torch.Tensor,
                       scale_pool: torch.Tensor | None = None) -> torch.Tensor:
    """One layer's logical KV view (B, Hkv, maxp·ps, Dh) gathered through
    the page table; ``scale_pool`` (L, P, Hkv, ps, 1) dequantizes an int8
    pool after the gather."""
    table = page_table.long()
    view = pool[layer][table]  # (B, maxp, Hkv, ps, Dh)
    b, maxp, hkv, ps, dh = view.shape
    out = view.permute(0, 2, 1, 3, 4).reshape(b, hkv, maxp * ps, dh)
    if scale_pool is None:
        return out
    sc = scale_pool[layer][table].permute(0, 2, 1, 3, 4).reshape(b, hkv, maxp * ps, 1)
    return dequant_kv(out, sc)


def paged_decode_attention(q: torch.Tensor, pool_k: torch.Tensor,
                           pool_v: torch.Tensor, layer: int,
                           page_table: torch.Tensor, pos_rows: torch.Tensor,
                           scales: tuple[torch.Tensor, torch.Tensor] | None = None
                           ) -> torch.Tensor:
    """Single-token decode over the pool that walks only live pages:
    :func:`blocked_live_fold` with the page as the block and one page
    gather per step.  Rows whose table runs out before the longest
    neighbor's read scratch page 0, fully masked.  ``scales`` are the int8
    pool's (k, v) scale planes: each step dequantizes the page it read.
    This is the plain version of the fused kernel."""
    b, hq, t, dh = q.shape
    hkv, ps = pool_k.shape[2], pool_k.shape[3]
    maxp = page_table.shape[1]
    qf = q.to(torch.float32).reshape(b, hkv, hq // hkv, t, dh)
    table = page_table.long()

    def page(pool, start, length):
        return pool[layer, table[:, start // ps]]  # (B, Hkv, ps, Dh)

    if scales is None:
        sl, kc, vc = page, pool_k, pool_v
    else:
        def sl(pair, start, length):
            return dequant_kv(page(pair[0], start, length),
                              page(pair[1], start, length))

        kc, vc = (pool_k, scales[0]), (pool_v, scales[1])
    _, l, acc = blocked_live_fold(qf, sl, kc, vc, int(pos_rows.max()), maxp * ps,
                                  row_pos=pos_rows, block=ps)
    out = acc / torch.clamp(l, min=1e-38)[..., None]
    return out.reshape(b, hq, t, dh).to(q.dtype)


def paged_rows_attention(q: torch.Tensor, pool_k: torch.Tensor,
                         pool_v: torch.Tensor, layer: int,
                         page_table: torch.Tensor, pos_rows: torch.Tensor,
                         scales: tuple[torch.Tensor, torch.Tensor] | None = None
                         ) -> torch.Tensor:
    """The gather of one layer's logical view, then the one-shot
    per-row-ceiling attention: the JAX package's CPU route for t > 1, and
    the plain version of the prefill kernel."""
    ks, vs = scales if scales is not None else (None, None)
    k_l = paged_gather_layer(pool_k, layer, page_table, scale_pool=ks)
    v_l = paged_gather_layer(pool_v, layer, page_table, scale_pool=vs)
    return _rows_ceiling_attention(q, k_l, v_l, pos_rows)


def paged_gqa_attention_at(q: torch.Tensor, pool_k: torch.Tensor,
                           pool_v: torch.Tensor, layer: int,
                           page_table: torch.Tensor, pos_rows: torch.Tensor,
                           scales: tuple[torch.Tensor, torch.Tensor] | None = None,
                           impl: str = "auto") -> torch.Tensor:
    """Causal GQA through the page table at ``layer`` with per-row
    ceilings.  A single token on a CUDA tensor goes to
    :func:`fused_paged_attention`, t > 1 query rows to
    :func:`paged_prefill_attention` (each the kernel, or its plain version
    on a CPU tensor or with ``impl="plain"``).  A single token on the CPU
    takes the JAX package's CPU route: the page walk over a long table,
    else the gather and the one-shot per-row-ceiling attention."""
    t = q.shape[2]
    s = page_table.shape[1] * pool_k.shape[3]
    if t == 1 and q.is_cuda:
        return fused_paged_attention(q, pool_k, pool_v, layer, page_table,
                                     pos_rows, scales, impl=impl)
    if t > 1:
        return paged_prefill_attention(q, pool_k, pool_v, layer, page_table,
                                       pos_rows, scales, impl=impl)
    if _use_blocked_decode(t, s):
        return paged_decode_attention(q, pool_k, pool_v, layer, page_table,
                                      pos_rows, scales)
    return paged_rows_attention(q, pool_k, pool_v, layer, page_table, pos_rows, scales)


# ---------------------------------------------------------------------------
# The fused paged-attention kernel (csrc/paged_attention.cu) and its wrapper.
#
# Counters (plain ints, bumped under ``ops.COUNT_LOCK``): ``kernel_launches`` counts launches of the kernel,
# ``plain_calls`` calls that ran its plain version (a CPU tensor, or
# impl="plain"); ``prefill_launches`` and ``prefill_plain_calls`` count the
# same for the prefill kernel (csrc/paged_prefill_attention.cuh, at the end
# of the module).  :func:`reset_counters` zeroes them.

kernel_launches = 0
plain_calls = 0
prefill_launches = 0
prefill_plain_calls = 0
# threads per block, ring stages, head-dim elements a thread holds, query
# heads a block serves at most: must match kThreads, kStages, kVec and
# kHeads in the source
THREADS = 128
STAGES = 3
VEC = 8
HEADS_A_BLOCK = 8
# the card's shared-memory limit per block (H100: 227 KB)
MAX_SMEM = 232448
# blocks the split plan aims for, per SM: about four waves of four
# resident blocks (128 threads, ~48 KB of ring each)
BLOCKS_PER_SM = 16
# positions a ring stage aims to hold: one __syncthreads per stage
STAGE_POSITIONS = 32
_QTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_KVTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.float16: 3}
# head dims both paged kernels take: TMA copies rows whose strides are
# multiples of 16 bytes (an int8 pool's row is Dh bytes) and wgmma's k is 16
MAX_HEAD_DIM = 256


def head_dim_ok(dh: int) -> bool:
    """A head dim both paged kernels take: a multiple of 16 up to 256."""
    return 0 < dh <= MAX_HEAD_DIM and dh % 16 == 0


def _head_dim_refusal(dh: int) -> str:
    return (f"head dim {dh}: the kernels take multiples of 16 up to {MAX_HEAD_DIM} (TMA "
            "copies rows whose strides are multiples of 16 bytes, an int8 pool's row is "
            "Dh bytes, and wgmma's k is 16)")


def reset_counters() -> None:
    global kernel_launches, plain_calls, prefill_launches, prefill_plain_calls
    kernel_launches = plain_calls = prefill_launches = prefill_plain_calls = 0


def counters() -> dict:
    return {"kernel_launches": kernel_launches, "plain_calls": plain_calls,
            "prefill_launches": prefill_launches,
            "prefill_plain_calls": prefill_plain_calls}


def fused_paged_attention(q: torch.Tensor, pool_k: torch.Tensor,
                          pool_v: torch.Tensor, layer: int,
                          page_table: torch.Tensor, pos_rows: torch.Tensor,
                          scales: tuple[torch.Tensor, torch.Tensor] | None = None,
                          impl: str = "auto") -> torch.Tensor:
    """Single-token paged GQA (T == 1) as one kernel: a split page-table
    walk, in-register int8 dequant, online softmax, split combine.  A CUDA
    tensor launches the kernel or raises; a CPU tensor, or
    ``impl="plain"``, runs the plain version (:func:`paged_decode_attention`)."""
    global plain_calls
    if impl not in ("auto", "plain"):
        raise ValueError(f"unknown paged attention impl {impl!r}")
    if q.shape[2] != 1:
        raise ValueError("fused paged attention is decode-only (T must be 1)")
    if impl == "plain" or not q.is_cuda:
        with COUNT_LOCK:
            plain_calls += 1
        return paged_decode_attention(q, pool_k, pool_v, layer, page_table,
                                      pos_rows, scales)
    return paged_attention(q, pool_k, pool_v, layer, page_table, pos_rows, scales)


def head_groups(g: int) -> tuple[int, int]:
    """How pass 1 cuts the ``g`` query heads of a kv head: ``(n, heads)``,
    ``n`` blocks side by side of up to ``heads`` (<= HEADS_A_BLOCK) query
    heads each (one block up to G = 8; G = 16: two of 8; G = 12: two of 6)."""
    n = -(-g // HEADS_A_BLOCK)
    return n, -(-g // n)


def lanes(dh: int) -> int:
    """Threads a position takes in pass 1: the power of two at or above
    ``dh / VEC`` (lanes past the head dim hold zeros)."""
    c = 1
    while c < dh // VEC:
        c *= 2
    return c


def split_plan(maxp: int, b: int, hkv: int, n_sms: int) -> tuple[int, int]:
    """How pass 1 cuts each row's page walk: returns ``(splits, pps)``,
    ``splits`` ranges of ``pps`` consecutive pages that cover pages
    ``0..maxp-1`` once.  From host shapes alone (no position): the grid
    ``(hkv, b, splits)`` aims for ``BLOCKS_PER_SM`` blocks an SM, the split
    count a power of two (Llama-2-7B at B = 8 on 132 SMs: 8 splits of 32
    pages; Mixtral's 8 kv heads: 32 of 8).  Above 8 query heads a kv head
    the caller passes ``hkv`` times its head groups (:func:`head_groups`),
    the grid's first extent.  The kernel clips each split to the row's
    live pages on the device; pass 2 combines the live ones."""
    want = max(1, -(-BLOCKS_PER_SM * n_sms // max(1, b * hkv)))
    splits = min(1 << (want.bit_length() - 1), maxp)
    pps = -(-maxp // splits)
    return -(-maxp // pps), pps


def stage_pages(ps: int, pps: int) -> int:
    """Pages a ring stage holds: about ``STAGE_POSITIONS`` positions, no
    more than a split walks."""
    return max(1, min(pps, STAGE_POSITIONS // ps))


def smem_bytes(g: int, ps: int, dh: int, kv_bytes: int, pp: int) -> int:
    """Dynamic shared memory of one pass-1 block of ``g`` query heads
    (mirrors the source's carve-up): ``STAGES`` ring stages of ``pp`` K and
    V pages (plus their f32 scale rows for an int8 pool), each stage
    rounded up to 16 bytes; the position groups' ``(acc[dh], m, l)`` reuse
    the ring at the end."""
    stage = pp * (2 * ps * dh * kv_bytes + (8 * ps if kv_bytes == 1 else 0))
    stage = -(-stage // 16) * 16
    groups = THREADS // lanes(dh) * g * (dh + 2) * 4
    return max(STAGES * stage, groups)


def _require(cond: bool, msg: str, who: str = "paged_attention") -> None:
    if not cond:
        raise ValueError(f"{who}: {msg}")


def _check_pools(q: torch.Tensor, pool_k: torch.Tensor, pool_v: torch.Tensor, layer: int,
                 page_table: torch.Tensor, pos_rows: torch.Tensor, scales, kv_types: dict,
                 who: str) -> int:
    """The checks both paged kernels make before a launch (q is a CUDA
    tensor of four dims, the caller's check): one (L, P, Hkv, ps, Dh) shape
    and dtype (of ``kv_types``) for both pools, q's head dim and dtype, the
    int8 pool's f32 scale planes, an int32 (B, maxp) page table, int32 (B,)
    positions, one device, contiguity, 16-byte aligned pools and a layer
    inside the pool.  Returns the layer as an int."""
    dev, b, hq, dh = q.device, q.shape[0], q.shape[1], q.shape[3]
    _require(pool_k.dim() == 5 and pool_k.shape == pool_v.shape,
             f"pool shapes {tuple(pool_k.shape)} / {tuple(pool_v.shape)} "
             "are not one (L, P, Hkv, ps, Dh)", who)
    n_layers, n_pages, hkv, ps, dh_kv = pool_k.shape
    _require(dh_kv == dh, f"head dim {dh_kv} vs q's {dh}", who)
    _require(hq % hkv == 0, f"{hq} query heads not a multiple of {hkv} kv heads", who)
    _require(q.dtype in _QTYPES, f"q dtype {q.dtype} not float32/bfloat16/float16", who)
    _require(head_dim_ok(dh), _head_dim_refusal(dh), who)
    _require(pool_k.dtype in kv_types and pool_v.dtype == pool_k.dtype,
             f"pool dtypes {pool_k.dtype}/{pool_v.dtype} not one of "
             f"{'/'.join(str(t).split('.')[-1] for t in kv_types)}", who)
    tensors = [pool_k, pool_v, page_table, pos_rows]
    if pool_k.dtype == torch.int8:
        _require(scales is not None, "an int8 pool needs its scale planes", who)
        for sc in scales:
            _require(sc.dtype == torch.float32 and
                     tuple(sc.shape) == (n_layers, n_pages, hkv, ps, 1),
                     f"scale plane {sc.dtype} {tuple(sc.shape)} != float32 "
                     f"{(n_layers, n_pages, hkv, ps, 1)}", who)
        tensors += list(scales)
    else:
        _require(scales is None, f"scale planes given for a {pool_k.dtype} pool", who)
    _require(page_table.dtype == torch.int32 and page_table.dim() == 2
             and page_table.shape[0] == b,
             f"page table {page_table.dtype} {tuple(page_table.shape)} != int32 ({b}, maxp)",
             who)
    _require(pos_rows.dtype == torch.int32 and tuple(pos_rows.shape) == (b,),
             f"positions {pos_rows.dtype} {tuple(pos_rows.shape)} != int32 ({b},)", who)
    _require(all(x.device == dev for x in tensors), "every operand must be on q's device", who)
    _require(all(x.is_contiguous() for x in tensors),
             "pools, scales, page table and positions must be contiguous", who)
    _require(pool_k.data_ptr() % 16 == 0 and pool_v.data_ptr() % 16 == 0,
             "pools not 16-byte aligned for the kernel's cp.async staging", who)
    layer = int(layer)
    _require(0 <= layer < n_layers, f"layer {layer} outside 0..{n_layers - 1}", who)
    return layer


def paged_attention(q: torch.Tensor, pool_k: torch.Tensor, pool_v: torch.Tensor,
                    layer: int, page_table: torch.Tensor, pos_rows: torch.Tensor,
                    scales: tuple[torch.Tensor, torch.Tensor] | None = None
                    ) -> torch.Tensor:
    """Launch the fused paged-attention kernel: q (B, Hq, 1, Dh)
    f32/bf16/f16 against the pools (L, P, Hkv, ps, Dh) f32/bf16/f16, or
    int8 with (k, v) f32 scale planes (L, P, Hkv, ps, 1), through
    ``page_table`` (B, maxp) int32 at per-row positions ``pos_rows`` (B,)
    int32 → (B, Hq, 1, Dh) in q's dtype; Dh a multiple of 16 up to 256, any
    number of query heads a kv head.  CUDA tensors only; no host sync (the
    page table, the positions and the layer are read on the device)."""
    global kernel_launches
    _require(q.is_cuda, f"q must be a CUDA tensor, got device {q.device}")
    dev = q.device
    _require(q.dim() == 4 and q.shape[2] == 1, f"q shape {tuple(q.shape)} != (B, Hq, 1, Dh)")
    b, hq, _, dh = q.shape
    layer = _check_pools(q, pool_k, pool_v, layer, page_table, pos_rows, scales,
                         _KVTYPES, "paged_attention")
    n_layers, n_pages, hkv, ps, _ = pool_k.shape
    n_hg, gb = head_groups(hq // hkv)
    maxp = page_table.shape[1]
    splits, pps = split_plan(maxp, b, hkv * n_hg, _sm_count(dev))
    pp = stage_pages(ps, pps)
    smem = smem_bytes(gb, ps, dh, pool_k.element_size(), pp)
    _require(smem <= MAX_SMEM, f"page of {ps}x{dh} with {gb} query heads a block needs "
             f"{smem} B of shared memory (max {MAX_SMEM})")
    from . import _build
    lib = _build.load()
    qc = q.contiguous()
    out = torch.empty_like(qc)
    if b == 0:
        return out
    part = torch.empty((b, hq, splits, dh + 2), dtype=torch.float32, device=dev)
    layer_t = index_view(dev, layer, n_layers)
    sk_ptr = scales[0].data_ptr() if scales is not None else None
    sv_ptr = scales[1].data_ptr() if scales is not None else None
    inv_sqrt = float(np.float32(1.0 / np.sqrt(dh)))
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.paged_attention(
            qc.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), sk_ptr, sv_ptr,
            layer_t.data_ptr(), page_table.data_ptr(), pos_rows.data_ptr(),
            out.data_ptr(), part.data_ptr(), _QTYPES[q.dtype], _KVTYPES[pool_k.dtype],
            b, hq, hkv, ps, dh, maxp, n_pages, n_layers, splits, pps, pp, inv_sqrt,
            stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention launch failed: CUDA error {rc} "
                           f"({lib.q40_error_string(rc).decode()}) at B={b} "
                           f"Hq={hq} Hkv={hkv} ps={ps} Dh={dh} splits={splits}x{pps} "
                           f"pp={pp} smem={smem}")
    with COUNT_LOCK:
        kernel_launches += 1
    return out


def bind(lib):
    """Declare the kernel's C signature (pointers and the stream as
    ``c_void_p``, so ctypes never cuts a 64-bit pointer)."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.paged_attention.argtypes = [vp] * 10 + [ci] * 13 + [ctypes.c_float, vp]
    lib.paged_attention.restype = ci
    lib.paged_prefill_attention.argtypes = [vp] * 10 + [ci] * 13 + [ctypes.c_float, vp]
    lib.paged_prefill_attention.restype = ci
    lib.paged_prefill_layout.argtypes = [ci, ci, ci, ctypes.POINTER(ci)]
    lib.paged_prefill_layout.restype = ci
    return lib


# ---------------------------------------------------------------------------
# The prefill kernel (csrc/paged_prefill_attention.cuh): t > 1 query rows
# over the paged pool with per-row ceilings, the mixed slot step's read.

# query rows a block takes (a row group; wider steps have more groups), 64
# above a padded head dim of 128 (:func:`prefill_group_rows`), and keys a
# tile: the split plan's numbers from the source (kRows, kWgRows, kKeys),
# which owns the rest of the block's layout (:func:`prefill_layout`)
PREFILL_MAX_ROWS = 128
PREFILL_WG_ROWS = 64
PREFILL_KEYS = 64
# the pools it reads, by the source's codes
_PREFILL_KV = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.float16: 3}
# the split plan: the partials, written and read back, stay under this
# share of the K/V bytes at full table length; the grid aims for this many
# blocks an SM (ragged rows balance)
PREFILL_PARTIAL_SHARE = 0.1
PREFILL_BLOCKS_PER_SM = 4
_PREFILL = "paged_prefill_attention"


class PrefillPlan(NamedTuple):
    """The prefill kernel's launch (:func:`prefill_plan`): the grid is
    ``(hkv, b, groups * splits)``, ``groups`` row groups of up to
    ``PREFILL_MAX_ROWS`` query rows, ``splits`` ranges of ``pps`` pages;
    ``partial_bytes`` the f32 partials written and read back at full table
    length (0 with one split: pass 1 writes the output) beside
    ``kv_bytes``, the K/V bytes of full tables."""
    splits: int
    pps: int
    groups: int
    partial_bytes: int
    kv_bytes: int


def prefill_pages_a_tile(ps: int) -> int:
    """Pages of ``ps`` positions a 64-key tile holds (1 when a page fills a
    tile or more): the source reads a page in boxes of the power of two
    from 8 to 64 rows that covers it, so a tile is 64 / that many whole
    pages or a 64-row slice of one.  A split of whole tiles wastes no box."""
    br = 8
    while br < ps and br < PREFILL_KEYS:
        br *= 2
    return max(1, PREFILL_KEYS // br // -(-ps // br))


def prefill_padded_dh(dh: int) -> int:
    """The head dim the tensor-core body computes at: ``dh`` rounded up to
    whole 64-column slabs (the columns past ``dh`` are zeros)."""
    return -(-dh // 64) * 64


def prefill_group_rows(dh: int) -> int:
    """Query rows a block of the prefill kernel takes at head dim ``dh``
    (the source's rows_a_group): 128, or 64 above a padded head dim of 128,
    where one consumer warpgroup holds the 96-128 PV accumulators a
    thread that two could not without spilling."""
    return PREFILL_WG_ROWS if prefill_padded_dh(dh) > 128 else PREFILL_MAX_ROWS


def prefill_layout(pool_dtype: torch.dtype, dh: int, rows: int) -> dict:
    """The pass-1 block the source launches for ``rows`` = G·T query rows a
    kv head on a ``pool_dtype`` pool, as the build reports it
    (``paged_prefill_layout``): consumer ``warpgroups`` (0 for the f32
    body), ``threads``, dynamic shared memory ``smem`` in bytes, ring
    ``stages``, ``consumer_regs`` (registers a consumer thread after
    setmaxnreg, 0 when unchanged) and ``group_rows`` (query rows a block).
    Builds the kernels (needs ``nvcc``)."""
    _require(pool_dtype in _PREFILL_KV, f"a {pool_dtype} pool", _PREFILL)
    from . import _build
    lib = _build.load()
    out = (ctypes.c_int * 6)()
    rc = lib.paged_prefill_layout(_PREFILL_KV[pool_dtype], dh, rows, out)
    _require(rc == 0, f"no layout at head dim {dh}", _PREFILL)
    return dict(zip(("warpgroups", "threads", "smem", "stages", "consumer_regs",
                     "group_rows"), out))


def prefill_plan(b: int, hq: int, hkv: int, t: int, ps: int, dh: int, maxp: int,
                 kv_bytes: int, n_sms: int) -> PrefillPlan:
    """The prefill kernel's launch for these shapes, from host shapes alone
    (no position, so a captured graph keeps it).  The split count comes
    from the table length and G·T: as many splits as keep the partials (G·T
    records of dh + 2 floats a split and kv head, written and read back)
    under ``PREFILL_PARTIAL_SHARE`` of the K/V bytes at full table length,
    up to ``PREFILL_BLOCKS_PER_SM`` blocks an SM (ragged rows balance); a
    grid under half the SMs takes enough splits to fill them whatever the
    partials cost.  A split walks whole tiles; a row group is
    :func:`prefill_group_rows` query rows.  Raises on a head dim the
    kernels do not take."""
    _require(head_dim_ok(dh), _head_dim_refusal(dh), _PREFILL)
    _require(hq % hkv == 0, f"{hq} query heads not a multiple of {hkv} kv heads", _PREFILL)
    _require(t >= 1, f"{t} tokens a row", _PREFILL)
    rows = hq // hkv * t
    groups = -(-rows // prefill_group_rows(dh))
    kv_pair = maxp * ps * 2 * (dh * kv_bytes + (4 if kv_bytes == 1 else 0))
    part_split = 2 * rows * (dh + 2) * 4
    blocks = b * hkv * groups
    cap = int(kv_pair * PREFILL_PARTIAL_SHARE // part_split)
    splits = max(1, min(cap, -(-PREFILL_BLOCKS_PER_SM * n_sms // blocks)))
    if 2 * blocks < n_sms:
        splits = max(splits, -(-n_sms // blocks))
    ppt = prefill_pages_a_tile(ps)
    per = -(-maxp // min(splits, maxp))
    pps = -(-per // ppt) * ppt
    splits = -(-maxp // pps)
    return PrefillPlan(splits, pps, groups, b * hkv * part_split * splits if splits > 1 else 0,
                       b * hkv * kv_pair)


def check_prefill_config(pool_dtype: torch.dtype, dh: int) -> None:
    """Raise, before any request, when the paged kernels could not read a
    paged pool on the card: a pool other than f32, bf16, f16 or int8, or a
    head dim that is not a multiple of 16 up to 256 (TMA's row strides,
    wgmma's k).  Any step width and page size passes."""
    _require(pool_dtype in _PREFILL_KV,
             f"a {pool_dtype} pool on the card: the kernels read f32, bf16, f16 or int8 "
             "pools (set the KV cache dtype to one of them, or use attn_impl='plain')",
             _PREFILL)
    _require(head_dim_ok(dh), _head_dim_refusal(dh), _PREFILL)


def _prefill_operand(pool_dtype: torch.dtype) -> torch.dtype:
    """The operand type of q and the probabilities on a pool: the pool's
    own, bf16 for int8 (its dequantized values are bf16)."""
    return torch.bfloat16 if pool_dtype == torch.int8 else pool_dtype


def paged_prefill_attention(q: torch.Tensor, pool_k: torch.Tensor,
                            pool_v: torch.Tensor, layer: int,
                            page_table: torch.Tensor, pos_rows: torch.Tensor,
                            scales: tuple[torch.Tensor, torch.Tensor] | None = None,
                            impl: str = "auto") -> torch.Tensor:
    """Paged GQA for t > 1 query rows with per-row ceilings (the mixed
    slot step) as one kernel: a split page-table walk, tensor-core products,
    online softmax, split combine.  A CUDA tensor launches the kernel
    (:func:`prefill_attention`) or raises; a CPU tensor, or
    ``impl="plain"``, runs the plain version (:func:`paged_rows_attention`)."""
    global prefill_plain_calls
    if impl not in ("auto", "plain"):
        raise ValueError(f"unknown paged attention impl {impl!r}")
    if impl == "plain" or not q.is_cuda:
        with COUNT_LOCK:
            prefill_plain_calls += 1
        return paged_rows_attention(q, pool_k, pool_v, layer, page_table, pos_rows, scales)
    return prefill_attention(q, pool_k, pool_v, layer, page_table, pos_rows, scales)


def prefill_attention(q: torch.Tensor, pool_k: torch.Tensor, pool_v: torch.Tensor,
                      layer: int, page_table: torch.Tensor, pos_rows: torch.Tensor,
                      scales: tuple[torch.Tensor, torch.Tensor] | None = None
                      ) -> torch.Tensor:
    """Launch the prefill kernel: q (B, Hq, T, Dh) f32/bf16/f16 (rounded to
    the pool's operand: bf16 for a bf16 or int8 pool, f16 for an f16 one,
    f32 for an f32 one) against the pools (L, P, Hkv, ps, Dh) f32, bf16 or
    f16, or int8 with (k, v) f32 scale planes (L, P, Hkv, ps, 1), through
    ``page_table`` (B, maxp) int32 at per-row positions ``pos_rows`` (B,)
    int32 → (B, Hq, T, Dh) in q's dtype; Dh a multiple of 16 up to 256.
    CUDA tensors only; no host sync (the page table, the positions and the
    layer are read on the device)."""
    global prefill_launches
    _require(q.is_cuda, f"q must be a CUDA tensor, got device {q.device}", _PREFILL)
    dev = q.device
    _require(q.dim() == 4, f"q shape {tuple(q.shape)} != (B, Hq, T, Dh)", _PREFILL)
    b, hq, t, dh = q.shape
    layer = _check_pools(q, pool_k, pool_v, layer, page_table, pos_rows, scales,
                         _PREFILL_KV, _PREFILL)
    n_layers, n_pages, hkv, ps, _ = pool_k.shape
    _require(n_layers * n_pages * hkv * ps < 2 ** 31,
             f"a pool of {n_layers * n_pages * hkv * ps} rows (the tensor maps take < 2^31)",
             _PREFILL)
    if scales is not None:
        _require(all(sc.data_ptr() % 16 == 0 for sc in scales),
                 "scale planes not 16-byte aligned for the kernel's TMA copies", _PREFILL)
    maxp = page_table.shape[1]
    plan = prefill_plan(b, hq, hkv, t, ps, dh, maxp, pool_k.element_size(), _sm_count(dev))
    from . import _build
    lib = _build.load()
    qc = q.to(_prefill_operand(pool_k.dtype)).contiguous()
    if qc.data_ptr() % 16:  # the query tile is read in 16-byte pieces
        qc = qc.clone()
    out = torch.empty(q.shape, dtype=q.dtype, device=dev)
    if b == 0:
        return out
    part = out  # unused with one split
    if plan.splits > 1:
        part = torch.empty((b, hq, t, plan.splits, dh + 2), dtype=torch.float32, device=dev)
    layer_t = index_view(dev, layer, n_layers)
    sk_ptr = scales[0].data_ptr() if scales is not None else None
    sv_ptr = scales[1].data_ptr() if scales is not None else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.paged_prefill_attention(
            qc.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), sk_ptr, sv_ptr,
            layer_t.data_ptr(), page_table.data_ptr(), pos_rows.data_ptr(),
            out.data_ptr(), part.data_ptr(), _QTYPES[q.dtype],
            _PREFILL_KV[pool_k.dtype], b, hq, hkv, t, ps, dh, maxp, n_pages, n_layers,
            plan.splits, plan.pps, _sqrt_dh(dh), stream)
    if rc != 0:
        raise RuntimeError(f"paged_prefill_attention launch failed: CUDA error {rc} "
                           f"({lib.q40_error_string(rc).decode()}) at B={b} Hq={hq} "
                           f"Hkv={hkv} T={t} ps={ps} Dh={dh} pool={pool_k.dtype} {plan}")
    with COUNT_LOCK:
        prefill_launches += 1
    return out
