"""Grouped-query attention over a contiguous KV cache — the port of the
contiguous-cache half of ``dllama_tpu/ops/attention.py``.

The cache layout is the JAX package's stacked ``(L, B, Hkv, S, Dh)``.
Three algorithms, chosen by the same rules as the JAX package:

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

import numpy as np
import torch

from .kernels import softmax_f32

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


def update_kv_cache_at(k_cache: torch.Tensor, v_cache: torch.Tensor,
                       k_new: torch.Tensor, v_new: torch.Tensor,
                       layer: int, pos: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Write one layer's step KV (B, Hkv, T, Dh) into the stacked
    (L, B, Hkv, S, Dh) caches at ``(layer, pos)``.  Unlike the JAX package's
    functional update, the write is in place (only the (B, Hkv, T, Dh)
    window moves); the caches are returned for symmetry with it."""
    t = k_new.shape[2]
    k_cache[layer, :, :, pos:pos + t] = k_new.to(k_cache.dtype)
    v_cache[layer, :, :, pos:pos + t] = v_new.to(v_cache.dtype)
    return k_cache, v_cache


def _einsum_f32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.einsum(eq, a.to(torch.float32), b.to(torch.float32))


def _online_fold(qf, kb, vb, mask, m, l, acc, scale):
    """Fold one KV block into the running (max, denom, numerator); ``mask``
    is (T, S) broadcast over (B, Hkv, G)."""
    scores = _einsum_f32("bhgtd,bhsd->bhgts", qf.to(kb.dtype), kb) * scale
    scores = torch.where(mask[None, None, None], scores, _NEG)
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
                          v_cache: torch.Tensor, pos: int, q_len: int) -> torch.Tensor:
    """Flash-style causal GQA over KV chunks with an online softmax: peak
    memory O(T·chunk) instead of O(T·S)."""
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
        m, l, acc = _online_fold(qf, k_cache[:, :, base:base + c],
                                 v_cache[:, :, base:base + c], s_idx <= t_idx,
                                 m, l, acc, scale)
    out = acc / torch.clamp(l, min=1e-38)[..., None]
    return out.reshape(b, hq, t, dh).to(q.dtype)


def blocked_live_fold(qf, k, v, pos: int):
    """Walk only the KV blocks of ``k``/``v`` (B, Hkv, S, Dh) that cover
    live positions ≤ ``pos``, folding each into the running softmax state.
    Returns raw ``(m, l, acc)``; the caller normalizes."""
    b, hkv, g, t, dh = qf.shape
    s = k.shape[2]
    block = _kv_chunk(s)
    scale = float(np.float32(1.0) / np.sqrt(np.float32(dh)))
    n_live = min(max(pos, 0), s - 1) // block + 1
    m, l, acc = _fold_init(b, hkv, g, t, dh, qf.device)
    for i in range(n_live):
        start = i * block
        s_idx = start + torch.arange(block, device=qf.device)
        mask = (s_idx <= pos)[None, :]
        m, l, acc = _online_fold(qf, k[:, :, start:start + block],
                                 v[:, :, start:start + block], mask, m, l, acc,
                                 scale)
    return m, l, acc


def decode_gqa_attention(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, pos: int,
                         layer: int | None = None) -> torch.Tensor:
    """Single-token causal GQA that reads only the blocks covering
    positions ``0..pos``.  With ``layer`` the caches are the stacked
    (L, B, Hkv, S, Dh) buffers and the layer is a view (no copy)."""
    if layer is not None:
        k_cache, v_cache = k_cache[layer], v_cache[layer]
    b, hq, t, dh = q.shape
    hkv = k_cache.shape[1]
    qf = q.to(torch.float32).reshape(b, hkv, hq // hkv, t, dh)
    _, l, acc = blocked_live_fold(qf, k_cache, v_cache, pos)
    out = acc / torch.clamp(l, min=1e-38)[..., None]
    return out.reshape(b, hq, t, dh).to(q.dtype)


def gqa_attention_at(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                     layer: int, pos: int, q_len: int) -> torch.Tensor:
    """:func:`gqa_attention` over the stacked caches at ``layer``; a decode
    step over a long cache walks the live blocks straight out of them."""
    if _use_blocked_decode(q.shape[2], ck.shape[3]):
        return decode_gqa_attention(q, ck, cv, pos, layer=layer)
    return gqa_attention(q, ck[layer], cv[layer], pos, q_len)


def gqa_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                  pos: int, q_len: int) -> torch.Tensor:
    """Causal GQA over one layer's cache.

    q (B, Hq, T, Dh), already RoPE'd; k_cache/v_cache (B, Hkv, S, Dh),
    positions ≥ pos+T garbage and masked out; pos is the index of q's first
    token.  Returns (B, Hq, T, Dh).  Scale 1/sqrt(head_size); GQA grouping
    is a reshape to (B, Hkv, G, T, Dh)."""
    b, hq, t, dh = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    if t > 1 and g * t * s > _BLOCKED_THRESHOLD:
        return blocked_gqa_attention(q, k_cache, v_cache, pos, q_len)
    if _use_blocked_decode(t, s):
        return decode_gqa_attention(q, k_cache, v_cache, pos)
    qc = q.reshape(b, hkv, g, t, dh).to(k_cache.dtype)
    scores = _einsum_f32("bhgtd,bhsd->bhgts", qc, k_cache) / _sqrt_dh(dh)
    s_idx = torch.arange(s, device=q.device)[None, :]
    t_idx = pos + torch.arange(t, device=q.device)[:, None]
    scores = torch.where((s_idx <= t_idx)[None, None, None], scores, _NEG)
    probs = softmax_f32(scores, dim=-1)
    out = _einsum_f32("bhgts,bhsd->bhgtd", probs.to(v_cache.dtype), v_cache)
    return out.reshape(b, hq, t, dh).to(q.dtype)
