"""Sequence-parallel attention over a sequence-sharded KV cache — the port
of ``dllama_tpu/ops/sp_attention.py``.

The KV cache's sequence axis is cut over the mesh's ``sp`` ranks: shard
``s`` holds positions ``[s·C, (s+1)·C)`` of every row and head (``C = S /
sp``).  The JAX package runs each function below as a ``shard_map`` body;
here a function takes the sp ranks' tensors as a list, index ``s`` on
shard ``s``'s device, as the transformer's mesh walk takes its ranks
(``models/transformer.py``).  Everything is plain PyTorch but the combine's
two sums, which go through kernel 4 (``ops.q40.tp_allreduce``) over the
sp group.

* :func:`sp_gqa_attention` — decode, and any continuation at pos > 0:
  each shard computes its local masked scores' max ``m_i``, partial
  denominator ``l_i`` and numerator ``o_i`` (a shard whose whole chunk is
  in the queries' future contributes the empty partials and reads no KV;
  a single query over a chunk of at least ``_DECODE_BLOCKED_MIN_S``
  positions walks only its live blocks), then one round combines them:
  ``M = max_i m_i``, ``out = Σ e^{m_i−M}·o_i / max(Σ e^{m_i−M}·l_i,
  1e-38)``.
* :func:`ring_attention` — a from-scratch prefill whose tokens are cut
  over sp: each shard folds the KV blocks in the ring's order (the block
  held after i rotations came from shard ``(my − i) mod sp``), skipping
  blocks wholly in its future; no cache is read.
* :func:`sp_update_kv_cache_at` — the decode step's KV write, on the
  owning shard alone; :func:`sp_update_kv_window_at` — a window of T > 1
  tokens, cut over the shards its positions fall in (the JAX package
  leaves that write to GSPMD).
"""

from __future__ import annotations

import torch

from .attention import (_einsum_f32, _sqrt_dh, _use_blocked_decode, blocked_live_fold,
                        update_kv_cache_at)
from .q40 import tp_allreduce

NEG_BIG = -1e30  # stand-in for -inf that keeps exp() NaN-free on empty shards


def sp_update_kv_cache_at(k_caches: list, v_caches: list, k_new: torch.Tensor,
                          v_new: torch.Tensor, layer: int, pos: int) -> tuple[list, list]:
    """Decode-step KV write into the sp shards' stacked ``(L, B, Hkv, C,
    Dh)`` caches at ``(layer, pos)`` (``pos`` global): the shard that owns
    ``pos`` writes the one row ``k_new``/``v_new`` ``(B, Hkv, 1, Dh)``;
    the others are untouched — no communication.  Exactly one token: a
    T-token window could straddle a shard boundary
    (:func:`sp_update_kv_window_at` cuts one)."""
    if k_new.shape[2] != 1:
        raise ValueError(
            f"sp_update_kv_cache_at writes one decode step, got T={k_new.shape[2]}")
    return sp_update_kv_window_at(k_caches, v_caches, k_new, v_new, layer, pos)


def sp_update_kv_window_at(k_caches: list, v_caches: list, k_new: torch.Tensor,
                           v_new: torch.Tensor, layer: int, pos: int) -> tuple[list, list]:
    """Write a ``(B, Hkv, T, Dh)`` window at global positions ``pos ..
    pos+T-1`` into the sp shards' stacked caches: each shard takes the
    part of the window that falls in its chunk."""
    t = k_new.shape[2]
    chunk = k_caches[0].shape[3]
    for s, (kc, vc) in enumerate(zip(k_caches, v_caches)):
        lo, hi = max(pos, s * chunk), min(pos + t, (s + 1) * chunk)
        if lo < hi:
            update_kv_cache_at(kc, vc, k_new[:, :, lo - pos:hi - pos].to(kc.device),
                               v_new[:, :, lo - pos:hi - pos].to(vc.device), layer,
                               lo - s * chunk)
    return k_caches, v_caches


def _empty_partials(shape, dh: int, device):
    """The (o_i, l_i, m_i) triple a fully masked chunk produces: the ring's
    accumulator start and the one-round path's skip branch."""
    return (torch.zeros(shape + (dh,), dtype=torch.float32, device=device),
            torch.zeros(shape, dtype=torch.float32, device=device),
            torch.full(shape, NEG_BIG, dtype=torch.float32, device=device))


def _local_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: int,
                    q_len: int, chunk_start: int):
    """One shard's partial attention.

    q: (B, Hkv, G, T, Dh) f32 — grouped queries at global positions
    ``pos ..``; k/v: (B, Hkv, C, Dh) — the shard's keys at global
    positions ``chunk_start ..``.  Returns (o_i (B, Hkv, G, T, Dh), l_i
    (B, Hkv, G, T), m_i (B, Hkv, G, T)), all f32."""
    c = k.shape[2]
    # cache-dtype operands, f32 products and sums
    scores = _einsum_f32("bhgtd,bhsd->bhgts", q.to(k.dtype), k) / _sqrt_dh(q.shape[-1])
    s_idx = chunk_start + torch.arange(c, device=q.device)[None, :]   # global key positions
    t_idx = pos + torch.arange(q_len, device=q.device)[:, None]
    mask = s_idx <= t_idx                                            # (T, C) causal+validity
    scores = torch.where(mask, scores, float("-inf"))
    m_i = torch.clamp(scores.amax(dim=-1), min=NEG_BIG)              # (B, Hkv, G, T)
    p = torch.exp(scores - m_i[..., None])                            # masked: exp(-inf) = 0
    l_i = p.sum(dim=-1)
    o_i = _einsum_f32("bhgts,bhsd->bhgtd", p.to(v.dtype), v)
    return o_i, l_i, m_i


def _slice_seq(cache, start: int, length: int):
    return cache[:, :, start:start + length]


def _local_partials_blocked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: int,
                            chunk_start: int):
    """Decode-step (T == 1) partials that read only the KV blocks covering
    the shard's live positions (``attention.blocked_live_fold`` from the
    chunk start): O(live prefix) a shard, not O(chunk).  The caller gates
    on a non-empty live region, so ``m_i`` is a real max."""
    m, l, acc = blocked_live_fold(q, _slice_seq, k, v, pos, k.shape[2], base=chunk_start)
    return acc, l, m


def ring_attention(qs: list, ks: list, vs: list, pos0: int = 0) -> list:
    """Causal GQA ring attention for a sequence-sharded from-scratch
    prefill.  ``qs[s]`` (B, Hq, T/sp, Dh) and ``ks[s]``/``vs[s]`` (B, Hkv,
    T/sp, Dh) are shard ``s``'s block of the window's queries, keys and
    values, at global positions ``pos0 + s·T/sp ..``.  Each shard folds the
    blocks into a running (max, denominator, numerator) in the ring's order
    — the block held after i rotations came from shard ``(my − i) mod sp``
    — and skips a block wholly in its future; the cache is not read, so a
    continuation over a cached prefix takes :func:`sp_gqa_attention`.
    Returns each shard's (B, Hq, T/sp, Dh) output in q's dtype, on its
    device."""
    sp = len(qs)
    outs = []
    for my, q in enumerate(qs):
        b, hq_l, t_local, dh = q.shape
        hkv_l = ks[my].shape[1]
        qf = q.to(torch.float32).reshape(b, hkv_l, hq_l // hkv_l, t_local, dh)
        q_start = pos0 + my * t_local
        out, lsum, m = _empty_partials((b, hkv_l, hq_l // hkv_l, t_local), dh, q.device)
        for i in range(sp):
            owner = (my - i) % sp
            if owner > my:  # every key of the block is in every query's future
                continue
            o_i, l_i, m_i = _local_partials(qf, ks[owner].to(q.device), vs[owner].to(q.device),
                                            q_start, t_local, pos0 + owner * t_local)
            m_new = torch.maximum(m, m_i)
            s_old = torch.exp(m - m_new)
            s_new = torch.exp(m_i - m_new)
            out = out * s_old[..., None] + o_i * s_new[..., None]
            lsum = lsum * s_old + l_i * s_new
            m = m_new
        out = out / torch.clamp(lsum[..., None], min=1e-38)
        outs.append(out.reshape(b, hq_l, t_local, dh).to(q.dtype))
    return outs


def _pack(o: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """The combine's two f32 addends as one (1, 2k) row for kernel 4 (which
    sums rows of an even width): the numerator, the denominator, a zero
    pad when their count is odd."""
    flat = [o.reshape(-1), l.reshape(-1)]
    if (o.numel() + l.numel()) % 2:
        flat.append(torch.zeros(1, dtype=torch.float32, device=o.device))
    return torch.cat(flat)[None]


def sp_gqa_attention(qs: list, k_caches: list, v_caches: list, pos: int, q_len: int,
                     layer: int | None = None, impl: str = "auto") -> list:
    """Causal GQA over a sequence-sharded cache: shard ``s`` has the
    queries ``qs[s]`` (B, Hq, T, Dh) at global positions ``pos ..`` and its
    cache chunk ``k_caches[s]``/``v_caches[s]`` — (B, Hkv, C, Dh), or the
    stacked (L, B, Hkv, C, Dh) buffers read at ``layer`` (a view).  Each
    shard's partials, then the one-round combine: the global max of the
    gathered ``m_i``, each shard's rescaled numerator and denominator summed
    over the shards by kernel 4 (``impl`` as ``tp_allreduce``'s; the CPU
    sums plainly), the divide by ``max(denom, 1e-38)``.  Returns each
    shard's (B, Hq, T, Dh) output in q's dtype, on its device."""
    parts = []
    for s, (q, kc, vc) in enumerate(zip(qs, k_caches, v_caches)):
        if layer is not None:
            kc, vc = kc[layer], vc[layer]
        b, hq_l, t, dh = q.shape
        hkv_l, chunk = kc.shape[1], kc.shape[2]
        qf = q.to(torch.float32).reshape(b, hkv_l, hq_l // hkv_l, t, dh)
        chunk_start = s * chunk
        if chunk_start > pos + q_len - 1:
            # the whole chunk is in the queries' future: no scores, no KV read
            parts.append(_empty_partials(qf.shape[:3] + (t,), dh, q.device))
        elif _use_blocked_decode(q_len, chunk):
            parts.append(_local_partials_blocked(qf, kc, vc, pos, chunk_start))
        else:
            parts.append(_local_partials(qf, kc, vc, pos, q_len, chunk_start))
    scaled = []
    for o_i, l_i, m_i in parts:
        m = torch.stack([p[2].to(m_i.device) for p in parts]).amax(dim=0)  # global max
        scale = torch.exp(m_i - m)
        scaled.append(_pack(o_i * scale[..., None], l_i * scale))
    sums = tp_allreduce(scaled, impl) if len(scaled) > 1 else scaled
    outs = []
    for q, (o_i, l_i, _), total in zip(qs, parts, sums):
        n = o_i.numel()
        num = total[0, :n].reshape(o_i.shape)
        denom = total[0, n:n + l_i.numel()].reshape(l_i.shape)
        out = num / torch.clamp(denom[..., None], min=1e-38)
        outs.append(out.reshape(q.shape).to(q.dtype))
    return outs
