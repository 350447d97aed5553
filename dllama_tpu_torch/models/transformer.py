"""The forward pass — the port of ``dllama_tpu/models/transformer.py``:
Llama (dense FFN), Mixtral and Grok-1 (mixture of experts, Grok's
embedding and logit scales and post-block norms); a contiguous KV cache
(bf16/f32, or int8 with per-position scales), contiguous slot rows, or a
paged KV pool.

One function serves prefill (T > 1) and decode (T == 1): tokens enter as
``(B, T)``, the KV cache as stacked ``(L, B, Hkv, S, Dh)`` buffers, and
``pos`` is the position of the first token: a Python int, or an
``ops.attention.DevicePos`` that a captured decode step reads on the
device (``runtime.graphs``).  :func:`forward_slots` is the
continuous-batching step: every row has its own clock (``pos_rows``), over
contiguous slot rows or a paged pool (``(L, P, Hkv, ps, Dh)`` addressed
through a page table).  The layer loop is a Python loop over the layer
index of the stacked weights; a packed Q40/Q80 weight is read in place at
that index by its kernel, never sliced into a copy, and an expert chosen
on the device is read at its flat index ``layer·E + expert`` the same way.
Every ``astype(cfg.dtype)`` rounding point of the JAX code is kept (the
matmul outputs, the residual stream).

Tensor parallelism (params placed over a mesh, ``parallel.sharding.Placed``,
and one KV cache or pool a rank, :class:`ShardedKV`): the JAX transformer
is mesh-agnostic and GSPMD partitions it; here the SPMD program is written
out.  The layer loop walks the ranks: each takes its local heads
(``n_heads/tp``, ``n_kv_heads/tp``) and its own KV, computes its slice of
every row-sliced matmul and its partial sum of every column-sliced one
(wo, w2, an expert's down); kernel 4 (``ops.q40.tp_allreduce``) sums the
f32 partials, the cast to the activation dtype follows, and each rank adds
the sum to its own copy of the residual.  The MoE router runs on rank 0
(the reference's root, ``grok1-tasks.cpp:59``) and its choice goes to
every rank, so the ranks never disagree on an expert.  The vocab-sliced
logits are gathered in rank order on rank 0's device, where sampling runs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.attention import (DevicePos, gqa_attention_at, paged_gqa_attention_at,
                             paged_update_kv_rows, paged_write_indices,
                             quantize_kv, slot_gqa_attention_at,
                             update_kv_cache_at, update_kv_cache_rows)
from ..ops.kernels import (ACTIVATIONS, apply_rope, rmsnorm, rope_angles,
                           softmax_f32, top_k)
from ..ops.q40 import mm, tp_allreduce
from ..parallel.sharding import COL, ROW, Placed
from .config import ModelConfig
from .params import Params


class KVCache(NamedTuple):
    k: torch.Tensor  # (L, B, Hkv, S, Dh), or a pool (L, P, Hkv, ps, Dh)
    v: torch.Tensor
    # per-position f32 dequant scales with a trailing 1, present only for
    # the int8 pool
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


class ShardedKV(NamedTuple):
    """One KV cache or paged pool per TP rank, each holding
    ``n_kv_heads/tp`` heads on its rank's device; the page table is
    shared."""
    ranks: tuple[KVCache, ...]

    @property
    def k(self) -> torch.Tensor:
        """Rank 0's keys: the dtype and page size every rank shares."""
        return self.ranks[0].k

    @property
    def quantized(self) -> bool:
        return self.ranks[0].quantized


def init_kv_cache(cfg: ModelConfig, batch: int, seq_len: int | None = None,
                  dtype=None, quant: bool = False, device="cpu", tp: int = 1) -> KVCache:
    """Preallocated full-length cache in ``dtype`` (default cfg.dtype);
    ``quant`` stores int8 values plus per-(head, position) f32 scales
    ``(L, B, Hkv, S, 1)``, quantized at write (:func:`update_cache_at`) and
    dequantized at read; ``tp`` > 1 makes one rank's cache
    (``n_kv_heads/tp`` heads)."""
    shape = (cfg.n_layers, batch, cfg.n_kv_heads // tp, seq_len or cfg.seq_len,
             cfg.head_size)
    if quant:
        sshape = shape[:-1] + (1,)
        return KVCache(torch.zeros(shape, dtype=torch.int8, device=device),
                       torch.zeros(shape, dtype=torch.int8, device=device),
                       torch.zeros(sshape, dtype=torch.float32, device=device),
                       torch.zeros(sshape, dtype=torch.float32, device=device))
    dt = dtype or cfg.dtype
    return KVCache(torch.zeros(shape, dtype=dt, device=device),
                   torch.zeros(shape, dtype=dt, device=device))


def init_kv_pool(cfg: ModelConfig, n_pages: int, page_size: int, dtype=None,
                 quant: bool = False, device="cpu", tp: int = 1) -> KVCache:
    """Paged KV pool ``(L, n_pages, Hkv, page_size, Dh)``; page 0 is the
    reserved scratch page.  ``quant`` stores int8 values plus a
    per-(page, head, position) f32 scale plane ``(L, P, Hkv, ps, 1)``;
    ``tp`` > 1 makes one rank's pool (``Hkv = n_kv_heads/tp``)."""
    shape = (cfg.n_layers, n_pages, cfg.n_kv_heads // tp, page_size, cfg.head_size)
    if quant:
        sshape = shape[:-1] + (1,)
        return KVCache(torch.zeros(shape, dtype=torch.int8, device=device),
                       torch.zeros(shape, dtype=torch.int8, device=device),
                       torch.zeros(sshape, dtype=torch.float32, device=device),
                       torch.zeros(sshape, dtype=torch.float32, device=device))
    dt = dtype or cfg.dtype
    return KVCache(torch.zeros(shape, dtype=dt, device=device),
                   torch.zeros(shape, dtype=dt, device=device))


# up to this many tokens a MoE layer computes only the selected experts
# (the JAX package's decode route); above it, every expert, masked
MOE_DECODE_MAX_TOKENS = 4


def _mm(x: torch.Tensor, w, cfg: ModelConfig, layer=None,
        out_dtype=None) -> torch.Tensor:
    """Matmul over a packed Q40/Q80 weight or a dense one (the plane of a
    stacked weight at flat index ``layer`` when given, a Python int or an
    int32 device tensor), cast to ``out_dtype`` (cfg.dtype)."""
    return mm(x, w, layer, impl=cfg.quant_impl, out_dtype=out_dtype or cfg.dtype)


def update_cache_at(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                    layer: int, pos) -> None:
    """Write one layer's step KV (B, Hkv, T, Dh) into the stacked cache at
    ``(layer, pos)``, in place — quantizing to int8 values and
    per-position scales first when the cache is quantized."""
    if not cache.quantized:
        update_kv_cache_at(cache.k, cache.v, k_new, v_new, layer, pos)
        return
    qk, sk = quantize_kv(k_new)
    qv, sv = quantize_kv(v_new)
    update_kv_cache_at(cache.k, cache.v, qk, qv, layer, pos)
    update_kv_cache_at(cache.k_scale, cache.v_scale, sk, sv, layer, pos)


def _slot_attention(q, k, v, layer: int, cfg: ModelConfig, cache: KVCache,
                    pos_rows, paged):
    """Write this layer's step KV at per-row positions and read it back
    with per-row ceilings: through the page table when ``paged`` is
    ``(page_table, pidx, oidx)``, else into contiguous slot rows."""
    if paged is None:
        update_kv_cache_rows(cache.k, cache.v, k, v, layer, pos_rows)
        return slot_gqa_attention_at(q, cache.k, cache.v, layer, pos_rows)
    page_table, pidx, oidx = paged
    scales = None
    if cache.quantized:
        # int8 pages: quantize the step window once and scatter values and
        # scales through the same indices; attention dequantizes on read
        qk, sk = quantize_kv(k)
        qv, sv = quantize_kv(v)
        paged_update_kv_rows(cache.k, cache.v, qk, qv, layer, pidx, oidx)
        paged_update_kv_rows(cache.k_scale, cache.v_scale, sk, sv, layer, pidx, oidx)
        scales = (cache.k_scale, cache.v_scale)
    else:
        paged_update_kv_rows(cache.k, cache.v, k, v, layer, pidx, oidx)
    return paged_gqa_attention_at(q, cache.k, cache.v, layer, page_table,
                                  pos_rows, scales, impl=cfg.attn_impl)


def _attend(x, params: Params, layer: int, cfg: ModelConfig, cache: KVCache,
            cos, sin, pos: int, pos_rows=None, paged=None, offsets=None,
            tp: int = 1) -> torch.Tensor:
    """Attention of ``x`` up to its output projection over one rank's
    heads (all of them at ``tp`` = 1): (B, T, Hq/tp·Dh)."""
    b, t, _ = x.shape
    hq, hkv, dh = cfg.n_heads // tp, cfg.n_kv_heads // tp, cfg.head_size
    xb = rmsnorm(x, params["rms_att"][layer])
    if "wqkv" in params:  # fused projection (quantized load): one kernel launch
        qkv = _mm(xb, params["wqkv"], cfg, layer)
        q, k, v = torch.split(qkv, [hq * dh, hkv * dh, hkv * dh], dim=-1)
    else:
        q, k, v = (_mm(xb, params[n], cfg, layer) for n in ("wq", "wk", "wv"))
    q = apply_rope(q.reshape(b, t, hq, dh), cos, sin, interleaved=cfg.rope_interleaved)
    k = apply_rope(k.reshape(b, t, hkv, dh), cos, sin, interleaved=cfg.rope_interleaved)
    q = q.transpose(1, 2)  # (B, Hq, T, Dh)
    k = k.transpose(1, 2)
    v = v.reshape(b, t, hkv, dh).transpose(1, 2)
    if pos_rows is not None:
        att = _slot_attention(q, k, v, layer, cfg, cache, pos_rows, paged)
    else:
        update_cache_at(cache, k, v, layer, pos)
        att = gqa_attention_at(q, cache.k, cache.v, layer, pos, t, start=offsets,
                               scales=(cache.k_scale, cache.v_scale)
                               if cache.quantized else None)
    return att.transpose(1, 2).reshape(b, t, hq * dh)


def _attention_block(x, params: Params, layer: int, cfg: ModelConfig,
                     cache: KVCache, cos, sin, pos: int, pos_rows=None,
                     paged=None, offsets=None) -> torch.Tensor:
    att = _attend(x, params, layer, cfg, cache, cos, sin, pos, pos_rows, paged, offsets)
    return _mm(att, params["wo"], cfg, layer)


def _dense_ffn(xb, params: Params, layer: int, cfg: ModelConfig) -> torch.Tensor:
    act = ACTIVATIONS[cfg.hidden_act]
    if "w13" in params:  # fused gate+up (quantized load)
        h1, h3 = torch.chunk(_mm(xb, params["w13"], cfg, layer), 2, dim=-1)
        h = act(h1) * h3
    else:
        h = act(_mm(xb, params["w1"], cfg, layer)) * _mm(xb, params["w3"], cfg, layer)
    return _mm(h, params["w2"], cfg, layer)


def _route(xb2d: torch.Tensor, router: torch.Tensor, k: int):
    """The top-k experts (N, k) of each token and their renormalized
    weights (N, k) f32."""
    logits = xb2d.to(torch.float32) @ router.to(torch.float32)
    top_vals, top_idx = top_k(softmax_f32(logits), k)         # (N, k)
    return top_idx, top_vals / torch.sum(top_vals, dim=-1, keepdim=True)


def moe_ffn(xb2d: torch.Tensor, params: Params, layer: int,
            cfg: ModelConfig) -> torch.Tensor:
    """Mixture-of-experts FFN of layer ``layer`` over ``xb2d`` (N, D).

    Routing: softmax over all expert logits in f32, top-k (ties to the
    lower expert, as ``jax.lax.top_k``), the selected probabilities
    renormalized.  Two routes, chosen by the token count as the JAX
    package chooses them:

    * N <= ``MOE_DECODE_MAX_TOKENS``: only the k selected experts.  Packed
      experts run one fused matmul per (token, slot) at the flat index
      ``layer·E + expert``, an int32 computed on the device and read there
      by the kernel: reads are bounded by the k experts' packed bytes and
      the host never waits for the router.  Dense experts: gather + einsum.
    * more tokens: every expert, weighted by a dense (N, E) mask; packed
      experts one at a time (one expert dequantized at a time on the plain
      route), dense ones as einsums over the expert axis.
    """
    n, d = xb2d.shape
    e, k = cfg.n_experts, cfg.n_active_experts
    act = ACTIVATIONS[cfg.hidden_act]
    top_idx, weights = _route(xb2d, params["router"][layer], k)
    up, gate, down = params["up"], params["gate"], params["down"]
    quant = not isinstance(up, torch.Tensor)

    if n <= MOE_DECODE_MAX_TOKENS and quant:
        flat = top_idx.to(torch.int32) + layer * e            # (N, k) on the device
        outs = []
        for i in range(n):
            xi = xb2d[i:i + 1]
            acc = torch.zeros((1, d), dtype=torch.float32, device=xb2d.device)
            for j in range(k):
                sel = flat[i, j]
                h = act(_mm(xi, gate, cfg, sel)) * _mm(xi, up, cfg, sel)
                o = _mm(h, down, cfg, sel, out_dtype=torch.float32)
                acc = acc + weights[i, j] * o
            outs.append(acc)
        return torch.cat(outs, 0).to(cfg.dtype)

    if n <= MOE_DECODE_MAX_TOKENS:  # dense experts: gather the selected ones
        up_w, gate_w, down_w = (w[layer][top_idx] for w in (up, gate, down))
        h = act(torch.einsum("nd,nkdf->nkf", xb2d, gate_w)) * \
            torch.einsum("nd,nkdf->nkf", xb2d, up_w)
        out = torch.einsum("nkf,nkfd->nkd", h, down_w)
        return torch.einsum("nk,nkd->nd", weights.to(out.dtype), out)

    dense_w = torch.zeros((n, e), dtype=weights.dtype, device=xb2d.device)
    dense_w = dense_w.scatter(-1, top_idx, weights)
    if quant:
        out = torch.zeros((n, d), dtype=torch.float32, device=xb2d.device)
        for ei in range(e):
            flat = layer * e + ei
            h = act(_mm(xb2d, gate, cfg, flat)) * _mm(xb2d, up, cfg, flat)
            oe = _mm(h, down, cfg, flat, out_dtype=torch.float32)
            out = out + dense_w[:, ei:ei + 1].to(torch.float32) * oe
        return out.to(cfg.dtype)
    h = act(torch.einsum("nd,edf->nef", xb2d, gate[layer])) * \
        torch.einsum("nd,edf->nef", xb2d, up[layer])
    outs = torch.einsum("nef,efd->ned", h, down[layer])
    return torch.einsum("ne,ned->nd", dense_w.to(outs.dtype), outs)


def run_blocks(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
               cache: KVCache, pos: int, pos_rows: torch.Tensor | None = None,
               paged=None, offsets: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, KVCache]:
    """Embed + all transformer blocks; returns the residual stream
    (B, T, D) and the cache (updated in place).  ``pos_rows`` (B,) gives
    every row its own clock (slot requests start at cache position 0, so
    cache position is the RoPE position).  ``offsets`` (B,) is a ragged
    batch's left padding: row ``r``'s prompt is right-aligned, its real
    tokens sit at cache positions ``offsets[r]..``, its RoPE positions are
    the cache position minus the offset (pad slots clamp to 0) and its
    attention never sees keys below the offset, so each row decodes as it
    would alone.  Params placed over a mesh (``Placed``) with a
    :class:`ShardedKV` run the TP walk; the residual stream is then a list,
    one copy a rank."""
    if isinstance(params, Placed):
        return _run_blocks_tp(params, cfg, tokens, cache, pos, pos_rows, paged, offsets)
    b, t = tokens.shape
    x, cos, sin = _embed(params, cfg, tokens, pos, pos_rows, offsets)
    for layer in range(cfg.n_layers):
        att = _attention_block(x, params, layer, cfg, cache, cos, sin, pos,
                               pos_rows, paged, offsets)
        if cfg.post_block_norms:
            att = rmsnorm(att, params["rms_ffn"][layer])
        x = x + att
        if cfg.is_moe:
            pre = params["rms_moe" if cfg.post_block_norms else "rms_ffn"][layer]
            xb = rmsnorm(x, pre)
            ff = moe_ffn(xb.reshape(b * t, cfg.dim), params, layer, cfg)
            ff = ff.reshape(b, t, cfg.dim)
            if cfg.post_block_norms:
                ff = rmsnorm(ff, params["rms_ffn2"][layer])
        else:
            ff = _dense_ffn(rmsnorm(x, params["rms_ffn"][layer]), params, layer, cfg)
        x = x + ff
    return x, cache


def _embed(params: Params, cfg: ModelConfig, tokens: torch.Tensor, pos: int,
           pos_rows=None, offsets=None):
    """The embedded tokens (B, T, D) and the RoPE angles of their
    positions (see :func:`run_blocks`)."""
    t = tokens.shape[1]
    x = params["embedding"][tokens.long()].to(cfg.dtype)
    if cfg.embedding_scale != 1.0:
        # the scale rounded to the activation dtype first, as the JAX
        # package multiplies by jnp.asarray(scale, dtype)
        x = x * torch.tensor(cfg.embedding_scale, dtype=cfg.dtype).item()
    at = pos.at if isinstance(pos, DevicePos) else pos
    positions = at + torch.arange(t, device=tokens.device)
    if pos_rows is not None:
        positions = pos_rows.long()[:, None] + positions[None, :]
    elif offsets is not None:
        positions = torch.clamp(positions[None, :] - offsets.long()[:, None], min=0)
    cos, sin = rope_angles(positions, cfg.head_size, cfg.rope_theta)
    return x, cos, sin


# ---------------------------------------------------------------------------
# Tensor parallelism: the SPMD program written out over the mesh's ranks
# ---------------------------------------------------------------------------

def _on(a, dev):
    """``a`` on ``dev`` (None and Python ints pass; a no-op when there)."""
    return a.to(dev) if isinstance(a, torch.Tensor) else a


def _row_mm(xs: list, placed: Placed, key: str, cfg: ModelConfig, layer=None) -> list:
    """Each rank's slice of a row-sliced matmul's output, no communication.
    (Every row-sliced weight but wcls divides once ``check_tp_constraint``
    holds: whole heads and a hidden dim that divides.)"""
    return [_mm(x, p[key], cfg, _on(layer, x.device)) for x, p in zip(xs, placed.ranks)]


def _col_mm(hs: list, placed: Placed, key: str, cfg: ModelConfig, layer=None,
            out_dtype=None) -> list:
    """A column-sliced matmul: every rank's f32 partial sum over its slice
    of the input, summed by kernel 4, then cast to ``out_dtype``
    (cfg.dtype) — the JAX package's order (all-reduce before the cast).  A
    replicated weight (it did not divide) gathers the whole input on every
    rank instead and runs the whole product there."""
    out_dtype = out_dtype or cfg.dtype
    if placed.kinds[key] == COL:
        parts = [mm(h, p[key], _on(layer, h.device), impl=cfg.quant_impl,
                    out_dtype=torch.float32) for h, p in zip(hs, placed.ranks)]
        return [s.to(out_dtype) for s in tp_allreduce(parts, cfg.quant_impl)]
    outs = []
    for p, dev in zip(placed.ranks, placed.mesh.devices):
        whole = torch.cat([h.to(dev) for h in hs], dim=-1)
        outs.append(_mm(whole, p[key], cfg, _on(layer, dev), out_dtype))
    return outs


def _allreduce_as(parts: list, cfg: ModelConfig) -> list:
    """Kernel 4 over partials of any float dtype: summed in f32, returned
    in the partials' dtype."""
    dt = parts[0].dtype
    return [s.to(dt) for s in tp_allreduce([p.to(torch.float32).contiguous()
                                            for p in parts], cfg.quant_impl)]


def _dense_ffn_tp(xbs: list, placed: Placed, layer: int, cfg: ModelConfig) -> list:
    act = ACTIVATIONS[cfg.hidden_act]
    h1 = _row_mm(xbs, placed, "w1", cfg, layer)
    h3 = _row_mm(xbs, placed, "w3", cfg, layer)
    return _col_mm([act(a) * b for a, b in zip(h1, h3)], placed, "w2", cfg, layer)


def _moe_ffn_tp(xbs: list, placed: Placed, layer: int, cfg: ModelConfig) -> list:
    """:func:`moe_ffn` over the ranks: the experts sliced on their hidden
    dim (``up``/``gate`` row, ``down`` col), the routing on rank 0, each
    expert's down partials summed by kernel 4 before the routing weight
    (the JAX package's order)."""
    n, d = xbs[0].shape
    e, k = cfg.n_experts, cfg.n_active_experts
    act = ACTIVATIONS[cfg.hidden_act]
    ranks, devs = placed.ranks, placed.mesh.devices
    top_idx, weights = _route(xbs[0], ranks[0]["router"][layer], k)
    w_at = [weights.to(dev) for dev in devs]
    quant = not isinstance(ranks[0]["up"], torch.Tensor)

    def expert(xs, flat):  # one expert's down output on every rank, f32
        h = [act(a) * b for a, b in zip(_row_mm(xs, placed, "gate", cfg, flat),
                                        _row_mm(xs, placed, "up", cfg, flat))]
        return _col_mm(h, placed, "down", cfg, flat, out_dtype=torch.float32)

    if n <= MOE_DECODE_MAX_TOKENS and quant:
        flat = top_idx.to(torch.int32) + layer * e            # (N, k) on rank 0
        outs = [[] for _ in devs]
        for i in range(n):
            xs = [xb[i:i + 1] for xb in xbs]
            acc = [torch.zeros((1, d), dtype=torch.float32, device=dev) for dev in devs]
            for j in range(k):
                o = expert(xs, flat[i, j])
                acc = [a + w[i, j] * oe for a, w, oe in zip(acc, w_at, o)]
            for r, a in enumerate(acc):
                outs[r].append(a)
        return [torch.cat(o, 0).to(cfg.dtype) for o in outs]

    # dense experts are sliced like packed ones; hidden_dim % tp == 0
    # (check_tp_constraint) makes their down always divide
    if n <= MOE_DECODE_MAX_TOKENS:  # dense experts: gather the selected ones
        parts = []
        for xb, p in zip(xbs, ranks):
            idx = top_idx.to(xb.device)
            up_w, gate_w, down_w = (p[w][layer][idx] for w in ("up", "gate", "down"))
            h = act(torch.einsum("nd,nkdf->nkf", xb, gate_w)) * \
                torch.einsum("nd,nkdf->nkf", xb, up_w)
            parts.append(torch.einsum("nkf,nkfd->nkd", h, down_w))
        return [torch.einsum("nk,nkd->nd", w.to(o.dtype), o)
                for w, o in zip(w_at, _allreduce_as(parts, cfg))]

    dense_w = torch.zeros((n, e), dtype=weights.dtype, device=weights.device)
    dense_w = dense_w.scatter(-1, top_idx, weights)
    dw_at = [dense_w.to(dev) for dev in devs]
    if quant:
        out = [torch.zeros((n, d), dtype=torch.float32, device=dev) for dev in devs]
        for ei in range(e):
            oe = expert(xbs, layer * e + ei)
            out = [o + dw[:, ei:ei + 1].to(torch.float32) * x
                   for o, dw, x in zip(out, dw_at, oe)]
        return [o.to(cfg.dtype) for o in out]
    parts = []
    for xb, p in zip(xbs, ranks):
        h = act(torch.einsum("nd,edf->nef", xb, p["gate"][layer])) * \
            torch.einsum("nd,edf->nef", xb, p["up"][layer])
        parts.append(torch.einsum("nef,efd->ned", h, p["down"][layer]))
    return [torch.einsum("ne,ned->nd", dw.to(o.dtype), o)
            for dw, o in zip(dw_at, _allreduce_as(parts, cfg))]


def _run_blocks_tp(placed: Placed, cfg: ModelConfig, tokens: torch.Tensor,
                   cache: ShardedKV, pos: int, pos_rows=None, paged=None,
                   offsets=None) -> tuple[list, ShardedKV]:
    """:func:`run_blocks` over the mesh's ranks; returns each rank's copy
    of the residual stream, on its device."""
    tp, devs, ranks = placed.tp, placed.mesh.devices, placed.ranks
    b, t = tokens.shape
    xs, rope, args = [], [], []
    for dev, p in zip(devs, ranks):
        x, cos, sin = _embed(p, cfg, tokens.to(dev), pos, _on(pos_rows, dev),
                             _on(offsets, dev))
        xs.append(x)
        rope.append((cos, sin))
        args.append((_on(pos_rows, dev), None if paged is None else
                     tuple(a.to(dev) for a in paged), _on(offsets, dev)))
    for layer in range(cfg.n_layers):
        atts = [_attend(x, p, layer, cfg, kv, cos, sin, pos, *a, tp=tp)
                for x, p, kv, (cos, sin), a in zip(xs, ranks, cache.ranks, rope, args)]
        att = _col_mm(atts, placed, "wo", cfg, layer)
        if cfg.post_block_norms:
            att = [rmsnorm(a, p["rms_ffn"][layer]) for a, p in zip(att, ranks)]
        xs = [x + a for x, a in zip(xs, att)]
        if cfg.is_moe:
            pre = "rms_moe" if cfg.post_block_norms else "rms_ffn"
            xbs = [rmsnorm(x, p[pre][layer]).reshape(b * t, cfg.dim)
                   for x, p in zip(xs, ranks)]
            ff = [f.reshape(b, t, cfg.dim) for f in _moe_ffn_tp(xbs, placed, layer, cfg)]
            if cfg.post_block_norms:
                ff = [rmsnorm(f, p["rms_ffn2"][layer]) for f, p in zip(ff, ranks)]
        else:
            xbs = [rmsnorm(x, p["rms_ffn"][layer]) for x, p in zip(xs, ranks)]
            ff = _dense_ffn_tp(xbs, placed, layer, cfg)
        xs = [x + f for x, f in zip(xs, ff)]
    return xs, cache


def _each(x, fn):
    """``fn`` over the residual stream: one tensor, or one a TP rank."""
    return [fn(a) for a in x] if isinstance(x, list) else fn(x)


def _head(params: Params, cfg: ModelConfig, x) -> torch.Tensor:
    if isinstance(params, Placed):
        return _head_tp(params, cfg, x)
    x = rmsnorm(x, params["rms_final"])
    # f32 logits: the matmul's f32 accumulation goes to the sampler without
    # a round trip through the activation dtype
    logits = _mm(x, params["wcls"], cfg, out_dtype=torch.float32)
    if cfg.logit_scale != 1.0:
        logits = logits * cfg.logit_scale
    return logits


def _head_tp(placed: Placed, cfg: ModelConfig, xs: list) -> torch.Tensor:
    """The vocab-sliced logits of every rank, gathered in rank order on
    rank 0's device (a replicated wcls: rank 0's whole product)."""
    xs = [rmsnorm(x, p["rms_final"]) for x, p in zip(xs, placed.ranks)]
    dev0 = placed.mesh.device
    if placed.kinds["wcls"] == ROW:
        logits = torch.cat([_mm(x, p["wcls"], cfg, out_dtype=torch.float32).to(dev0)
                            for x, p in zip(xs, placed.ranks)], dim=-1)
    else:
        logits = _mm(xs[0], placed.ranks[0]["wcls"], cfg, out_dtype=torch.float32)
    if cfg.logit_scale != 1.0:
        logits = logits * cfg.logit_scale
    return logits


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            cache: KVCache, pos: int, offsets: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, KVCache]:
    """Run the model over ``tokens`` (B, T) from position ``pos``; returns
    logits (B, T, V) f32 and the cache.  ``offsets``: see :func:`run_blocks`."""
    x, cache = run_blocks(params, cfg, tokens, cache, pos, offsets=offsets)
    return _head(params, cfg, x), cache


def forward_last(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                 cache: KVCache, pos: int, last_index: int,
                 offsets: torch.Tensor | None = None) -> tuple[torch.Tensor, KVCache]:
    """Like :func:`forward` with the LM head applied at ``last_index`` only:
    returns (B, V)."""
    x, cache = run_blocks(params, cfg, tokens, cache, pos, offsets=offsets)
    return _head(params, cfg, _each(x, lambda a: a[:, last_index])), cache


def forward_slots(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  cache: KVCache, pos_rows: torch.Tensor, n_valid: torch.Tensor,
                  page_table: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, KVCache]:
    """Continuous-batching slot step: row ``r`` of ``tokens`` (B, T)
    occupies positions ``pos_rows[r]..pos_rows[r]+T-1`` and only its first
    ``n_valid[r]`` tokens are real.  Returns the logits (B, V) f32 at each
    row's last valid token and the cache.  A prefilling row feeds a prompt
    chunk, a decoding row its previous sample plus padding, a free row
    rides at position 0; rows never see each other, so each row's stream
    is the one it would decode alone.  With ``page_table`` (B, max_pages)
    int32 the cache is a paged pool and invalid-token writes go to the
    scratch page (the write indices are computed once for all layers)."""
    b, t = tokens.shape
    paged = None
    if page_table is not None:
        pidx, oidx = paged_write_indices(page_table, pos_rows, n_valid, t,
                                         cache.k.shape[3])
        paged = (page_table, pidx, oidx)
    x, cache = run_blocks(params, cfg, tokens, cache, 0, pos_rows=pos_rows,
                          paged=paged)
    last = torch.clamp(n_valid.long() - 1, 0, t - 1)
    x_last = _each(x, lambda a: a[torch.arange(b, device=a.device),
                                  last.to(a.device)])  # (B, D)
    return _head(params, cfg, x_last), cache
