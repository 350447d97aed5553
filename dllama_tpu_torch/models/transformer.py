"""The forward pass — the port of ``dllama_tpu/models/transformer.py``:
Llama (dense FFN), Mixtral and Grok-1 (mixture of experts, Grok's
embedding and logit scales and post-block norms); a contiguous KV cache,
contiguous slot rows, or a paged KV pool.

One function serves prefill (T > 1) and decode (T == 1): tokens enter as
``(B, T)``, the KV cache as stacked ``(L, B, Hkv, S, Dh)`` buffers, and
``pos`` is the position of the first token.  :func:`forward_slots` is the
continuous-batching step: every row has its own clock (``pos_rows``), over
contiguous slot rows or a paged pool (``(L, P, Hkv, ps, Dh)`` addressed
through a page table).  The layer loop is a Python loop over the layer
index of the stacked weights; a packed Q40/Q80 weight is read in place at
that index by its kernel, never sliced into a copy, and an expert chosen
on the device is read at its flat index ``layer·E + expert`` the same way.
Every ``astype(cfg.dtype)`` rounding point of the JAX code is kept (the
matmul outputs, the residual stream).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.attention import (gqa_attention_at, paged_gqa_attention_at,
                             paged_update_kv_rows, paged_write_indices,
                             quantize_kv, slot_gqa_attention_at,
                             update_kv_cache_at, update_kv_cache_rows)
from ..ops.kernels import (ACTIVATIONS, apply_rope, rmsnorm, rope_angles,
                           softmax_f32, top_k)
from ..ops.q40 import mm
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


def init_kv_cache(cfg: ModelConfig, batch: int, seq_len: int | None = None,
                  dtype=None, device="cpu") -> KVCache:
    """Preallocated full-length cache in ``dtype`` (default cfg.dtype)."""
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, seq_len or cfg.seq_len,
             cfg.head_size)
    dt = dtype or cfg.dtype
    return KVCache(torch.zeros(shape, dtype=dt, device=device),
                   torch.zeros(shape, dtype=dt, device=device))


def init_kv_pool(cfg: ModelConfig, n_pages: int, page_size: int, dtype=None,
                 quant: bool = False, device="cpu") -> KVCache:
    """Paged KV pool ``(L, n_pages, Hkv, page_size, Dh)``; page 0 is the
    reserved scratch page.  ``quant`` stores int8 values plus a
    per-(page, head, position) f32 scale plane ``(L, P, Hkv, ps, 1)``."""
    shape = (cfg.n_layers, n_pages, cfg.n_kv_heads, page_size, cfg.head_size)
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


def _attention_block(x, params: Params, layer: int, cfg: ModelConfig,
                     cache: KVCache, cos, sin, pos: int, pos_rows=None,
                     paged=None, offsets=None) -> torch.Tensor:
    b, t, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_size
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
        update_kv_cache_at(cache.k, cache.v, k, v, layer, pos)
        att = gqa_attention_at(q, cache.k, cache.v, layer, pos, t, start=offsets)
    att = att.transpose(1, 2).reshape(b, t, hq * dh)
    return _mm(att, params["wo"], cfg, layer)


def _dense_ffn(xb, params: Params, layer: int, cfg: ModelConfig) -> torch.Tensor:
    act = ACTIVATIONS[cfg.hidden_act]
    if "w13" in params:  # fused gate+up (quantized load)
        h1, h3 = torch.chunk(_mm(xb, params["w13"], cfg, layer), 2, dim=-1)
        h = act(h1) * h3
    else:
        h = act(_mm(xb, params["w1"], cfg, layer)) * _mm(xb, params["w3"], cfg, layer)
    return _mm(h, params["w2"], cfg, layer)


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
    logits = xb2d.to(torch.float32) @ params["router"][layer].to(torch.float32)
    top_vals, top_idx = top_k(softmax_f32(logits), k)         # (N, k)
    weights = top_vals / torch.sum(top_vals, dim=-1, keepdim=True)
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
    would alone."""
    b, t = tokens.shape
    x = params["embedding"][tokens.long()].to(cfg.dtype)
    if cfg.embedding_scale != 1.0:
        # the scale rounded to the activation dtype first, as the JAX
        # package multiplies by jnp.asarray(scale, dtype)
        x = x * torch.tensor(cfg.embedding_scale, dtype=cfg.dtype).item()
    positions = pos + torch.arange(t, device=tokens.device)
    if pos_rows is not None:
        positions = pos_rows.long()[:, None] + positions[None, :]
    elif offsets is not None:
        positions = torch.clamp(positions[None, :] - offsets.long()[:, None], min=0)
    cos, sin = rope_angles(positions, cfg.head_size, cfg.rope_theta)
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


def _head(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rmsnorm(x, params["rms_final"])
    # f32 logits: the matmul's f32 accumulation goes to the sampler without
    # a round trip through the activation dtype
    logits = _mm(x, params["wcls"], cfg, out_dtype=torch.float32)
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
    return _head(params, cfg, x[:, last_index]), cache


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
    x_last = x[torch.arange(b, device=x.device), last]  # (B, D)
    return _head(params, cfg, x_last), cache
