"""Llama forward pass — the port of ``dllama_tpu/models/transformer.py``
(dense FFN, contiguous KV cache).

One function serves prefill (T > 1) and decode (T == 1): tokens enter as
``(B, T)``, the KV cache as stacked ``(L, B, Hkv, S, Dh)`` buffers, and
``pos`` is the position of the first token.  The layer loop is a Python
loop over the layer index of the stacked weights; a packed Q40 weight is
read in place at that index by the kernel, never sliced into a copy.
Every ``astype(cfg.dtype)`` rounding point of the JAX code is kept (the
matmul outputs, the residual stream).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import q40
from ..ops.attention import gqa_attention_at, update_kv_cache_at
from ..ops.kernels import ACTIVATIONS, apply_rope, rmsnorm, rope_angles
from .config import ModelConfig
from .params import Params


class KVCache(NamedTuple):
    k: torch.Tensor  # (L, B, Hkv, S, Dh)
    v: torch.Tensor


def init_kv_cache(cfg: ModelConfig, batch: int, seq_len: int | None = None,
                  dtype=None, device="cpu") -> KVCache:
    """Preallocated full-length cache in ``dtype`` (default cfg.dtype)."""
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, seq_len or cfg.seq_len,
             cfg.head_size)
    dt = dtype or cfg.dtype
    return KVCache(torch.zeros(shape, dtype=dt, device=device),
                   torch.zeros(shape, dtype=dt, device=device))


def _mm(x: torch.Tensor, w, cfg: ModelConfig, layer: int | None = None,
        out_dtype=None) -> torch.Tensor:
    """Matmul over a packed Q40 weight or a dense one (a layer of a stacked
    weight when ``layer`` is given), cast to ``out_dtype`` (cfg.dtype)."""
    out_dtype = out_dtype or cfg.dtype
    if isinstance(w, q40.QTensor):
        return q40.matmul(x, w, layer=layer, out_dtype=out_dtype,
                          impl=cfg.quant_impl)
    wl = w if layer is None else w[layer]
    return (x @ wl).to(out_dtype)


def _attention_block(x, params: Params, layer: int, cfg: ModelConfig,
                     cache: KVCache, cos, sin, pos: int) -> torch.Tensor:
    b, t, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_size
    xb = rmsnorm(x, params["rms_att"][layer])
    if "wqkv" in params:  # fused projection (Q40 load): one kernel launch
        qkv = _mm(xb, params["wqkv"], cfg, layer)
        q, k, v = torch.split(qkv, [hq * dh, hkv * dh, hkv * dh], dim=-1)
    else:
        q, k, v = (_mm(xb, params[n], cfg, layer) for n in ("wq", "wk", "wv"))
    q = apply_rope(q.reshape(b, t, hq, dh), cos, sin, interleaved=cfg.rope_interleaved)
    k = apply_rope(k.reshape(b, t, hkv, dh), cos, sin, interleaved=cfg.rope_interleaved)
    q = q.transpose(1, 2)  # (B, Hq, T, Dh)
    k = k.transpose(1, 2)
    v = v.reshape(b, t, hkv, dh).transpose(1, 2)
    update_kv_cache_at(cache.k, cache.v, k, v, layer, pos)
    att = gqa_attention_at(q, cache.k, cache.v, layer, pos, t)
    att = att.transpose(1, 2).reshape(b, t, hq * dh)
    return _mm(att, params["wo"], cfg, layer)


def _dense_ffn(xb, params: Params, layer: int, cfg: ModelConfig) -> torch.Tensor:
    act = ACTIVATIONS[cfg.hidden_act]
    if "w13" in params:  # fused gate+up (Q40 load)
        h1, h3 = torch.chunk(_mm(xb, params["w13"], cfg, layer), 2, dim=-1)
        h = act(h1) * h3
    else:
        h = act(_mm(xb, params["w1"], cfg, layer)) * _mm(xb, params["w3"], cfg, layer)
    return _mm(h, params["w2"], cfg, layer)


def run_blocks(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
               cache: KVCache, pos: int) -> tuple[torch.Tensor, KVCache]:
    """Embed + all transformer blocks; returns the residual stream
    (B, T, D) and the cache (updated in place)."""
    if cfg.is_moe:
        raise NotImplementedError("MoE blocks are not yet ported to "
                                  "dllama_tpu_torch")
    t = tokens.shape[1]
    x = params["embedding"][tokens.long()].to(cfg.dtype)
    positions = pos + torch.arange(t, device=tokens.device)
    cos, sin = rope_angles(positions, cfg.head_size, cfg.rope_theta)
    for layer in range(cfg.n_layers):
        x = x + _attention_block(x, params, layer, cfg, cache, cos, sin, pos)
        xb = rmsnorm(x, params["rms_ffn"][layer])
        x = x + _dense_ffn(xb, params, layer, cfg)
    return x, cache


def _head(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rmsnorm(x, params["rms_final"])
    # f32 logits: the matmul's f32 accumulation goes to the sampler without
    # a round trip through the activation dtype
    return _mm(x, params["wcls"], cfg, out_dtype=torch.float32)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            cache: KVCache, pos: int) -> tuple[torch.Tensor, KVCache]:
    """Run the model over ``tokens`` (B, T) from position ``pos``; returns
    logits (B, T, V) f32 and the cache."""
    x, cache = run_blocks(params, cfg, tokens, cache, pos)
    return _head(params, cfg, x), cache


def forward_last(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                 cache: KVCache, pos: int, last_index: int
                 ) -> tuple[torch.Tensor, KVCache]:
    """Like :func:`forward` with the LM head applied at ``last_index`` only:
    returns (B, V)."""
    x, cache = run_blocks(params, cfg, tokens, cache, pos)
    return _head(params, cfg, x[:, last_index]), cache
