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
Over a mesh that spans processes each process walks its own ranks only,
and the moves between ranks cross processes (``parallel/comm.py``:
kernel 4's cross-process body, the logits gathered to process 0 — the
other processes' heads return None —, the routing broadcast from rank 0).

The mesh's other axes (one process): dp gives each data group its rows of
the batch; the ranks at expert shard 0 run attention and the dense FFN, one
"cell" of tp ranks a group, whose caches hold ``seq_len/sp`` positions
each with sp (``ops/sp_attention.py``: a from-scratch prefill cut over the
shards through ring attention, otherwise the one-round combine over every
shard, kernel 4 summing the partials); with ep a MoE FFN also runs on the
cell's other expert shards, an expert on its owner alone
(``ops.q40.ep_matmul``).  The logits of each group are gathered over tp and
the groups' rows stacked.
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
from ..ops.q40 import ep_matmul, mm, tp_allreduce
from ..ops.sp_attention import (ring_attention, sp_gqa_attention, sp_update_kv_cache_at,
                                sp_update_kv_window_at)
from ..parallel import comm
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


def _qkv(x, params: Params, layer: int, cfg: ModelConfig, cos, sin, tp: int = 1):
    """The roped queries (B, Hq/tp, T, Dh), keys and values (B, Hkv/tp, T,
    Dh) of ``x`` over one rank's heads (all of them at ``tp`` = 1)."""
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
    return (q.transpose(1, 2), k.transpose(1, 2),   # (B, H, T, Dh)
            v.reshape(b, t, hkv, dh).transpose(1, 2))


def _heads_out(att: torch.Tensor) -> torch.Tensor:
    """(B, H, T, Dh) attention output as the output projection's (B, T, H·Dh)."""
    b, h, t, dh = att.shape
    return att.transpose(1, 2).reshape(b, t, h * dh)


def _attend(x, params: Params, layer: int, cfg: ModelConfig, cache: KVCache,
            cos, sin, pos: int, pos_rows=None, paged=None, offsets=None,
            tp: int = 1) -> torch.Tensor:
    """Attention of ``x`` up to its output projection over one rank's
    heads (all of them at ``tp`` = 1): (B, T, Hq/tp·Dh)."""
    q, k, v = _qkv(x, params, layer, cfg, cos, sin, tp)
    t = x.shape[1]
    if pos_rows is not None:
        att = _slot_attention(q, k, v, layer, cfg, cache, pos_rows, paged)
    else:
        update_cache_at(cache, k, v, layer, pos)
        att = gqa_attention_at(q, cache.k, cache.v, layer, pos, t, start=offsets,
                               scales=(cache.k_scale, cache.v_scale)
                               if cache.quantized else None)
    return _heads_out(att)


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
# Tensor parallelism and the other mesh axes: the SPMD program written out
# over the mesh's ranks
# ---------------------------------------------------------------------------

def _on(a, dev):
    """``a`` on ``dev`` (None and Python ints pass; a no-op when there)."""
    return a.to(dev) if isinstance(a, torch.Tensor) else a


def _p(placed: Placed, r: int) -> dict:
    """Global rank ``r``'s params."""
    return placed.ranks[placed.mesh.local(r)]


def _row_mm(xs: list, placed: Placed, key: str, cfg: ModelConfig, grp: list,
            layer=None) -> list:
    """Each rank of ``grp`` (one cell's tp ranks) takes its slice of a
    row-sliced matmul's output, no communication.  (Every row-sliced weight
    but wcls divides once ``check_tp_constraint`` holds: whole heads and a
    hidden dim that divides.)"""
    return [_mm(x, _p(placed, r)[key], cfg, _on(layer, x.device)) for x, r in zip(xs, grp)]


def _col_mm(hs: list, placed: Placed, key: str, cfg: ModelConfig, grp: list,
            layer=None, out_dtype=None) -> list:
    """A column-sliced matmul over ``grp`` (one cell's tp ranks): every
    rank's f32 partial sum over its slice of the input, summed by kernel 4,
    then cast to ``out_dtype`` (cfg.dtype) — the JAX package's order
    (all-reduce before the cast).  A replicated weight (it did not divide)
    gathers the whole input on every rank instead and runs the whole
    product there; at tp = 1 it is the one rank's product."""
    out_dtype = out_dtype or cfg.dtype
    mesh = placed.mesh
    if placed.kinds[key] == COL:
        parts = [mm(h, _p(placed, r)[key], _on(layer, h.device), impl=cfg.quant_impl,
                    out_dtype=torch.float32) for h, r in zip(hs, grp)]
        return [s.to(out_dtype) for s in tp_allreduce(parts, cfg.quant_impl, mesh)]
    every = comm.all_gather(mesh, hs) if mesh.multi else hs
    outs = []
    for r in grp:
        dev = mesh.devices[mesh.local(r)]
        whole = torch.cat([h.to(dev) for h in every], dim=-1)
        outs.append(_mm(whole, _p(placed, r)[key], cfg, _on(layer, dev), out_dtype))
    return outs


def _allreduce_as(parts: list, cfg: ModelConfig, mesh) -> list:
    """Kernel 4 over partials of any float dtype: summed in f32, returned
    in the partials' dtype."""
    dt = parts[0].dtype
    return [s.to(dt) for s in tp_allreduce([p.to(torch.float32).contiguous()
                                            for p in parts], cfg.quant_impl, mesh)]


def _dense_ffn_tp(xbs: list, placed: Placed, layer: int, cfg: ModelConfig,
                  grp: list) -> list:
    act = ACTIVATIONS[cfg.hidden_act]
    if "w13" in placed.ranks[0]:  # tp = 1 keeps the fused gate+up
        return [_dense_ffn(xb, _p(placed, r), layer, cfg) for xb, r in zip(xbs, grp)]
    h1 = _row_mm(xbs, placed, "w1", cfg, grp, layer)
    h3 = _row_mm(xbs, placed, "w3", cfg, grp, layer)
    return _col_mm([act(a) * b for a, b in zip(h1, h3)], placed, "w2", cfg, grp, layer)


def _moe_ffn_tp(xbs: list, placed: Placed, layer: int, cfg: ModelConfig,
                grp: list) -> list:
    """:func:`moe_ffn` over one cell's ranks (``grp``: its tp ranks at
    expert shard 0, whose inputs ``xbs`` are): the experts sliced on their
    hidden dim (``up``/``gate`` row, ``down`` col), the routing on the
    cell's first rank, each expert's down partials summed by kernel 4
    before the routing weight (the JAX package's order).  Across processes
    every process routes on its first rank (for the shapes) and takes
    global rank 0's choice.

    With ep > 1 (one process) the cell's expert shards take part, shard e
    holding experts ``e·E/ep ..``, each rank given its tp slice's input.
    The host reads the routing once a layer, so that only an expert's owner
    runs it: packed experts through ``q40.ep_matmul`` (the owner launches
    kernel 2, or Q80's kernel 6, the others nothing; kernel 4 sums over ep,
    and over (ep, tp) for ``down``), dense ones as einsums over the owned
    experts (:func:`_dense_experts_ep`)."""
    n, d = xbs[0].shape
    e, k = cfg.n_experts, cfg.n_active_experts
    act = ACTIVATIONS[cfg.hidden_act]
    mesh = placed.mesh
    ranks = [_p(placed, r) for r in grp]
    devs = [x.device for x in xbs]
    top_idx, weights = _route(xbs[0], ranks[0]["router"][layer], k)
    if mesh.multi:
        top_idx, weights = comm.broadcast_from_root(mesh, [top_idx, weights])
    w_at = [weights.to(dev) for dev in devs]
    dense_w = None
    if n > MOE_DECODE_MAX_TOKENS:
        dense_w = torch.zeros((n, e), dtype=weights.dtype, device=weights.device)
        dense_w = dense_w.scatter(-1, top_idx, weights)
    if isinstance(ranks[0]["up"], torch.Tensor):
        if mesh.ep > 1:
            return _dense_experts_ep(xbs, placed, layer, cfg, grp, top_idx, w_at, dense_w)
        return _dense_experts_tp(xbs, placed, layer, cfg, grp, top_idx, w_at, dense_w)

    if mesh.ep > 1:
        cell = sorted(r for r0 in grp for r in mesh.group_ranks(("ep",), r0))
        xs_all = [xbs[i % len(grp)].to(mesh.devices[mesh.local(r)]) for i, r in enumerate(cell)]
        flat = (top_idx + layer * e).tolist()  # the host names each owner
        stacks = {key: [_p(placed, r)[key] for r in cell] for key in ("gate", "up", "down")}

        def expert(xs, f):  # one expert's down output on every cell rank, f32
            g, u = (ep_matmul(xs, stacks[key], f, ROW, mesh.ep, cfg.quant_impl)
                    for key in ("gate", "up"))
            h = [act(a.to(cfg.dtype)) * b.to(cfg.dtype) for a, b in zip(g, u)]
            if placed.kinds["down"] != COL and len(grp) > 1:
                # down replicated over tp: each rank contracts the whole hidden dim
                tp = len(grp)
                h = [torch.cat([h[j].to(x.device) for j in range(i - i % tp, i - i % tp + tp)],
                               -1) for i, x in enumerate(xs)]
                return ep_matmul(h, stacks["down"], f, ROW, mesh.ep, cfg.quant_impl)
            return ep_matmul(h, stacks["down"], f, COL, mesh.ep, cfg.quant_impl)
    else:
        xs_all = xbs
        flat = top_idx.to(torch.int32) + layer * e            # (N, k) on rank 0

        def expert(xs, f):  # one expert's down output on every rank, f32
            h = [act(a) * b for a, b in zip(_row_mm(xs, placed, "gate", cfg, grp, f),
                                            _row_mm(xs, placed, "up", cfg, grp, f))]
            return _col_mm(h, placed, "down", cfg, grp, f, out_dtype=torch.float32)

    if dense_w is None:
        outs = [[] for _ in devs]
        for i in range(n):
            xs = [x[i:i + 1] for x in xs_all]
            acc = [torch.zeros((1, d), dtype=torch.float32, device=dev) for dev in devs]
            for j in range(k):
                o = expert(xs, flat[i][j])
                acc = [a + w[i, j] * oe for a, w, oe in zip(acc, w_at, o)]
            for r, a in enumerate(acc):
                outs[r].append(a)
        return [torch.cat(o, 0).to(cfg.dtype) for o in outs]
    dw_at = [dense_w.to(dev) for dev in devs]
    out = [torch.zeros((n, d), dtype=torch.float32, device=dev) for dev in devs]
    for ei in range(e):
        oe = expert(xs_all, layer * e + ei)
        out = [o + dw[:, ei:ei + 1].to(torch.float32) * x for o, dw, x in zip(out, dw_at, oe)]
    return [o.to(cfg.dtype) for o in out]


def _dense_experts_tp(xbs: list, placed: Placed, layer: int, cfg: ModelConfig, grp: list,
                      top_idx, w_at: list, dense_w) -> list:
    """Dense experts over one cell's tp ranks (sliced like packed ones;
    hidden_dim % tp == 0, ``check_tp_constraint``, makes their down always
    divide): the selected ones gathered (``dense_w`` None), or every expert
    weighted by ``dense_w``; the down partials summed by kernel 4."""
    act = ACTIVATIONS[cfg.hidden_act]
    ranks = [_p(placed, r) for r in grp]
    parts = []
    for xb, p in zip(xbs, ranks):
        if dense_w is None:
            idx = top_idx.to(xb.device)
            up_w, gate_w, down_w = (p[w][layer][idx] for w in ("up", "gate", "down"))
            h = act(torch.einsum("nd,nkdf->nkf", xb, gate_w)) * \
                torch.einsum("nd,nkdf->nkf", xb, up_w)
            parts.append(torch.einsum("nkf,nkfd->nkd", h, down_w))
        else:
            h = act(torch.einsum("nd,edf->nef", xb, p["gate"][layer])) * \
                torch.einsum("nd,edf->nef", xb, p["up"][layer])
            parts.append(torch.einsum("nef,efd->ned", h, p["down"][layer]))
    if len(parts) > 1:
        parts = _allreduce_as(parts, cfg, placed.mesh)
    if dense_w is None:
        return [torch.einsum("nk,nkd->nd", w.to(o.dtype), o) for w, o in zip(w_at, parts)]
    return [torch.einsum("ne,ned->nd", dense_w.to(o.device, o.dtype), o) for o in parts]


def _dense_experts_ep(xbs: list, placed: Placed, layer: int, cfg: ModelConfig, grp: list,
                      top_idx, w_at: list, dense_w) -> list:
    """:func:`_dense_experts_tp` with the expert stacks cut over ep: a
    selected expert's product on its owner alone (exact zeros elsewhere),
    summed by kernel 4 over (ep, tp); all experts: each shard's own over
    tp, weighted, then summed over ep.  Returns the ``grp`` ranks'."""
    mesh = placed.mesh
    tp = len(grp)
    el = cfg.n_experts // mesh.ep
    act = ACTIVATIONS[cfg.hidden_act]
    cell = sorted(r for r0 in grp for r in mesh.group_ranks(("ep",), r0))
    xs_all = [xbs[i % tp].to(mesh.devices[mesh.local(r)]) for i, r in enumerate(cell)]
    ranks = [_p(placed, r) for r in cell]
    if dense_w is None:
        parts = []
        for i, (xb, p) in enumerate(zip(xs_all, ranks)):
            loc = top_idx.to(xb.device) - (i // tp) * el
            owned = (loc >= 0) & (loc < el)
            idx = torch.clamp(loc, 0, el - 1)
            up_w, gate_w, down_w = (p[w][layer][idx] for w in ("up", "gate", "down"))
            h = act(torch.einsum("nd,nkdf->nkf", xb, gate_w)) * \
                torch.einsum("nd,nkdf->nkf", xb, up_w)
            o = torch.einsum("nkf,nkfd->nkd", h, down_w)
            parts.append(torch.where(owned[..., None], o, torch.zeros_like(o)))
        parts = _allreduce_as(parts, cfg, mesh)
        return [torch.einsum("nk,nkd->nd", w.to(o.dtype), o) for w, o in zip(w_at, parts)]
    parts = []
    for xb, p in zip(xs_all, ranks):
        h = act(torch.einsum("nd,edf->nef", xb, p["gate"][layer])) * \
            torch.einsum("nd,edf->nef", xb, p["up"][layer])
        parts.append(torch.einsum("nef,efd->ned", h, p["down"][layer]))
    if tp > 1:  # each shard's experts' partials over tp
        parts = [s for i in range(0, len(parts), tp)
                 for s in _allreduce_as(parts[i:i + tp], cfg, mesh)]
    contrib = [torch.einsum("ne,ned->nd", dense_w[:, (i // tp) * el:(i // tp + 1) * el]
                            .to(o.device, o.dtype), o) for i, o in enumerate(parts)]
    return [_allreduce_as(contrib[t::tp], cfg, mesh)[0] for t in range(tp)]


def _sp_attend(xs: dict, placed: Placed, layer: int, cfg: ModelConfig, cache: ShardedKV,
               rope: dict, pos: int, ring: bool) -> dict:
    """Attention over a sequence-sharded cache (sp > 1), every data group d
    and tensor slice t: the cells' streams ``xs[(d, s)]`` (one a tp slice)
    give each shard its queries, keys and values.  A from-scratch prefill
    (``ring``) has its tokens cut over the shards: the window's K/V are
    written into the shards they fall in and attended by
    :func:`sp_attention.ring_attention`.  Otherwise the one stream
    (``s = 0``) holds the whole window: a single token is written on its
    owning shard alone, a longer window cut over the shards it falls in,
    and :func:`sp_attention.sp_gqa_attention` reads every shard and
    combines their partials (kernel 4 over the sp group).  Returns the
    output projection's inputs, keyed as ``xs``."""
    mesh = placed.mesh
    tp = mesh.tp
    out: dict = {c: [None] * tp for c in xs}
    for d in range(mesh.dp):
        for t in range(tp):
            shards = [mesh.rank(d, s, 0, t) for s in range(mesh.sp)]
            kvs = [_kv(cache, mesh, r) for r in shards]
            kcs, vcs = [c.k for c in kvs], [c.v for c in kvs]
            cells = [(d, s) for s in range(mesh.sp)] if ring else [(d, 0)]
            qkv = [_qkv(xs[c][t], _p(placed, mesh.rank(*c, 0, t)), layer, cfg,
                        *rope[c][t], tp) for c in cells]
            if ring:
                dev0 = kcs[0].device
                k_all = torch.cat([k.to(dev0) for _, k, _ in qkv], dim=2)
                v_all = torch.cat([v.to(dev0) for _, _, v in qkv], dim=2)
                sp_update_kv_window_at(kcs, vcs, k_all, v_all, layer, pos)
                atts = ring_attention(*map(list, zip(*qkv)), pos0=pos)
            else:
                q, k, v = qkv[0]
                if k.shape[2] == 1:
                    sp_update_kv_cache_at(kcs, vcs, k, v, layer, pos)
                else:
                    sp_update_kv_window_at(kcs, vcs, k, v, layer, pos)
                qs = [q.to(kc.device) for kc in kcs]
                atts = sp_gqa_attention(qs, kcs, vcs, pos, k.shape[2], layer=layer,
                                        impl=cfg.quant_impl)[:1]
            for c, a in zip(cells, atts):
                out[c][t] = _heads_out(a)
    return out


def _kv(cache: ShardedKV, mesh, r: int) -> KVCache:
    """Global rank ``r``'s cache: the ranks at expert shard 0 hold one each,
    in rank order (the others attend nothing)."""
    d, s, _, t = mesh.coords(r)
    return cache.ranks[(d * mesh.sp + s) * mesh.tp + t - mesh.rank0]


def _head_ranks(mesh) -> list[int]:
    """The ranks that hold the residual stream when the layers end and run
    the LM head: ``(d, 0, 0, t)`` for every data group d and tensor slice t
    (this process's)."""
    return [r for d in range(mesh.dp) for t in range(mesh.tp)
            for r in (mesh.rank(d, 0, 0, t),) if r in mesh.ranks]


def _run_blocks_tp(placed: Placed, cfg: ModelConfig, tokens: torch.Tensor,
                   cache: ShardedKV, pos: int, pos_rows=None, paged=None,
                   offsets=None) -> tuple[list, ShardedKV]:
    """:func:`run_blocks` over the mesh's ranks.  Data group d takes the
    batch rows ``d·B/dp ..``; a cell ``(d, s)`` is the ranks at expert
    shard 0 that hold one copy of a group's residual stream, one a tp
    slice: ``s = 0`` alone, or every sequence shard s with its block of
    the tokens in a ring prefill (``cfg.ring_prefill``, T > 1 on an sp
    mesh).  Attention runs on the cell's ranks (over the sp shards'
    caches with sp, :func:`_sp_attend`), the dense FFN too, a MoE FFN also
    on the cell's other expert shards.  Returns the residual stream of
    :func:`_head_ranks`, in their order, each on its device."""
    mesh = placed.mesh
    tp, sp, dp = mesh.tp, mesh.sp, mesh.dp
    b, t = tokens.shape
    bl = b // dp
    ring = sp > 1 and cfg.ring_prefill and t > 1
    tl = t // sp if ring else t
    cells = [(d, s) for d in range(dp) for s in (range(sp) if ring else (0,))]
    grp = {c: [r for r in mesh.group_ranks(("tp",), mesh.rank(*c)) if r in mesh.ranks]
           for c in cells}
    xs, rope, args = {}, {}, {}
    for (d, s), ranks in grp.items():
        rows, cols = slice(d * bl, (d + 1) * bl), slice(s * tl, (s + 1) * tl)
        xs[(d, s)], rope[(d, s)], args[(d, s)] = [], [], []
        for r in ranks:
            dev = mesh.devices[mesh.local(r)]
            x, cos, sin = _embed(_p(placed, r), cfg, tokens[rows, cols].to(dev),
                                 pos + s * tl, _on(pos_rows, dev)[rows] if pos_rows is not None
                                 else None, _on(offsets, dev)[rows] if offsets is not None
                                 else None)
            xs[(d, s)].append(x)
            rope[(d, s)].append((cos, sin))
            args[(d, s)].append((None if pos_rows is None else pos_rows.to(dev)[rows],
                                 None if paged is None else
                                 tuple(a.to(dev)[rows] for a in paged),
                                 None if offsets is None else offsets.to(dev)[rows]))
    for layer in range(cfg.n_layers):
        if sp > 1:
            atts = _sp_attend(xs, placed, layer, cfg, cache, rope, pos, ring)
        else:
            atts = {c: [_attend(x, _p(placed, r), layer, cfg, _kv(cache, mesh, r), cos, sin,
                                pos, *a, tp=tp)
                        for x, r, (cos, sin), a in zip(xs[c], grp[c], rope[c], args[c])]
                    for c in cells}
        for c in cells:
            ranks = [_p(placed, r) for r in grp[c]]
            att = _col_mm(atts[c], placed, "wo", cfg, grp[c], layer)
            if cfg.post_block_norms:
                att = [rmsnorm(a, p["rms_ffn"][layer]) for a, p in zip(att, ranks)]
            x_c = [x + a for x, a in zip(xs[c], att)]
            if cfg.is_moe:
                pre = "rms_moe" if cfg.post_block_norms else "rms_ffn"
                xbs = [rmsnorm(x, p[pre][layer]).reshape(-1, cfg.dim)
                       for x, p in zip(x_c, ranks)]
                ff = [f.reshape(x.shape) for f, x in
                      zip(_moe_ffn_tp(xbs, placed, layer, cfg, grp[c]), x_c)]
                if cfg.post_block_norms:
                    ff = [rmsnorm(f, p["rms_ffn2"][layer]) for f, p in zip(ff, ranks)]
            else:
                xbs = [rmsnorm(x, p["rms_ffn"][layer]) for x, p in zip(x_c, ranks)]
                ff = _dense_ffn_tp(xbs, placed, layer, cfg, grp[c])
            xs[c] = [x + f for x, f in zip(x_c, ff)]
    if ring:  # each group's token blocks back together on its s = 0 cell
        for d in range(dp):
            xs[(d, 0)] = [torch.cat([xs[(d, s)][i].to(x.device) for s in range(sp)], dim=1)
                          for i, x in enumerate(xs[(d, 0)])]
    return [x for d in range(dp) for x in xs[(d, 0)]], cache


def _each(params, x, fn):
    """``fn(a, rows)`` over the residual stream: one tensor (``rows`` all
    of the batch's), or one a head rank of the mesh (:func:`_head_ranks`;
    ``rows`` its data group's slice of the batch)."""
    if not isinstance(x, list):
        return fn(x, slice(None))
    per = len(x) // params.mesh.dp
    return [fn(a, slice(i // per * a.shape[0], (i // per + 1) * a.shape[0]))
            for i, a in enumerate(x)]


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


def _head_tp(placed: Placed, cfg: ModelConfig, xs: list) -> torch.Tensor | None:
    """The logits from the head ranks' streams (:func:`_head_ranks`): each
    data group's vocab-sliced logits gathered in tp order (a replicated
    wcls: its first rank's whole product), the groups' rows stacked, on
    rank 0's device.  Across processes each process computes its ranks'
    slices and process 0 gathers them; the other processes return None."""
    mesh = placed.mesh
    heads = _head_ranks(mesh)
    xs = [rmsnorm(x, _p(placed, r)["rms_final"]) for x, r in zip(xs, heads)]
    dev0 = mesh.device
    per = len(heads) // mesh.dp
    rows = []
    for d in range(mesh.dp):
        grp, xg = heads[d * per:(d + 1) * per], xs[d * per:(d + 1) * per]
        if placed.kinds["wcls"] == ROW:
            parts = [_mm(x, _p(placed, r)["wcls"], cfg, out_dtype=torch.float32)
                     for x, r in zip(xg, grp)]
            if mesh.multi:
                parts = comm.gather_to_root(mesh, parts)
                if parts is None:
                    return None
            rows.append(torch.cat([x.to(dev0) for x in parts], dim=-1))
        elif mesh.proc != 0:
            return None
        else:
            rows.append(_mm(xg[0], _p(placed, grp[0])["wcls"], cfg,
                            out_dtype=torch.float32).to(dev0))
    logits = rows[0] if len(rows) == 1 else torch.cat(rows, dim=0)
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
    return _head(params, cfg, _each(params, x, lambda a, _: a[:, last_index])), cache


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
    x_last = _each(params, x, lambda a, rows: a[torch.arange(a.shape[0], device=a.device),
                                                last.to(a.device)[rows]])  # (B, D)
    return _head(params, cfg, x_last), cache


def forward_slots_all(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                      cache: KVCache, pos_rows: torch.Tensor, n_valid: torch.Tensor,
                      page_table: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, KVCache]:
    """:func:`forward_slots` keeping every position's logits (B, T, V) f32
    instead of the per-row last-valid gather — the slot-verify forward.
    Position ``j`` of row ``r`` is the next-token distribution after
    ``tokens[r, :j+1]``, which is what accepting a K-token proposal needs
    (``decode_loop.slot_verify_chunk``).  The KV writes and masks are
    :func:`forward_slots`'s: a row's writes above ``n_valid`` land past its
    causal ceiling (or in the scratch page when paged)."""
    t = tokens.shape[1]
    paged = None
    if page_table is not None:
        pidx, oidx = paged_write_indices(page_table, pos_rows, n_valid, t,
                                         cache.k.shape[3])
        paged = (page_table, pidx, oidx)
    x, cache = run_blocks(params, cfg, tokens, cache, 0, pos_rows=pos_rows,
                          paged=paged)
    return _head(params, cfg, x), cache
