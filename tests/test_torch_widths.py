"""The pool dtypes, head widths and query-group sizes the JAX package
serves, in the port: f16 pools, head dims 16-256 and G = 16 through the
plain versions of kernels 7 and 8 (what a CPU tensor runs; chip_smoke.py
phases 6, 6b and 6c hold the kernels to them on the card), the kernels'
host-side plans at those widths, the slot scheduler end to end at Dh 96
and on an f16 pool, and what else names a pool dtype (the contiguous
cache's read, the f16 activations through the Q40/Q80 matmuls, the
metrics' page codec).  Each against the JAX package on the same numpy
inputs.

Tolerances:
* kernel 7's plain version against JAX's Pallas kernel in interpret mode:
  1e-2 of max|ref|, the JAX tests' own bar (both fold the pool's operand
  type page by page, in another summation order; the probabilities round
  to bf16 or f16 at each page's running max).
* the t > 1 read on a bf16 or int8 pool: one bf16 ulp of max|ref| (2^-8);
  on an f16 pool one f16 ulp of it (2^-10, f16 keeping 10 bits): both
  packages multiply the same operands exactly in f32 and differ only in
  the f32 summation order, which can move a probability or an output
  across one rounding edge of the operand type.
* the contiguous cache's read on an f16 cache: the same f16 ulp.
* the f16 activations through the matmuls: bit for bit on the CPU (both
  packages cast x to the weights' dequantized type, as the kernels' bf16
  operand does on the card, and sum in f32) -- checked at 1e-6 of max.
* greedy tokens: equal (the tiny f32 model's margins are decisive; the
  rule of ROADMAP.md section 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.models import config as jconfig, params as jparams
from dllama_tpu.obs import metrics as jmetrics
from dllama_tpu.ops import attention as ja
from dllama_tpu.parallel.mesh import make_mesh
from dllama_tpu.runtime.engine import Engine as JEngine
from dllama_tpu.runtime.scheduler import SlotScheduler as JScheduler
from dllama_tpu_torch.models import config as tconfig, params as tparams
from dllama_tpu_torch.obs import metrics as tmetrics
from dllama_tpu_torch.ops import attention as ta
from dllama_tpu_torch.runtime.engine import Engine
from dllama_tpu_torch.runtime.scheduler import SlotScheduler
from test_torch_prefill_attention import _kernel_walk, _pool_case
from test_torch_scheduler import _serve

F16_ULP = 2.0 ** -10
BF16_ULP = 2.0 ** -8
HEAD_DIMS = (16, 32, 80, 96, 256)
JDT = {"bf16": jnp.bfloat16, "f16": jnp.float16, "f32": jnp.float32}
TDT = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}


def _t(a) -> torch.Tensor:
    """JAX/numpy array -> torch, bf16 by bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _close(got: torch.Tensor, ref, rel: float):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                               atol=rel * max(float(np.abs(ref).max()), 1e-3))


def _pools(codec, shape, rng):
    """JAX pools of ``codec`` (bf16, f16 or int8 + scales) from a seed."""
    if codec == "int8":
        pk, sk = ja.quantize_kv(jnp.asarray(rng.randn(*shape), jnp.float32))
        pv, sv = ja.quantize_kv(jnp.asarray(rng.randn(*shape), jnp.float32))
        return pk, pv, (sk, sv)
    pk = jnp.asarray(rng.randn(*shape) * 0.3, JDT[codec])
    pv = jnp.asarray(rng.randn(*shape) * 0.3, JDT[codec])
    return pk, pv, None


# -- kernel 7 (single-token paged attention) -------------------------------

def _decode_case(codec, dh, hkv, g, seed, b=3, maxp=3, ps=8, nlayers=2):
    """tests/test_fused_decode.py's ragged rows (one full, one mid-page,
    one inside the first page) at head dim ``dh`` and G = ``g``."""
    rng = np.random.RandomState(seed)
    npages = 1 + b * maxp
    table = np.arange(1, npages).reshape(b, maxp).astype(np.int32)
    pos = np.array([maxp * ps - 1, ps + ps // 2, 3], np.int32)
    q = (rng.randn(b, hkv * g, 1, dh) * 0.3).astype(np.float32)
    pk, pv, scales = _pools(codec, (nlayers, npages, hkv, ps, dh), rng)
    return q, pk, pv, table, pos, scales


@pytest.mark.parametrize("codec", ["bf16", "f16", "int8"])
@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_kernel7_plain_matches_jax_interpret_at_every_width(codec, dh):
    """The fused decode kernel's plain version against JAX's Pallas kernel
    (interpret mode) at head dims 16 to 256, on bf16, f16 and int8 pools:
    the plain version ran, the output keeps q's dtype."""
    q, pk, pv, table, pos, scales = _decode_case(codec, dh, 2, 2, seed=dh)
    ref = ja.fused_paged_attention(jnp.asarray(q), pk, pv, jnp.int32(1), jnp.asarray(table),
                                   jnp.asarray(pos), scales=scales, interpret=True)
    ta.reset_counters()
    got = ta.fused_paged_attention(
        torch.from_numpy(q), _t(pk), _t(pv), 1, torch.from_numpy(table), torch.from_numpy(pos),
        None if scales is None else tuple(_t(s) for s in scales))
    assert ta.counters()["plain_calls"] == 1 and ta.counters()["kernel_launches"] == 0
    assert got.shape == q.shape and got.dtype == torch.float32
    _close(got, ref, 1e-2)


@pytest.mark.parametrize("codec", ["bf16", "f16"])
def test_kernel7_plain_matches_jax_interpret_at_g16(codec):
    """G = 16 query heads a kv head (past the 8 a kernel-7 block serves:
    two head groups of 8 on the card), f16 queries on an f16 pool."""
    q, pk, pv, table, pos, scales = _decode_case(codec, 32, 1, 16, seed=16)
    qd = jnp.asarray(q, JDT[codec])
    ref = ja.fused_paged_attention(qd, pk, pv, jnp.int32(0), jnp.asarray(table),
                                   jnp.asarray(pos), interpret=True)
    got = ta.fused_paged_attention(_t(qd), _t(pk), _t(pv), 0, torch.from_numpy(table),
                                   torch.from_numpy(pos))
    assert got.dtype == TDT[codec]
    _close(got, np.asarray(ref.astype(jnp.float32)), 1e-2)


def test_kernel7_plan_at_every_width_and_group():
    """Kernel 7's host plan: a position takes the power of two of lanes at
    or above Dh/8 (the lanes past Dh hold zeros); G above 8 is cut into
    even head groups of at most 8, which the split plan counts as blocks;
    every head dim that is a multiple of 16 up to 256 is taken, at G = 16
    too, within the card's shared memory for any page the split plan
    stages (positions a stage bounded by STAGE_POSITIONS); another is
    refused with the reason."""
    assert [ta.lanes(dh) for dh in (16, 32, 48, 80, 96, 128, 144, 256)] == [
        2, 4, 8, 16, 16, 16, 32, 32]
    assert [ta.head_groups(g) for g in (1, 4, 8, 9, 12, 16, 24, 64)] == [
        (1, 1), (1, 4), (1, 8), (2, 5), (2, 6), (2, 8), (3, 8), (8, 8)]
    for dh in range(16, 257, 16):
        for kv_bytes in (1, 2, 4):
            for ps in (1, 4, 8, 16, 32):
                _, gb = ta.head_groups(16)
                pp = ta.stage_pages(ps, 256)
                assert ta.smem_bytes(gb, ps, dh, kv_bytes, pp) <= ta.MAX_SMEM, (dh, kv_bytes, ps)
    # the split plan at G = 16 on Hkv = 2, B = 8 (the grid's first extent
    # 2 x 2 head groups): 64 splits of 4 pages, against 128 of 2 for one
    # block a kv head
    assert ta.split_plan(256, 8, 2 * ta.head_groups(16)[0], 132) == (64, 4)
    assert ta.split_plan(256, 8, 2, 132) == (128, 2)
    for dh in (8, 72, 264, 272):
        assert not ta.head_dim_ok(dh)
    assert all(ta.head_dim_ok(dh) for dh in range(16, 257, 16))


# -- kernel 8 (the t > 1 read) ----------------------------------------------

def _prefill_case(codec, dh, t, seed, b=4, hkv=2, g=2, ps=4, maxp=8, nlayers=2):
    """Rows at position 0, mid-page, across a page edge and at the end of
    the table; q of the pool's operand type (f32 values rounded to it)."""
    rng = np.random.RandomState(seed)
    npages = 1 + b * maxp
    table = (1 + np.arange(b * maxp, dtype=np.int32)).reshape(maxp, b).T.copy()
    pos = np.array([0, 2, 3, ps * maxp - t], np.int32)
    q = rng.randn(b, hkv * g, t, dh).astype(np.float32)
    pk, pv, scales = _pools(codec, (nlayers, npages, hkv, ps, dh), rng)
    return q, pk, pv, table, pos, scales


@pytest.mark.parametrize("codec", ["bf16", "f16", "int8"])
@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_kernel8_plain_matches_jax_at_every_width(codec, dh):
    """The t > 1 read (the prefill kernel's plain version) against JAX's
    ``paged_gqa_attention_at`` at head dims 16 to 256 on bf16, f16 and int8
    pools, T = 5, both layers: one ulp of the output's operand type."""
    q, pk, pv, table, pos, scales = _prefill_case(codec, dh, 5, seed=dh + 1)
    op = "f16" if codec == "f16" else "bf16"
    qj = jnp.asarray(q, JDT[op])
    tol = F16_ULP if op == "f16" else BF16_ULP
    for layer in (0, 1):
        ref = ja.paged_gqa_attention_at(qj, pk, pv, jnp.int32(layer), jnp.asarray(table),
                                        jnp.asarray(pos), scales=scales)
        ta.reset_counters()
        got = ta.paged_gqa_attention_at(
            _t(qj), _t(pk), _t(pv), layer, torch.from_numpy(table), torch.from_numpy(pos),
            None if scales is None else tuple(_t(s) for s in scales))
        assert ta.counters()["prefill_plain_calls"] == 1
        assert got.dtype == TDT[op]
        _close(got, np.asarray(ref.astype(jnp.float32)), tol)


def test_kernel8_plan_at_the_wide_head_dims():
    """Above a padded head dim of 128 (Dh 144 to 256) a block takes 64
    query rows (one consumer warpgroup), so a 7B-like step of 128 tokens at
    G = 1 is two row groups, and Mixtral's G = 4 at T = 16 one; up to 128
    padded (Dh 16 to 128) 128 rows, as before.  The tensor-core body works
    at Dh rounded to whole 64-column slabs."""
    assert [ta.prefill_padded_dh(dh) for dh in (16, 32, 64, 80, 96, 128, 144, 256)] == [
        64, 64, 64, 128, 128, 128, 192, 256]
    assert [ta.prefill_group_rows(dh) for dh in (16, 96, 128, 144, 192, 256)] == [
        128, 128, 128, 64, 64, 64]
    assert ta.prefill_plan(8, 32, 32, 128, 16, 256, 256, 2, 132).groups == 2
    assert ta.prefill_plan(8, 32, 32, 128, 16, 96, 256, 2, 132).groups == 1
    assert ta.prefill_plan(8, 32, 8, 16, 16, 256, 256, 2, 132).groups == 1
    assert ta.prefill_plan(8, 32, 8, 32, 16, 256, 256, 2, 132).groups == 2


@pytest.mark.parametrize("codec,dh,g,t", [("f16", 96, 2, 16), ("bf16", 256, 1, 130),
                                          ("int8", 80, 4, 40), ("f16", 16, 1, 8),
                                          ("f32", 256, 2, 40)],
                         ids=["f16-dh96", "bf16-dh256-3groups", "int8-dh80-2groups",
                              "f16-dh16", "f32-dh256-2groups"])
def test_kernel_walk_at_other_widths_matches_the_plain_version(codec, dh, g, t):
    """The prefill kernel's walk, transcribed (tests/test_torch_prefill_
    attention.py), against the plain version at the new widths and the f16
    operand: the row groups of 64 rows above a padded Dh of 128, each query
    row within 1e-2 of its own max|plain| (1e-5 on an f32 pool)."""
    q, pk, pv, table, pos, scales = _pool_case(codec, 3, 2, g, t, 16, 16, seed=dh + t, dh=dh)
    for layer in (0, 1):
        got, plan, counts = _kernel_walk(q, pk, pv, layer, table, pos, scales, 132)
        ref = ta.paged_rows_attention(q, pk, pv, layer, table, pos, scales)
        diff = (got.float() - ref.float()).abs().amax(-1)
        mag = ref.float().abs().amax(-1)
        assert bool((diff <= (1e-5 if codec == "f32" else 1e-2) * mag).all())
    assert plan.groups == -(-g * t // ta.prefill_group_rows(dh))


# -- the contiguous cache's read and the f16 activations --------------------

def test_contiguous_f16_cache_read_matches_jax():
    """``gqa_attention_at`` over an f16 contiguous cache (the einsum read;
    the decode walk at a 4096-position cache) equals JAX's within an f16
    ulp of max, t = 4 and t = 1."""
    rng = np.random.RandomState(5)
    b, hq, hkv, dh, L = 2, 4, 2, 32, 2
    for s, t, pos in ((24, 4, 7), (4096, 1, 3000)):
        q = jnp.asarray(rng.randn(b, hq, t, dh), jnp.float16)
        ck = jnp.asarray(rng.randn(L, b, hkv, s, dh) * 0.5, jnp.float16)
        cv = jnp.asarray(rng.randn(L, b, hkv, s, dh) * 0.5, jnp.float16)
        ref = ja.gqa_attention_at(q, ck, cv, jnp.int32(1), pos, t)
        got = ta.gqa_attention_at(_t(q), _t(ck), _t(cv), 1, pos, t)
        assert got.dtype == torch.float16
        _close(got, np.asarray(ref.astype(jnp.float32)), F16_ULP)


@pytest.mark.parametrize("codec", ["q40", "q80"])
def test_f16_activations_through_the_quantized_matmuls_match_jax(codec):
    """f16 activations (``--buffer-float-type f16``) through the Q40 and
    Q80 matmuls' plain versions (what a CPU tensor runs) equal JAX's
    ``q40.mm``/``q8``'s on the same packed weights, output f16: the
    kernels cast x to their bf16 operand on the card, as JAX's Pallas
    kernels do; on the CPU both dequantize the weights and multiply."""
    from dllama_tpu.ops import q40 as jq40, q8 as jq8
    from dllama_tpu_torch.ops import q40 as tq40, q8 as tq8
    rng = np.random.RandomState(7)
    n, d, t = 128, 96, 3
    w = (rng.randn(n, d) * 0.1).astype(np.float32)
    x = rng.randn(t, n).astype(np.float32)
    jmod, tmod = (jq40, tq40) if codec == "q40" else (jq8, tq8)
    qt = jmod.quantize(w)
    arrays = {"w": (np.asarray(qt.qpacked), np.asarray(qt.scales).view(np.uint16),
                    qt.logical_nd)}
    tw = tparams.from_jax_params(arrays, None)["w"]
    xj = jnp.asarray(x, jnp.float16)
    ref = jq40.mm(xj, qt)
    got = tq40.mm(_t(xj), tw, out_dtype=torch.float16)
    assert ref.dtype == jnp.float16 and got.dtype == torch.float16
    _close(got, np.asarray(ref.astype(jnp.float32)), 1e-6)
    assert tmod.counters()["plain_calls"] >= 1


def test_f16_page_codec_and_pool_match_jax():
    """A paged engine on an f16 pool names its page codec ``float16`` in
    the metrics' gauge, as the JAX engine does, and the pools are f16."""
    jcfg = jconfig.tiny_config(seq_len=32)
    jp = jparams.init_params(jcfg, seed=4)
    tcfg = tconfig.tiny_config(seq_len=32)
    tp = tparams.from_jax_params({k: np.asarray(v) for k, v in jp.items()}, tcfg)
    eng = Engine(tcfg, tp, device="cpu", batch=2, kv_pages=9, kv_page_size=8,
                 kv_dtype=torch.float16)
    assert eng.cache.k.dtype == torch.float16
    assert tmetrics.KV_PAGE_CODEC.get("float16") == 1
    jeng = JEngine(jcfg, jp, mesh=make_mesh(tp=1, devices=jax.devices()[:1]), batch=2,
                   kv_pages=9, kv_page_size=8, kv_dtype=jnp.float16)
    assert jeng.cache.k.dtype == jnp.float16
    assert jmetrics.KV_PAGE_CODEC.get("float16") == 1


# -- the slot scheduler end to end -------------------------------------------

SEQ, PAGE, NEW = 96, 8, 10
PROMPTS = tuple(tuple(int(x) for x in np.random.RandomState(50 + n).randint(1, 128, n))
                for n in (40, 17, 5, 3))


@pytest.mark.parametrize("case", ["dh96", "f16-pool"])
def test_slot_scheduler_at_dh96_and_on_an_f16_pool_matches_jax(case):
    """The slot scheduler on a tiny model with Dh = 96 (dim 192, 2 heads
    on 1 kv head) and on the tiny model's f16 pool: greedy tokens equal the
    JAX ``SlotScheduler``'s (overlap off) on the same weights, pool and
    chunk, with mixed steps and single-token steps both run."""
    dims = dict(dim=192, n_heads=2, n_kv_heads=1) if case == "dh96" else {}
    jcfg = jconfig.tiny_config(seq_len=SEQ, **dims)
    jp = jparams.init_params(jcfg, seed=6)
    tcfg = tconfig.tiny_config(seq_len=SEQ, **dims)
    tp = tparams.from_jax_params({k: np.asarray(v) for k, v in jp.items()}, tcfg)
    assert tcfg.head_size == (96 if case == "dh96" else 16)
    kv_t, kv_j = (torch.float16, jnp.float16) if case == "f16-pool" else (None, None)
    pages = 4 * (SEQ // PAGE) + 1
    eng = Engine(tcfg, tp, device="cpu", batch=4, kv_pages=pages, kv_page_size=PAGE,
                 kv_dtype=kv_t)
    assert eng.cache.k.dtype == (torch.float16 if kv_t else torch.float32)
    ta.reset_counters()
    sched = SlotScheduler(eng, prefill_chunk=8)
    try:
        got = _serve(sched, PROMPTS, NEW)
    finally:
        sched.close()
    assert ta.counters()["prefill_plain_calls"] > 0
    jeng = JEngine(jcfg, jp, mesh=make_mesh(tp=1, devices=jax.devices()[:1]), batch=4,
                   kv_pages=pages, kv_page_size=PAGE, kv_dtype=kv_j)
    jsched = JScheduler(jeng, prefill_chunk=8, overlap=False)
    try:
        ref = _serve(jsched, PROMPTS, NEW)
    finally:
        jsched.close()
    for p in PROMPTS:
        assert len(got[p][0]) == NEW
        assert got[p][0] == ref[p][0], f"prompt of {len(p)} tokens: port vs JAX"
