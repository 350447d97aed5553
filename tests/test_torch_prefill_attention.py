"""Attention over the paged KV pool for t > 1 query rows (the mixed slot
step's read): the port's ``paged_gqa_attention_at`` against the JAX
package's on the same numpy inputs, and the host-side plan of the prefill
kernel (csrc/paged_prefill_attention.cu), whose launch runs only on the
card (chip_smoke.py phase 6c holds it to this plain version there).

On the CPU both packages take the same route for t > 1: the gather of the
layer's logical view through the page table, then the one-shot
per-row-ceiling attention (JAX ``_rows_ceiling_attention``).  The step's
K/V is written first, as the slot step writes it: tokens past a row's
n_valid go to scratch page 0, and one row's table runs into page 0.

Tolerance: the bf16 output of the two packages is equal to within one bf16
ulp of the output's largest value (2^-8 of max|ref|): both multiply the same
bf16 operands exactly in f32, and only the f32 summation order of the two
dots differs, which can move a probability or an output across a bf16
rounding edge.  On an f32 pool both keep f32 operands end to end, so only
the sum order differs: 1e-5 of max|ref|.

The kernel's walk (csrc/paged_prefill_attention.cu: row groups, splits of
whole 64-key tiles, page segments, masks, the online softmax and the
fixed-order combine) is transcribed in PyTorch below from its plan
(``prefill_plan`` and the source's page segments) and held to the plain
version at page sizes 4, 16, 24 and 100, so the index arithmetic the card
runs is checked here too.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.models import config as jconfig, params as jparams
from dllama_tpu.ops import attention as ja
from dllama_tpu.parallel.mesh import make_mesh
from dllama_tpu.runtime.engine import Engine as JEngine
from dllama_tpu.runtime.scheduler import SlotScheduler as JScheduler
from dllama_tpu_torch.models import config as tconfig, params as tparams
from dllama_tpu_torch.ops import attention as ta
from dllama_tpu_torch.runtime.engine import Engine
from dllama_tpu_torch.runtime.scheduler import SlotScheduler
from fixtures import REPO
from test_torch_scheduler import _serve

PS, MAXP, L = 4, 8, 2
S = PS * MAXP
ULP = 2.0 ** -8


def _bf16(a: np.ndarray) -> np.ndarray:
    """Round f32 to bf16 values (kept in f32): both packages get the same
    bf16 numbers."""
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).float().numpy()


def _case(t: int, hkv: int, g: int, quant, seed: int, maxp: int = MAXP):
    """B = 5 rows: at position 0, mid-page (2), across a page edge (3),
    one whose table runs into page 0 after 2 pages (13: its keys from 8 on
    read the scratch page), and one at the end of the table (S - t); rows
    1 and 3 have n_valid < t.  Pools of random bf16 (``quant`` False),
    int8 + scales (True) or f32 (``"f32"``) values, q and the step's K/V
    bf16 values (f32 ones with an f32 pool); each row owns interleaved
    pages; ``maxp`` pages a row (S = PS · MAXP by default)."""
    rng = np.random.RandomState(seed)
    b, dh = 5, 16
    hq = hkv * g
    n_pages = 1 + b * maxp
    table = (1 + np.arange(b * maxp, dtype=np.int32)).reshape(maxp, b).T.copy()
    table[3, 2:] = 0
    pos = np.array([0, 2, 3, 13, PS * maxp - t], np.int32)
    n_valid = np.array([t, max(1, t // 2), t, 1, t], np.int32)
    val = (lambda a: a.astype(np.float32)) if quant == "f32" else _bf16
    q = val(rng.randn(b, hq, t, dh))
    kn = val(rng.randn(b, hkv, t, dh))
    vn = val(rng.randn(b, hkv, t, dh))
    shape = (L, n_pages, hkv, PS, dh)
    if quant is True:
        pk = rng.randint(-127, 128, shape).astype(np.int8)
        pv = rng.randint(-127, 128, shape).astype(np.int8)
        sk = (rng.rand(*shape[:-1], 1) * 0.02).astype(np.float32)
        sv = (rng.rand(*shape[:-1], 1) * 0.02).astype(np.float32)
        pools = (pk, pv, sk, sv)
    else:
        pools = (val(rng.randn(*shape)), val(rng.randn(*shape)))
    return q, kn, vn, pools, table, pos, n_valid


def _jax_read(q, kn, vn, pools, table, pos, n_valid, layer):
    t = q.shape[2]
    pidx, oidx = ja.paged_write_indices(jnp.asarray(table), jnp.asarray(pos),
                                        jnp.asarray(n_valid), t, PS)
    li = jnp.int32(layer)
    dt = jnp.float32 if _is_f32(pools) else jnp.bfloat16
    if len(pools) == 4:
        pk, pv, sk, sv = (jnp.asarray(a) for a in pools)
        qk, s_k = ja.quantize_kv(jnp.asarray(kn, dt))
        qv, s_v = ja.quantize_kv(jnp.asarray(vn, dt))
        pk, pv = ja.paged_update_kv_rows(pk, pv, qk, qv, li, pidx, oidx)
        sk, sv = ja.paged_update_kv_rows(sk, sv, s_k, s_v, li, pidx, oidx)
        scales = (sk, sv)
    else:
        pk, pv = (jnp.asarray(a, dt) for a in pools)
        pk, pv = ja.paged_update_kv_rows(pk, pv, jnp.asarray(kn, dt), jnp.asarray(vn, dt),
                                         li, pidx, oidx)
        scales = None
    out = ja.paged_gqa_attention_at(jnp.asarray(q, dt), pk, pv, li, jnp.asarray(table),
                                    jnp.asarray(pos), scales=scales)
    return np.asarray(out.astype(jnp.float32))


def _port_read(q, kn, vn, pools, table, pos, n_valid, layer, impl="auto"):
    t = q.shape[2]
    tab, p = torch.from_numpy(table), torch.from_numpy(pos)
    pidx, oidx = ta.paged_write_indices(tab, p, torch.from_numpy(n_valid), t, PS)
    dt = torch.float32 if _is_f32(pools) else torch.bfloat16
    kb, vb = torch.from_numpy(kn).to(dt), torch.from_numpy(vn).to(dt)
    if len(pools) == 4:
        pk, pv, sk, sv = (torch.from_numpy(a.copy()) for a in pools)
        (qk, s_k), (qv, s_v) = ta.quantize_kv(kb), ta.quantize_kv(vb)
        ta.paged_update_kv_rows(pk, pv, qk, qv, layer, pidx, oidx)
        ta.paged_update_kv_rows(sk, sv, s_k, s_v, layer, pidx, oidx)
        scales = (sk, sv)
    else:
        pk, pv = (torch.from_numpy(a).to(dt) for a in pools)
        ta.paged_update_kv_rows(pk, pv, kb, vb, layer, pidx, oidx)
        scales = None
    out = ta.paged_gqa_attention_at(torch.from_numpy(q).to(dt), pk, pv, layer, tab, p,
                                    scales, impl=impl)
    return out


def _is_f32(pools) -> bool:
    """An f32 pool (values that are not all bf16 numbers)."""
    return len(pools) == 2 and not np.array_equal(pools[0], _bf16(pools[0]))


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("g", [1, 4], ids=["G1", "G4"])
@pytest.mark.parametrize("t", [2, 4, 8, 16])
def test_prefill_read_matches_jax(t, g, quant):
    """The port's t > 1 read (the prefill kernel's plain version on a CPU
    tensor) equals JAX's within one bf16 ulp of max, at both layers, with
    the step's K/V written first; the plain version is what ran."""
    case = _case(t, 2, g, quant, seed=100 * t + 10 * g + quant)
    for layer in (0, L - 1):
        ta.reset_counters()
        got = _port_read(*case, layer)
        assert ta.counters()["prefill_plain_calls"] == 1
        assert ta.counters()["prefill_launches"] == 0
        ref = _jax_read(*case, layer)
        assert got.shape == case[0].shape and got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                                   atol=ULP * np.abs(ref).max())


@pytest.mark.parametrize("g", [1, 4], ids=["G1", "G4"])
@pytest.mark.parametrize("t", [2, 16])
def test_prefill_read_on_an_f32_pool_matches_jax(t, g):
    """An f32 pool (``--kv-cache-dtype f32``): the port's read keeps f32
    operands as JAX's does (q cast to the pool's type), so the two agree
    within 1e-5 of max|ref| (only the sum order differs), in f32."""
    case = _case(t, 2, g, "f32", seed=700 + 10 * t + g)
    for layer in (0, L - 1):
        ta.reset_counters()
        got = _port_read(*case, layer)
        assert ta.counters()["prefill_plain_calls"] == 1
        ref = _jax_read(*case, layer)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("codec", [False, True, "f32"], ids=["bf16", "int8", "f32"])
def test_a_step_past_the_old_row_cap_matches_jax(codec):
    """160 query rows a kv head (Hkv = 2, G = 4, T = 40: past the 128 the
    kernel took before): the port's read equals JAX's on the same pools
    (bf16 and int8 within one bf16 ulp of max, f32 within 1e-5), and the
    plan takes the step in two row groups.  The port writes the step's K/V
    and JAX reads those pools: at this width many padded tokens land on
    scratch page 0 at once, and which write wins there is unordered."""
    t = 40
    q, kn, vn, pools, table, pos, n_valid = _case(t, 2, 4, codec, seed=41, maxp=16)
    tol = 1e-5 if codec == "f32" else ULP
    tab, p = torch.from_numpy(table), torch.from_numpy(pos)
    pidx, oidx = ta.paged_write_indices(tab, p, torch.from_numpy(n_valid), t, PS)
    dt, jdt = (torch.float32, jnp.float32) if codec == "f32" else (torch.bfloat16, jnp.bfloat16)
    kb, vb = torch.from_numpy(kn).to(dt), torch.from_numpy(vn).to(dt)
    for layer in (0, L - 1):
        if codec is True:
            pk, pv, sk, sv = (torch.from_numpy(a.copy()) for a in pools)
            (qk, s_k), (qv, s_v) = ta.quantize_kv(kb), ta.quantize_kv(vb)
            ta.paged_update_kv_rows(pk, pv, qk, qv, layer, pidx, oidx)
            ta.paged_update_kv_rows(sk, sv, s_k, s_v, layer, pidx, oidx)
            scales = (sk, sv)
            jpools = (jnp.asarray(pk.numpy()), jnp.asarray(pv.numpy()))
            jscales = (jnp.asarray(sk.numpy()), jnp.asarray(sv.numpy()))
        else:
            pk, pv = (torch.from_numpy(a).to(dt) for a in pools)
            ta.paged_update_kv_rows(pk, pv, kb, vb, layer, pidx, oidx)
            scales = jscales = None
            jpools = tuple(jnp.asarray(x.float().numpy(), jdt) for x in (pk, pv))
        got = ta.paged_gqa_attention_at(torch.from_numpy(q).to(dt), pk, pv, layer, tab, p,
                                        scales)
        ref = np.asarray(ja.paged_gqa_attention_at(
            jnp.asarray(q, jdt), *jpools, jnp.int32(layer), jnp.asarray(table),
            jnp.asarray(pos), scales=jscales).astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=tol * np.abs(ref).max())
    kv_bytes = {False: 2, True: 1, "f32": 4}[codec]
    plan = ta.prefill_plan(5, 8, 2, t, PS, 64, 16, kv_bytes, 132)
    assert plan.groups == 2


SCHED_SEQ, SCHED_PAGE, SCHED_NEW = 192, 8, 12
# one prompt long enough for a 128-token mixed step (256 query rows a kv
# head on the tiny model's G = 2), one for a 64-token step, two short ones
SCHED_PROMPTS = tuple(tuple(int(x) for x in np.random.RandomState(90 + n).randint(1, 128, n))
                      for n in (150, 70, 5, 3))


@pytest.fixture(scope="module")
def sched_weights():
    jcfg = jconfig.tiny_config(seq_len=SCHED_SEQ)
    jp = jparams.init_params(jcfg, seed=4)
    tcfg = tconfig.tiny_config(seq_len=SCHED_SEQ)
    return jcfg, jp, tcfg, tparams.from_jax_params({k: np.asarray(v) for k, v in jp.items()},
                                                   tcfg)


@pytest.mark.parametrize("chunk", [8, 128])
def test_slot_scheduler_on_an_f32_pool_matches_jax(sched_weights, chunk):
    """The slot scheduler on the tiny model's f32 paged pool (what
    ``--kv-cache-dtype f32`` gives a bf16 model) takes prefill chunks of 8
    and of 128 tokens: at 128 its mixed steps reach 128 tokens a row, 256
    query rows a kv head (G = 2), past the 128 the prefill kernel once
    refused.  Its greedy tokens equal the JAX ``SlotScheduler``'s (overlap
    off) on the same weights, pool and chunk."""
    jcfg, jp, tcfg, tp = sched_weights
    pages = 4 * (SCHED_SEQ // SCHED_PAGE) + 1
    eng = Engine(tcfg, tp, device="cpu", batch=4, kv_pages=pages, kv_page_size=SCHED_PAGE)
    assert eng.paged and eng.cache.k.dtype == torch.float32
    widths = []
    real = eng.slot_step_async

    def spy(*a, **kw):
        widths.append(np.asarray(a[0] if a else kw["tokens_np"]).shape[1])
        return real(*a, **kw)

    eng.slot_step_async = spy
    sched = SlotScheduler(eng, prefill_chunk=chunk)
    try:
        got = _serve(sched, SCHED_PROMPTS, SCHED_NEW)
    finally:
        sched.close()
    assert max(widths) == min(chunk, 128)
    jeng = JEngine(jcfg, jp, mesh=make_mesh(tp=1, devices=jax.devices()[:1]), batch=4,
                   kv_pages=pages, kv_page_size=SCHED_PAGE)
    assert jeng.cache.k.dtype == jnp.float32
    jsched = JScheduler(jeng, prefill_chunk=chunk, overlap=False)
    try:
        ref = _serve(jsched, SCHED_PROMPTS, SCHED_NEW)
    finally:
        jsched.close()
    for p in SCHED_PROMPTS:
        assert len(got[p][0]) == SCHED_NEW
        assert got[p][0] == ref[p][0], f"prompt of {len(p)} tokens: port vs JAX"


def test_padded_tokens_and_short_tables_go_to_page_0():
    """The write indices of the case above: row 3's valid token lands on
    its own page 3 (position 13), its padded ones and rows 1's past
    n_valid on scratch page 0; row 4's last token stays in its table."""
    t = 4
    _, _, _, _, table, pos, n_valid = _case(t, 2, 1, False, seed=0)
    pidx, oidx = ta.paged_write_indices(torch.from_numpy(table), torch.from_numpy(pos),
                                        torch.from_numpy(n_valid), t, PS)
    assert pidx[3].tolist() == [0, 0, 0, 0] and table[3, 3] == 0  # the table ran out
    assert pidx[1].tolist() == [table[1, 0], table[1, 0], 0, 0]
    assert pidx[4].tolist() == [table[4, MAXP - 1]] * 4
    assert oidx[2].tolist() == [3, 0, 1, 2]  # across a page edge


def test_plain_impl_and_cpu_route():
    """``impl="plain"`` and a CPU tensor both run the plain version; an
    unknown impl raises, and the kernel's launcher refuses a CPU tensor."""
    q, kn, vn, pools, table, pos, n_valid = _case(4, 2, 1, False, seed=1)
    ta.reset_counters()
    a = _port_read(q, kn, vn, pools, table, pos, n_valid, 0)
    b = _port_read(q, kn, vn, pools, table, pos, n_valid, 0, impl="plain")
    assert torch.equal(a, b) and ta.counters()["prefill_plain_calls"] == 2
    bf = torch.bfloat16
    pk, pv = (torch.from_numpy(x).to(bf) for x in pools)
    args = (torch.from_numpy(q).to(bf), pk, pv, 0, torch.from_numpy(table),
            torch.from_numpy(pos))
    with pytest.raises(ValueError, match="unknown paged attention impl"):
        ta.paged_prefill_attention(*args, impl="kernel")
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        ta.prefill_attention(*args)
    assert ta.counters()["prefill_launches"] == 0


def test_single_token_cpu_route_is_unchanged():
    """t = 1 on the CPU keeps the JAX package's CPU route (the gather at a
    short table) and counts no prefill call."""
    q, kn, vn, pools, table, pos, n_valid = _case(1, 2, 2, False, seed=2)
    ta.reset_counters()
    got = _port_read(q, kn, vn, pools, table, pos, n_valid, 1)
    ref = _jax_read(q, kn, vn, pools, table, pos, n_valid, 1)
    assert ta.counters()["prefill_plain_calls"] == 0
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=ULP * np.abs(ref).max())


# -- the kernel's host-side plan ----------------------------------------------

def test_prefill_warps_and_widest_step():
    """A block takes up to 128 of a kv head's G·T query rows; a wider step
    takes more row groups, so no width is refused: Llama-2-7B's 256-token
    chunk is two groups, Mixtral's 64 (256 rows) two, Grok-1's (G = 6) 16
    one.  A 64-key tile holds 8, 4 or 2 whole pages of up to 8, 16 or 32
    positions, or a slice of one page."""
    groups = [ta.prefill_plan(1, r, 1, 1, 16, 128, 8, 2, 132).groups
              for r in (2, 16, 64, 65, 128, 129, 160, 256, 1024)]
    assert groups == [1, 1, 1, 1, 1, 2, 2, 2, 8]
    assert ta.prefill_plan(8, 32, 32, 256, 16, 128, 256, 2, 132).groups == 2
    assert ta.prefill_plan(8, 32, 8, 64, 16, 128, 256, 2, 132).groups == 2
    assert ta.prefill_plan(8, 48, 8, 16, 16, 128, 256, 2, 132).groups == 1
    assert [ta.prefill_pages_a_tile(ps) for ps in (1, 4, 8, 16, 24, 64, 100, 1024)] == [
        8, 8, 8, 4, 2, 1, 1, 1]


def _share(plan) -> float:
    return plan.partial_bytes / plan.kv_bytes


def test_prefill_plan_at_the_serving_shapes():
    """The launch of the 7B and Mixtral mixed steps (B = 8, 256 pages of 16,
    132 SMs) at T = 16, 128 and 256: the split count from the table length
    and G·T keeps the f32 partials (written and read back) under a tenth of
    the K/V bytes at full length; from 128 rows one split, which writes the
    output itself (no partials)."""
    sms = 132
    # 7B (G = 1), bf16: 16 rows, 3 splits of 88 pages (22 tiles), 2.4 %
    p = ta.prefill_plan(8, 32, 32, 16, 16, 128, 256, 2, sms)
    assert p == ta.PrefillPlan(3, 88, 1, 12779520, 536870912)
    assert _share(p) < 0.025
    # int8: the same plan on half the bytes (4.6 %)
    p = ta.prefill_plan(8, 32, 32, 16, 16, 128, 256, 1, sms)
    assert (p.splits, p.pps) == (3, 88) and _share(p) < 0.05
    # Mixtral (G = 4): 64 rows on 64 blocks a split; 3 splits fill the SMs
    # at 9.5 %
    p = ta.prefill_plan(8, 32, 8, 16, 16, 128, 256, 2, sms)
    assert (p.splits, p.pps, p.groups) == (3, 88, 1) and _share(p) < 0.1
    for hkv in (32, 8):
        for t in (128, 256):
            p = ta.prefill_plan(8, 32, hkv, t, 16, 128, 256, 2, sms)
            rows = 32 // hkv * t
            assert (p.splits, p.pps, p.partial_bytes) == (1, 256, 0)
            assert p.groups == -(-rows // 128)
    # a split walks whole tiles: 4 pages of 16, 8 of 4, 1 of 100
    for ps, ppt in ((16, 4), (4, 8), (100, 1)):
        assert ta.prefill_plan(1, 32, 32, 16, ps, 128, 512, 2, sms).pps % ppt == 0


def test_prefill_plan_refuses_what_the_kernel_cannot_take():
    """Only a head dim that is not a multiple of 16 up to 256 is refused
    (96 is taken since the kernel pads to whole 64-column slabs): a step
    past 128 rows a kv head (Mixtral at T = 64) and a page of 1024
    positions (16 segments of 64 rows) are taken: its 8 blocks take a
    split a page."""
    p = ta.prefill_plan(8, 32, 8, 64, 16, 128, 256, 2, 132)
    assert (p.groups, p.splits) == (2, 1)
    assert ta.prefill_plan(8, 32, 32, 16, 16, 96, 256, 2, 132).groups == 1
    for dh in (72, 8, 272):
        with pytest.raises(ValueError, match=f"head dim {dh}: the kernels take multiples of 16"):
            ta.prefill_plan(8, 32, 32, 16, 16, dh, 256, 2, 132)
    p = ta.prefill_plan(2, 8, 8, 16, 1024, 128, 4, 2, 132)
    assert (p.splits, p.pps, p.groups) == (4, 1, 1)


def test_pool_checks_both_kernels_share():
    """The operand checks kernel 7 and the prefill kernel make before a
    launch (their CUDA-only parts aside): a well-formed call gives the
    layer back; an f32 pool, a scale plane of the wrong shape, an int64
    table or a layer outside the pool raise, naming the kernel."""
    q, kn, vn, pools, table, pos, n_valid = _case(4, 2, 2, True, seed=3)
    bf = torch.bfloat16
    qt = torch.from_numpy(q).to(bf)
    pk, pv, sk, sv = (torch.from_numpy(a) for a in pools)
    tab, p = torch.from_numpy(table), torch.from_numpy(pos)
    kv = {torch.bfloat16: 1, torch.int8: 2}
    assert ta._check_pools(qt, pk, pv, 1, tab, p, (sk, sv), kv, "k") == 1
    with pytest.raises(ValueError, match="k: pool dtypes torch.float32/torch.float32 not one "
                                         "of bfloat16/int8"):
        ta._check_pools(qt, pk.float(), pv.float(), 1, tab, p, None, kv, "k")
    with pytest.raises(ValueError, match="scale plane"):
        ta._check_pools(qt, pk, pv, 1, tab, p, (sk[..., 0], sv), kv, "k")
    with pytest.raises(ValueError, match="page table torch.int64"):
        ta._check_pools(qt, pk, pv, 1, tab.long(), p, (sk, sv), kv, "k")
    with pytest.raises(ValueError, match="layer 2 outside 0..1"):
        ta._check_pools(qt, pk, pv, 2, tab, p, (sk, sv), kv, "k")
    # the prefill kernel takes f32 and (since the f16 body) f16 pools, not
    # an f64 one
    ta._check_pools(qt.float(), pk.float(), pv.float(), 1, tab, p, None, ta._PREFILL_KV, "k")
    ta._check_pools(qt.half(), pk.half(), pv.half(), 1, tab, p, None, ta._PREFILL_KV, "k")
    with pytest.raises(ValueError, match="k: pool dtypes torch.float64/torch.float64"):
        ta._check_pools(qt, pk.double(), pv.double(), 1, tab, p, None, ta._PREFILL_KV, "k")


def test_prefill_config_refused_before_any_request():
    """What a paged engine refuses at start-up on the card
    (``Engine.check_prefill_read``), so no request meets it in a mixed
    step: a pool the kernels do not read (f64) and a head dim that is not
    a multiple of 16 up to 256, with the reason.  f32, bf16, f16 and int8
    pools pass at every multiple of 16 up to 256, whatever the step width."""
    for dt in (torch.float32, torch.bfloat16, torch.int8, torch.float16):
        for dh in range(16, 257, 16):
            ta.check_prefill_config(dt, dh)
    with pytest.raises(ValueError, match="torch.float64 pool on the card"):
        ta.check_prefill_config(torch.float64, 128)
    for dh in (96 + 8, 272, 4):
        with pytest.raises(ValueError, match=f"head dim {dh}: .*TMA copies rows whose "
                                             "strides are multiples of 16 bytes"):
            ta.check_prefill_config(torch.bfloat16, dh)


# -- the kernel's walk, transcribed -------------------------------------------

def _segments(ps: int) -> tuple[int, int, int]:
    """The source's ``Seg``: rows a segment (one TMA box: the power of two
    from 8 to 64 that covers a page), segments a page, segments a tile."""
    br = 8
    while br < ps and br < ta.PREFILL_KEYS:
        br *= 2
    return br, -(-ps // br), ta.PREFILL_KEYS // br


def _kernel_walk(q, pk, pv, layer, table, pos, scales, n_sms):
    """The prefill kernel's arithmetic in PyTorch, as the source walks it:
    for each (row, kv head, row group, split) of ``prefill_plan`` the
    split's pages in 64-key tiles of TMA segments (a segment reads past its
    page into the pool's next rows, zeros past the pool's end; keys outside
    the page or the split masked), the online softmax with probabilities
    into PV as the operand type (bf16 operands: two terms, the rounded
    probability and its rounded remainder); a group with one live split writes
    its output, the others records that pass 2 combines.  Returns the
    output, the plan and the groups' live split counts."""
    b, hq, t, dh = q.shape
    n_layers, n_pages, hkv, ps, _ = pk.shape
    maxp = table.shape[1]
    plan = ta.prefill_plan(b, hq, hkv, t, ps, dh, maxp, pk.element_size(), n_sms)
    br, spp, spt = _segments(ps)
    g, rows = hq // hkv, hq // hkv * t
    op = ta._prefill_operand(pk.dtype)
    gr = ta.prefill_group_rows(dh)
    flat = [x.reshape(-1, dh) for x in (pk, pv)]
    n_rows = flat[0].shape[0]
    sq = float(np.sqrt(np.float32(dh)))
    r = torch.arange(ta.PREFILL_KEYS)

    def tile_rows(x, sc, row):
        inside = (row < n_rows)[:, None]
        rowc = row.clamp(max=n_rows - 1)
        v = x[rowc].float()
        if sc is not None:
            v = (v * sc.reshape(-1)[rowc][:, None]).to(torch.bfloat16).float()
        return torch.where(inside, v, 0.0)

    out = torch.empty(b, hkv, rows, dh, dtype=q.dtype)
    counts = []
    for bi in range(b):
        p0 = min(max(int(pos[bi]), 0), maxp * ps - 1)
        for grp in range(plan.groups):
            r0, r_end = grp * gr, min(rows, grp * gr + gr)
            last = t - 1 if (r_end - 1) // t != r0 // t else (r_end - 1) % t
            n_live = min(p0 + last, maxp * ps - 1) // ps + 1
            n_split = min(-(-n_live // plan.pps), plan.splits)
            counts.append(n_split)
            ceil_ = p0 + torch.arange(r0, r_end) % t
            for h in range(hkv):
                qr = q[bi, h * g:(h + 1) * g].reshape(rows, dh)[r0:r_end].to(op).float()
                recs = []
                for split in range(n_split):
                    s0 = split * plan.pps * spp
                    s1 = min(n_live, (split + 1) * plan.pps) * spp
                    m = torch.full((r_end - r0,), -1e30)
                    l = torch.zeros(r_end - r0)
                    acc = torch.zeros(r_end - r0, dh)
                    for tile in range(-(-(s1 - s0) // spt)):
                        at = s0 + tile * spt + r // br
                        off = (at % spp) * br + r % br
                        pid = table[bi, (at // spp).clamp(max=maxp - 1)].long().clamp(
                            0, n_pages - 1)
                        row = ((layer * n_pages + pid) * hkv + h) * ps + (at % spp) * br + r % br
                        kt = tile_rows(flat[0], None if scales is None else scales[0], row)
                        vt = tile_rows(flat[1], None if scales is None else scales[1], row)
                        kp = torch.where((off < ps) & (at < s1), (at // spp) * ps + off, 1 << 40)
                        s = (qr @ kt.T) / sq
                        s = torch.where(kp[None, :] <= ceil_[:, None], s, -1e30)
                        mn = torch.maximum(m, s.amax(1))
                        al = torch.exp(m - mn)
                        pr = torch.exp(s - mn[:, None])
                        l = l * al + pr.sum(1)
                        hi = pr.to(op).float()
                        pv_ = hi @ vt
                        if op == torch.bfloat16:
                            pv_ = pv_ + (pr - hi).to(op).float() @ vt
                        acc = acc * al[:, None] + pv_
                        m = mn
                    recs.append((acc, m, l))
                mx = torch.stack([x[1] for x in recs]).amax(0)
                lsum = sum(torch.exp(x[1] - mx) * x[2] for x in recs)
                asum = sum(torch.exp(x[1] - mx)[:, None] * x[0] for x in recs)
                out[bi, h, r0:r_end] = (asum / lsum.clamp(min=1e-38)[:, None]).to(q.dtype)
    return out.reshape(b, hq, t, dh), plan, counts


def _pool_case(codec, b, hkv, g, t, ps, maxp, seed, dh=64):
    """Random pools, q, positions (0, mid-table, the last step) and a table
    that runs into scratch page 0 for row 1, at head dim ``dh``."""
    rng = np.random.RandomState(seed)
    n_pages = 1 + b * maxp
    shape = (L, n_pages, hkv, ps, dh)
    table = torch.from_numpy((1 + rng.permutation(b * maxp)).reshape(b, maxp).astype(np.int32))
    table[1, maxp // 2:] = 0
    pos = torch.tensor([0, ps * maxp // 2 - 3, ps * maxp - t][:b], dtype=torch.int32)
    dt = {"f32": torch.float32, "f16": torch.float16}.get(codec, torch.bfloat16)
    q = torch.from_numpy(rng.randn(b, hkv * g, t, dh).astype(np.float32)).to(dt)
    if codec == "int8":
        pk, sk = ta.quantize_kv(torch.from_numpy(rng.randn(*shape).astype(np.float32)))
        pv, sv = ta.quantize_kv(torch.from_numpy(rng.randn(*shape).astype(np.float32)))
        return q, pk, pv, table, pos, (sk, sv)
    pk, pv = (torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dt) for _ in range(2))
    return q, pk, pv, table, pos, None


@pytest.mark.parametrize("codec", ["bf16", "int8", "f32"])
@pytest.mark.parametrize("ps,maxp,g,t", [(4, 256, 1, 8), (16, 16, 4, 40), (24, 128, 2, 16),
                                         (100, 4, 1, 130)],
                         ids=["ps4", "ps16-2groups", "ps24", "ps100-2groups"])
def test_kernel_walk_matches_the_plain_version(codec, ps, maxp, g, t):
    """The transcribed walk against the plain version, each query row within
    ATTN_TOL (1e-2) of its own max|plain| (bf16 and int8: the plain
    version rounds the normalized probabilities, the card carries them as
    two bf16 terms) or 1e-5 (f32), at
    page sizes whose tiles hold 8, 4 or 2 pages or a 64-row slice of one,
    with rows split several ways (a grid of a few blocks on 132 SMs) and
    with two row groups."""
    q, pk, pv, table, pos, scales = _pool_case(codec, 3, 2, g, t, ps, maxp, seed=ps + t)
    for layer in (0, L - 1):
        got, plan, counts = _kernel_walk(q, pk, pv, layer, table, pos, scales, 132)
        ref = ta.paged_rows_attention(q, pk, pv, layer, table, pos, scales)
        diff = (got.float() - ref.float()).abs().amax(-1)
        mag = ref.float().abs().amax(-1)
        assert bool((diff <= (1e-5 if codec == "f32" else 1e-2) * mag).all())
    assert max(counts) > 1 or plan.groups > 1


def test_rounding_script_needs_the_card():
    """``chip_prefill_rounding.py`` (kernel 8 against an f64 reference over
    draws of scratch page 0) exits non-zero and prints no table without a
    CUDA card."""
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_prefill_rounding.py"),
                        "--repeats", "1"], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0
    assert "needs a CUDA card" in r.stderr
    assert "max kernel-plain" not in r.stdout
