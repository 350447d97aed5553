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
rounding edge.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.ops import attention as ja
from dllama_tpu_torch.ops import attention as ta

PS, MAXP, L = 4, 8, 2
S = PS * MAXP
ULP = 2.0 ** -8


def _bf16(a: np.ndarray) -> np.ndarray:
    """Round f32 to bf16 values (kept in f32): both packages get the same
    bf16 numbers."""
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).float().numpy()


def _case(t: int, hkv: int, g: int, quant: bool, seed: int):
    """B = 5 rows: at position 0, mid-page (2), across a page edge (3),
    one whose table runs into page 0 after 2 pages (13: its keys from 8 on
    read the scratch page), and one at the end of the table (S - t); rows
    1 and 3 have n_valid < t.  Pools of random bf16 (or int8 + scales)
    values; each row owns interleaved pages."""
    rng = np.random.RandomState(seed)
    b, dh = 5, 16
    hq = hkv * g
    n_pages = 1 + b * MAXP
    table = (1 + np.arange(b * MAXP, dtype=np.int32)).reshape(MAXP, b).T.copy()
    table[3, 2:] = 0
    pos = np.array([0, 2, 3, 13, S - t], np.int32)
    n_valid = np.array([t, max(1, t // 2), t, 1, t], np.int32)
    q = _bf16(rng.randn(b, hq, t, dh))
    kn = _bf16(rng.randn(b, hkv, t, dh))
    vn = _bf16(rng.randn(b, hkv, t, dh))
    shape = (L, n_pages, hkv, PS, dh)
    if quant:
        pk = rng.randint(-127, 128, shape).astype(np.int8)
        pv = rng.randint(-127, 128, shape).astype(np.int8)
        sk = (rng.rand(*shape[:-1], 1) * 0.02).astype(np.float32)
        sv = (rng.rand(*shape[:-1], 1) * 0.02).astype(np.float32)
        pools = (pk, pv, sk, sv)
    else:
        pools = (_bf16(rng.randn(*shape)), _bf16(rng.randn(*shape)))
    return q, kn, vn, pools, table, pos, n_valid


def _jax_read(q, kn, vn, pools, table, pos, n_valid, layer):
    t = q.shape[2]
    pidx, oidx = ja.paged_write_indices(jnp.asarray(table), jnp.asarray(pos),
                                        jnp.asarray(n_valid), t, PS)
    li = jnp.int32(layer)
    bf = jnp.bfloat16
    if len(pools) == 4:
        pk, pv, sk, sv = (jnp.asarray(a) for a in pools)
        qk, s_k = ja.quantize_kv(jnp.asarray(kn, bf))
        qv, s_v = ja.quantize_kv(jnp.asarray(vn, bf))
        pk, pv = ja.paged_update_kv_rows(pk, pv, qk, qv, li, pidx, oidx)
        sk, sv = ja.paged_update_kv_rows(sk, sv, s_k, s_v, li, pidx, oidx)
        scales = (sk, sv)
    else:
        pk, pv = (jnp.asarray(a, bf) for a in pools)
        pk, pv = ja.paged_update_kv_rows(pk, pv, jnp.asarray(kn, bf), jnp.asarray(vn, bf),
                                         li, pidx, oidx)
        scales = None
    out = ja.paged_gqa_attention_at(jnp.asarray(q, bf), pk, pv, li, jnp.asarray(table),
                                    jnp.asarray(pos), scales=scales)
    return np.asarray(out.astype(jnp.float32))


def _port_read(q, kn, vn, pools, table, pos, n_valid, layer, impl="auto"):
    t = q.shape[2]
    tab, p = torch.from_numpy(table), torch.from_numpy(pos)
    pidx, oidx = ta.paged_write_indices(tab, p, torch.from_numpy(n_valid), t, PS)
    bf = torch.bfloat16
    kb, vb = torch.from_numpy(kn).to(bf), torch.from_numpy(vn).to(bf)
    if len(pools) == 4:
        pk, pv, sk, sv = (torch.from_numpy(a.copy()) for a in pools)
        (qk, s_k), (qv, s_v) = ta.quantize_kv(kb), ta.quantize_kv(vb)
        ta.paged_update_kv_rows(pk, pv, qk, qv, layer, pidx, oidx)
        ta.paged_update_kv_rows(sk, sv, s_k, s_v, layer, pidx, oidx)
        scales = (sk, sv)
    else:
        pk, pv = (torch.from_numpy(a).to(bf) for a in pools)
        ta.paged_update_kv_rows(pk, pv, kb, vb, layer, pidx, oidx)
        scales = None
    out = ta.paged_gqa_attention_at(torch.from_numpy(q).to(bf), pk, pv, layer, tab, p,
                                    scales, impl=impl)
    return out


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
    """Four warps: one m16 tile each up to 64 query rows (with fewer tiles,
    the warps of a tile take alternate 16-key chunks), two above; the
    widest step is 128 query rows a block."""
    assert [ta.prefill_warps(r) for r in (2, 16, 17, 32, 48, 64, 65, 128)] == [
        (1, 1, 4), (1, 1, 4), (1, 2, 2), (1, 2, 2), (1, 4, 1), (1, 4, 1), (2, 4, 1), (2, 4, 1)]
    assert ta.prefill_max_t(1) == 128 and ta.prefill_max_t(4) == 32
    assert ta.prefill_max_t(6) == 21  # Grok-1: 48 query heads on 8
    # every width the scheduler emits at --sched-prefill-chunk 16 fits
    # Llama-2-7B (G = 1), Mixtral (G = 4) and Grok-1 (G = 6)
    for g in (1, 4, 6):
        assert all(t <= ta.prefill_max_t(g) for t in (2, 4, 8, 16))


def test_prefill_plan_at_the_serving_shapes():
    """The launch of the 7B and Mixtral mixed steps (B = 8, 256 pages of 16,
    T = 16, 132 SMs): kernel 7's split plan, 64 keys a ring stage when four
    warps share one tile (7B), 32 when each owns one (Mixtral), and the
    shared memory the source carves, both pool dtypes."""
    assert ta.prefill_plan(8, 32, 32, 16, 16, 128, 256, 2, 132) == (8, 32, 4, 108800)
    assert ta.prefill_plan(8, 32, 32, 16, 16, 128, 256, 1, 132) == (8, 32, 4, 89856)
    assert ta.prefill_plan(8, 32, 8, 16, 16, 128, 256, 2, 132) == (32, 8, 2, 69632)
    assert ta.prefill_plan(8, 32, 8, 16, 16, 128, 256, 1, 132) == (32, 8, 2, 60160)
    # the carve-up by hand at the 7B bf16 shape: a 16-row query tile, three
    # stages of K and V tiles of 64 rows of 136 bf16
    ld = 128 + 8
    assert ta.prefill_smem_bytes(16, 16, 128, 2, 4) == 16 * ld * 2 + 3 * 2 * 64 * ld * 2
    # int8: raw stages (values and scales) plus one dequantized tile pair
    assert ta.prefill_smem_bytes(16, 16, 128, 1, 4) == \
        16 * ld * 2 + 3 * (4 * 16 * 128 * 2 + 4 * 16 * 8) + 2 * 64 * ld * 2
    # few pages a stage: the warps' records set the size
    assert ta.prefill_smem_bytes(16, 4, 64, 2, 1) == 16 * 72 * 2 + 4 * 16 * 66 * 4
    # a short table never stages more pages than a split walks
    assert ta.prefill_stage_pages(4, 1, 16) == 1 and ta.prefill_stage_pages(4, 32, 64) == 8


def test_prefill_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="at most 32"):
        ta.prefill_plan(8, 32, 8, 64, 16, 128, 256, 2, 132)
    with pytest.raises(ValueError, match="head dim 96"):
        ta.prefill_plan(8, 32, 32, 16, 16, 96, 256, 2, 132)
    with pytest.raises(ValueError, match="shared memory"):
        ta.prefill_plan(2, 8, 8, 16, 1024, 128, 4, 2, 132)


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


def test_prefill_config_refused_before_any_request():
    """What a paged engine and its scheduler refuse at start-up on the card
    (``Engine.check_slot_width``), so no request meets it in a mixed step:
    an f32 pool, a head dim the source does not instantiate, a widest step
    past ``prefill_max_t``.  The serving shapes pass."""
    ta.check_prefill_config(torch.bfloat16, 128, 1, 128)
    ta.check_prefill_config(torch.int8, 128, 4, 32)
    ta.check_prefill_config(torch.bfloat16, 64, 4)
    with pytest.raises(ValueError, match="torch.float32 pool on the card"):
        ta.check_prefill_config(torch.float32, 128, 1)
    with pytest.raises(ValueError, match="head dim 96"):
        ta.check_prefill_config(torch.bfloat16, 96, 1)
    with pytest.raises(ValueError, match="64 tokens a row with 4 query heads.*at most 32"):
        ta.check_prefill_config(torch.int8, 128, 4, 64)
