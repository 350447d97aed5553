"""The host side of the two kernels redesigned for Hopper, on the CPU:
kernel 7's split page walk (``ops/attention.py`` ``split_plan``) and the
Q80 kernel's tensor-core body (``ops/q8.py`` ``mma_plan`` and ``route``).
The kernels themselves run only on the card (``chip_smoke.py`` phases 6 and
9); here the plans are held to what the kernels assume, and the combine
algebra of kernel 7's second pass is held to the JAX package's Pallas
kernel in interpret mode.

Tolerance: the split-then-combine fold against the interpret-mode kernel,
1e-2 × max|ref|, the bar of ``test_fused_plain_matches_jax_interpret_kernel``
(both fold bf16 operands, summed in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.ops import attention as ja
from dllama_tpu_torch.ops import attention as ta
from dllama_tpu_torch.ops import q8 as tq8, q40 as tq40

N_SMS = 132  # an H100 SXM
# (n, d) of every Q80 site the card runs: Llama-2-7B, Mixtral-8x7B, Grok-1's
# experts, and a rank's slices of the 7B sites at tp = 2
SITES = [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096), (4096, 32000),
         (4096, 6144), (4096, 14336), (14336, 4096),
         (6144, 32768), (32768, 6144),
         (4096, 2048), (2048, 4096), (4096, 5504), (5504, 4096), (4096, 16000)]
# the scratch of the tensor-core body stays within MMA_MAX_WAVES waves of
# f32 output tiles (one 128 x 128 tile an SM) whenever it splits: 34.6 MB
SCRATCH_BOUND = 4 * N_SMS * 128 * 128 * 4


def _t(a) -> torch.Tensor:
    """JAX/numpy array → torch, bf16 by bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("maxp", [1, 2, 5, 31, 256, 2048])
@pytest.mark.parametrize("b,hkv", [(1, 1), (1, 32), (8, 8), (8, 32), (64, 32)])
def test_attention_split_plan_covers_each_page_once(maxp, b, hkv):
    """Splits of ``pps`` consecutive pages cover pages 0..maxp-1 exactly
    once, none empty, for every shape; the plan takes shapes only."""
    for n_sms in (1, 66, N_SMS):
        splits, pps = ta.split_plan(maxp, b, hkv, n_sms)
        assert splits >= 1 and pps >= 1
        pages = [p for s in range(splits) for p in range(s * pps, min((s + 1) * pps, maxp))]
        assert pages == list(range(maxp))
        assert (splits - 1) * pps < maxp  # the last split holds a page
        assert 1 <= ta.stage_pages(16, pps) <= pps


def test_attention_split_plan_at_the_card_shapes():
    """Llama-2-7B at B = 8 (32 kv heads): 8 splits of 32 pages; Mixtral's 8
    kv heads: 32 splits of 8 pages (4096 positions in 16-token pages)."""
    assert ta.split_plan(256, 8, 32, N_SMS) == (8, 32)
    assert ta.split_plan(256, 8, 8, N_SMS) == (32, 8)
    assert ta.smem_bytes(1, 16, 128, 2, 2) <= 48 * 1024


def _split_fold(q, pk, pv, layer, table, pos, scales, splits, pps):
    """Pass 1 and pass 2 of kernel 7 in plain PyTorch: each split folds its
    pages with the port's ``_online_fold``, then the splits combine in split
    order, m = max m_s, l = sum exp(m_s - m) l_s, acc = sum exp(m_s - m) acc_s."""
    b, hq, _, dh = q.shape
    hkv, ps = pk.shape[2], pk.shape[3]
    maxp = table.shape[1]
    qf = q.to(torch.float32).reshape(b, hkv, hq // hkv, 1, dh)
    scale = float(np.float32(1.0) / np.sqrt(np.float32(dh)))
    tab = table.long()

    def page(pool, p):
        return pool[layer, tab[:, p]]  # (B, Hkv, ps, Dh)

    parts = []
    for s in range(splits):
        m, l, acc = ta._fold_init(b, hkv, hq // hkv, 1, dh, q.device)
        for p in range(s * pps, min((s + 1) * pps, maxp)):
            kb, vb = page(pk, p), page(pv, p)
            if scales is not None:
                kb, vb = ta.dequant_kv(kb, page(scales[0], p)), ta.dequant_kv(vb, page(scales[1], p))
            s_idx = p * ps + torch.arange(ps)
            mask = s_idx[None, None, :] <= pos.long()[:, None, None]
            m, l, acc = ta._online_fold(qf, kb, vb, mask, m, l, acc, scale)
        parts.append((m, l, acc))
    live = [int(pp) // ps // pps + 1 for pp in pos]  # splits that hold a live page, a row
    out = torch.empty(b, hkv, hq // hkv, 1, dh)
    for r in range(b):
        ms = torch.stack([parts[s][0][r] for s in range(live[r])])
        mx = ms.amax(dim=0)
        w = torch.exp(ms - mx)
        l = (w * torch.stack([parts[s][1][r] for s in range(live[r])])).sum(dim=0)
        a = (w[..., None] * torch.stack([parts[s][2][r] for s in range(live[r])])).sum(dim=0)
        out[r] = a / torch.clamp(l, min=1e-38)[..., None]
    return out.reshape(b, hq, 1, dh)


@pytest.mark.parametrize("n_sms", [1, N_SMS], ids=["2_splits", "1_page_splits"])
@pytest.mark.parametrize("quantized", [False, True], ids=["dense", "kv_int8"])
def test_split_combine_matches_jax_interpret_kernel(quantized, n_sms):
    """Rows at positions 0, ps-1, ps and maxp·ps-1, pages cut as the plan
    cuts them, against the JAX package's Pallas kernel (interpret mode)."""
    b, maxp, hkv, g, ps, dh, nlayers = 4, 5, 2, 2, 8, 16, 2
    npages = 1 + b * maxp
    rng = np.random.RandomState(6)
    table = (1 + rng.permutation(b * maxp)).reshape(b, maxp).astype(np.int32)
    pos = np.array([0, ps - 1, ps, maxp * ps - 1], np.int32)
    q = (rng.randn(b, hkv * g, 1, dh) * 0.5).astype(np.float32)
    if quantized:
        pk, sk = ja.quantize_kv(jnp.asarray(rng.randn(nlayers, npages, hkv, ps, dh), jnp.float32))
        pv, sv = ja.quantize_kv(jnp.asarray(rng.randn(nlayers, npages, hkv, ps, dh), jnp.float32))
        scales = (sk, sv)
    else:
        pk = jnp.asarray(rng.randn(nlayers, npages, hkv, ps, dh) * 0.5, jnp.bfloat16)
        pv = jnp.asarray(rng.randn(nlayers, npages, hkv, ps, dh) * 0.5, jnp.bfloat16)
        scales = None
    ref = np.asarray(ja.fused_paged_attention(
        jnp.asarray(q), pk, pv, jnp.int32(1), jnp.asarray(table), jnp.asarray(pos),
        scales=scales, interpret=True), np.float32)
    splits, pps = ta.split_plan(maxp, b, hkv, n_sms)
    assert splits == (2 if n_sms == 1 else maxp)
    got = _split_fold(torch.from_numpy(q), _t(pk), _t(pv), 1, torch.from_numpy(table),
                      torch.from_numpy(pos),
                      None if scales is None else tuple(_t(s) for s in scales), splits, pps)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-2 * max(float(np.abs(ref).max()), 1e-3))


@pytest.mark.parametrize("t", [16, 128])
@pytest.mark.parametrize("n,d", SITES)
def test_mma_plan_covers_n_and_bounds_scratch(n, d, t):
    bm, bn, splits, per = tq8.mma_plan(t, n, d, N_SMS)
    assert bm in tq8.MMA_BMS and bm >= t and bn == tq8.MMA_BN
    steps = -(-n // tq8.MMA_BK)
    assert splits * per >= steps and (splits - 1) * per < steps  # all of n, no empty split
    tiles = -(-t // bm) * -(-d // tq8.MMA_BN)
    assert splits == 1 or splits * tiles <= tq40.MMA_MAX_WAVES * N_SMS
    assert (splits * t * d * 4 if splits > 1 else 0) <= SCRATCH_BOUND


def test_mma_plan_of_the_7b_wo_at_prefill_width():
    """wo (4096→4096) at t = 128: 32 output tiles of 128 x 128 on 132 SMs,
    so the cost model splits n (64 steps) rather than leave 100 SMs idle:
    4 splits of 16 steps, 8 MB of scratch (the decode body needs none)."""
    assert tq8.mma_plan(128, 4096, 4096, N_SMS) == (128, 128, 4, 16)


@pytest.mark.parametrize("t", [1, 2, 3, 4, 5, 8, 16, 17, 64, 128])
def test_route_by_rows(t):
    assert tq8.route(t) == ("gemv" if t < tq8.T_MMA else "mma")


def test_tensor_core_body_refuses_cpu_tensors():
    """At t >= T_MMA the wrapper takes the tensor-core body, which launches
    on CUDA tensors or raises, as the GEMV body does."""
    qt = tq8.quantize(np.random.RandomState(13).randn(64, 32).astype(np.float32))
    tq8.reset_counters()
    with pytest.raises(ValueError, match="q8_matmul_mma: x must be a CUDA tensor"):
        tq8.q8_matmul(torch.ones(tq8.T_MMA, 64), qt.qpacked, qt.scales, 64)
    with pytest.raises(ValueError, match="unknown body"):
        tq8.q8_matmul(torch.ones(1, 64), qt.qpacked, qt.scales, 64, body="wgmma")
    assert tq8.counters()["kernel_launches"] == 0 and tq8.counters()["mma_launches"] == 0
