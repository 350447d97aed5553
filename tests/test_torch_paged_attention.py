"""The port's slot and paged attention (dllama_tpu_torch.ops.attention)
against the JAX package's, on the same numpy inputs.

Tolerances:
* quantize/dequant, write indices and KV scatters: bit for bit (the same
  f32 arithmetic, the same scatter).
* the fused kernel's plain version against JAX's interpret-mode Pallas
  kernel: 1e-2 × max|ref|, the JAX test's own bar (both fold bf16
  operands page by page, summed in another order).
* the gather route and the page walk in f32: 1e-6 × max|ref| (f32 ulps of
  a different summation order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.ops import attention as ja
from dllama_tpu_torch.ops import attention as ta


def _t(a) -> torch.Tensor:
    """JAX/numpy array → torch, bf16 by bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(x: torch.Tensor) -> np.ndarray:
    return x.to(torch.float32).numpy() if x.dtype == torch.bfloat16 else x.numpy()


def _close(got: torch.Tensor, ref, rel: float):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(_np(got).astype(np.float32), ref, rtol=0,
                               atol=rel * max(float(np.abs(ref).max()), 1e-3))


def _pool_fixture(quantized, b=3, maxp=3, hkv=2, g=2, ps=8, dh=16, nlayers=2):
    """The ragged fixture of tests/test_fused_decode.py: one full row, one
    mid-page, one inside the first page; layer 1 of 2."""
    npages = 1 + b * maxp
    rng = np.random.RandomState(3)
    table = np.arange(1, 1 + b * maxp).reshape(b, maxp).astype(np.int32)
    pos_rows = np.array([maxp * ps - 1, ps + ps // 2, 3], np.int32)
    q = (rng.randn(b, hkv * g, 1, dh) * 0.3).astype(np.float32)
    if quantized:
        pk, sk = ja.quantize_kv(jnp.asarray(rng.randn(nlayers, npages, hkv, ps, dh), jnp.float32))
        pv, sv = ja.quantize_kv(jnp.asarray(rng.randn(nlayers, npages, hkv, ps, dh), jnp.float32))
        scales = (sk, sv)
    else:
        pk = jnp.asarray(rng.randn(nlayers, npages, hkv, ps, dh) * 0.3, jnp.bfloat16)
        pv = jnp.asarray(rng.randn(nlayers, npages, hkv, ps, dh) * 0.3, jnp.bfloat16)
        scales = None
    return q, pk, pv, table, pos_rows, scales


def test_quantize_dequant_bit_identical():
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 3, 5, 16) * 2).astype(np.float32)
    x[0, 1, 2] = 0.0  # an all-zero position: scale 0, values 0
    jq, js = ja.quantize_kv(jnp.asarray(x))
    tq, ts = ta.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32 and ts.shape == (2, 3, 5, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jd, td = ja.dequant_kv(jq, js), ta.dequant_kv(tq, ts)
    assert td.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(td), np.asarray(jd, np.float32))


@pytest.mark.parametrize("quantized", [False, True], ids=["dense", "kv_int8"])
def test_paged_write_indices_and_scatter_identical(quantized):
    """Ragged rows, one past its n_valid (scratch-page writes) and one whose
    window crosses a page edge; the port's in-place scatter leaves the pools
    exactly as JAX's functional update returns them."""
    rng = np.random.RandomState(1)
    b, t, hkv, ps, dh, maxp, L = 3, 4, 2, 4, 8, 4, 2
    table = np.zeros((b, maxp), np.int32)
    table[0, :3] = [5, 2, 9]
    table[1, :2] = [1, 7]
    table[2, :1] = [3]
    pos = np.array([2, 5, 0], np.int32)
    n_valid = np.array([4, 2, 1], np.int32)
    ji = ja.paged_write_indices(jnp.asarray(table), jnp.asarray(pos), jnp.asarray(n_valid), t, ps)
    ti = ta.paged_write_indices(torch.from_numpy(table), torch.from_numpy(pos),
                                torch.from_numpy(n_valid), t, ps)
    for j, tt in zip(ji, ti):
        assert tt.dtype == torch.int32
        np.testing.assert_array_equal(tt.numpy(), np.asarray(j))
    k = rng.randn(b, hkv, t, dh).astype(np.float32)
    shape = (L, 10, hkv, ps, dh)
    if quantized:
        jk, jsk = ja.quantize_kv(jnp.asarray(k))
        tk, tsk = ta.quantize_kv(torch.from_numpy(k))
        pools = [np.zeros(shape, np.int8), np.zeros(shape[:-1] + (1,), np.float32)]
        pairs = [(jk, tk), (jsk, tsk)]
    else:
        pools = [np.zeros(shape, np.float32)]
        pairs = [(jnp.asarray(k), torch.from_numpy(k))]
    # the scratch page's colliding writes are unordered: compare the rest
    for pool, (jn, tn) in zip(pools, pairs):
        jp, _ = ja.paged_update_kv_rows(jnp.asarray(pool), jnp.asarray(pool), jn, jn,
                                        jnp.int32(1), *ji)
        tp = torch.from_numpy(pool.copy())
        ta.paged_update_kv_rows(tp, tp.clone(), tn, tn, 1, *ti)
        np.testing.assert_array_equal(tp.numpy()[:, 1:], np.asarray(jp)[:, 1:])
        assert np.abs(tp.numpy()[:, 1:]).sum() > 0


@pytest.mark.parametrize("quantized", [False, True], ids=["dense", "kv_int8"])
def test_fused_plain_matches_jax_interpret_kernel(quantized):
    """The kernel's plain version (the page walk, what a CPU tensor runs)
    against the JAX package's Pallas kernel in interpret mode."""
    q, pk, pv, table, pos, scales = _pool_fixture(quantized)
    ref = ja.fused_paged_attention(jnp.asarray(q), pk, pv, jnp.int32(1),
                                   jnp.asarray(table), jnp.asarray(pos),
                                   scales=scales, interpret=True)
    ta.reset_counters()
    got = ta.fused_paged_attention(
        torch.from_numpy(q), _t(pk), _t(pv), 1, torch.from_numpy(table),
        torch.from_numpy(pos), None if scales is None else tuple(_t(s) for s in scales))
    assert ta.counters() == {"kernel_launches": 0, "plain_calls": 1,
                             "prefill_launches": 0, "prefill_plain_calls": 0}
    assert got.shape == q.shape and got.dtype == torch.float32
    _close(got, ref, 1e-2)


def test_slot_attention_and_gather_route_match_jax():
    """Contiguous slot rows, and the paged gather route (a prefill chunk of
    T=3 and a single token over a short table), per-row ceilings."""
    rng = np.random.RandomState(2)
    b, hq, hkv, dh, s, L = 3, 4, 2, 16, 24, 2
    pos = np.array([0, 7, 20], np.int32)
    for t in (3, 1):
        q = rng.randn(b, hq, t, dh).astype(np.float32)
        ck = rng.randn(L, b, hkv, s, dh).astype(np.float32)
        cv = rng.randn(L, b, hkv, s, dh).astype(np.float32)
        ref = ja.slot_gqa_attention_at(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
                                       jnp.int32(1), jnp.asarray(pos))
        got = ta.slot_gqa_attention_at(torch.from_numpy(q), torch.from_numpy(ck),
                                       torch.from_numpy(cv), 1, torch.from_numpy(pos))
        _close(got, ref, 1e-6)
    q, pk, pv, table, pos, scales = _pool_fixture(False)
    pk32, pv32 = (np.asarray(x, np.float32) for x in (pk, pv))
    for t in (3, 1):
        qq = np.repeat(q, t, axis=2)
        ref = ja.paged_gqa_attention_at(jnp.asarray(qq), jnp.asarray(pk32), jnp.asarray(pv32),
                                        jnp.int32(1), jnp.asarray(table), jnp.asarray(pos))
        got = ta.paged_gqa_attention_at(torch.from_numpy(qq), torch.from_numpy(pk32),
                                        torch.from_numpy(pv32), 1, torch.from_numpy(table),
                                        torch.from_numpy(pos))
        _close(got, ref, 1e-6)
    # the gathered view itself, int8 pool dequantized after the gather
    q, pk, pv, table, pos, scales = _pool_fixture(True)
    ref = ja.paged_gather_layer(pk, jnp.int32(1), jnp.asarray(table), scale_pool=scales[0])
    got = ta.paged_gather_layer(_t(pk), 1, torch.from_numpy(table), _t(scales[0]))
    np.testing.assert_array_equal(_np(got), np.asarray(ref, np.float32))


def test_paged_decode_walk_matches_jax():
    """The long-table page walk (s >= 4096, the JAX CPU route of a decode
    read) with arbitrary, repeating physical pages."""
    rng = np.random.RandomState(3)
    L, n_pages, hkv, ps, dh, b, hq, maxp = 1, 40, 2, 128, 8, 3, 4, 32
    pk = rng.randn(L, n_pages, hkv, ps, dh).astype(np.float32)
    pv = rng.randn(L, n_pages, hkv, ps, dh).astype(np.float32)
    table = rng.randint(0, n_pages, (b, maxp)).astype(np.int32)
    q = rng.randn(b, hq, 1, dh).astype(np.float32)
    pos = np.array([130, 4095, 700], np.int32)
    ref = ja.paged_decode_attention(jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
                                    jnp.int32(0), jnp.asarray(table), jnp.asarray(pos))
    args = (torch.from_numpy(q), torch.from_numpy(pk), torch.from_numpy(pv), 0,
            torch.from_numpy(table), torch.from_numpy(pos))
    _close(ta.paged_decode_attention(*args), ref, 1e-6)
    _close(ta.paged_gqa_attention_at(*args), ref, 1e-6)


def test_kernel_wrapper_takes_only_cuda_decode():
    """The wrapper launches on CUDA tensors only and never falls back; the
    dispatcher's plain version serves a CPU tensor; T > 1 is not decode."""
    q, pk, pv, table, pos, _ = _pool_fixture(False)
    args = (torch.from_numpy(q), _t(pk), _t(pv), 1, torch.from_numpy(table),
            torch.from_numpy(pos))
    ta.reset_counters()
    with pytest.raises(ValueError, match="CUDA tensor"):
        ta.paged_attention(*args)
    assert ta.counters()["kernel_launches"] == 0
    with pytest.raises(ValueError, match="decode-only"):
        ta.fused_paged_attention(torch.from_numpy(np.repeat(q, 2, axis=2)), *args[1:])
    with pytest.raises(ValueError, match="impl"):
        ta.fused_paged_attention(*args, impl="fast")
    # three ring stages of two bf16 K and two V pages (16 x 128), 48 KB
    assert ta.smem_bytes(1, 16, 128, 2, 2) == 3 * 2 * (2 * 16 * 128 * 2)
