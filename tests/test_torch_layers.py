"""The port's layer ops (dllama_tpu_torch.ops.kernels / .attention) and
device sampler against the JAX package's, on the same numpy inputs.

Tolerances: f32 elementwise ops differ by at most a few ulps (XLA's and
PyTorch's exp/rsqrt/cos/sin are not bit-identical): 2e-6 relative.  bf16
results may differ by one bf16 ulp where the f32 value before the cast sits
on a rounding boundary: 2^-7 relative.  Attention sums f32 products in
another order: 1e-5 of the output scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.ops import attention as jatt, kernels as jk
from dllama_tpu.sampling import sample_on_device as j_sample, sample_with_coin
from dllama_tpu_torch.ops import attention as tatt, kernels as tk
from dllama_tpu_torch.sampling import sample_on_device as t_sample

F32_TOL = 2e-6
BF16_TOL = 2.0 ** -7
ATT_TOL = 1e-5

_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _both(a: np.ndarray, dtype=torch.float32):
    """One numpy array as a JAX and a torch array of ``dtype``."""
    return jnp.asarray(a, _JDT[dtype]), torch.from_numpy(a).to(dtype)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x.astype(jnp.float32))


def _close(t, j, tol):
    t, j = _np(t), _np(j)
    np.testing.assert_allclose(t, j, rtol=0, atol=tol * max(np.abs(j).max(), 1e-30))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)])
def test_rmsnorm(dtype, tol):
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 64).astype(np.float32)
    w = rng.rand(64).astype(np.float32) + 0.5
    jx, tx = _both(x, dtype)
    out = tk.rmsnorm(tx, torch.from_numpy(w))
    assert out.dtype == dtype
    _close(out, jk.rmsnorm(jx, jnp.asarray(w)), tol)


@pytest.mark.parametrize("interleaved", [True, False])
def test_rope_both_conventions(interleaved):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 6, 4, 16).astype(np.float32)
    pos = np.arange(7, 13)
    jc, js = jk.rope_angles(jnp.asarray(pos), 16, 10000.0)
    tc, ts = tk.rope_angles(torch.from_numpy(pos), 16, 10000.0)
    _close(tc, jc, F32_TOL)
    _close(ts, js, F32_TOL)
    out = tk.apply_rope(torch.from_numpy(x), tc, ts, interleaved=interleaved)
    _close(out, jk.apply_rope(jnp.asarray(x), jc, js, interleaved=interleaved), F32_TOL)


def test_softmax_silu_gelu():
    x = (np.random.RandomState(2).randn(4, 33) * 3).astype(np.float32)
    jx, tx = _both(x)
    _close(tk.softmax_f32(tx), jk.softmax_f32(jx), F32_TOL)
    _close(tk.silu(tx), jk.silu(jx), F32_TOL)
    _close(tk.gelu_tanh(tx), jk.gelu_tanh(jx), F32_TOL)


def test_update_kv_cache_at():
    rng = np.random.RandomState(3)
    ck = rng.randn(2, 1, 2, 16, 8).astype(np.float32)
    cv = rng.randn(2, 1, 2, 16, 8).astype(np.float32)
    kn = rng.randn(1, 2, 3, 8).astype(np.float32)
    vn = rng.randn(1, 2, 3, 8).astype(np.float32)
    jk_, jv_ = jatt.update_kv_cache_at(jnp.asarray(ck), jnp.asarray(cv),
                                       jnp.asarray(kn), jnp.asarray(vn),
                                       jnp.int32(1), jnp.int32(5))
    tk_, tv_ = tatt.update_kv_cache_at(torch.from_numpy(ck.copy()),
                                       torch.from_numpy(cv.copy()),
                                       torch.from_numpy(kn), torch.from_numpy(vn), 1, 5)
    np.testing.assert_array_equal(tk_.numpy(), np.asarray(jk_))
    np.testing.assert_array_equal(tv_.numpy(), np.asarray(jv_))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,pos", [(5, 3), (1, 40)])
def test_gqa_attention_short_cache(dtype, t, pos):
    rng = np.random.RandomState(4)
    q = rng.randn(1, 4, t, 16).astype(np.float32)
    k = rng.randn(1, 2, 64, 16).astype(np.float32)
    v = rng.randn(1, 2, 64, 16).astype(np.float32)
    (jq, tq), (jkc, tkc), (jvc, tvc) = _both(q, dtype), _both(k, dtype), _both(v, dtype)
    ref = jatt.gqa_attention(jq, jkc, jvc, jnp.int32(pos), t)
    out = tatt.gqa_attention(tq, tkc, tvc, pos, t)
    assert out.dtype == dtype
    _close(out, ref, ATT_TOL if dtype == torch.float32 else BF16_TOL)


@pytest.mark.parametrize("pos", [5, 1500])
def test_gqa_attention_at_blocked_decode(pos):
    """seq_len 4096 crosses _DECODE_BLOCKED_MIN_S: one query token walks
    only the live 1024-blocks of the stacked cache at layer 1."""
    assert tatt._use_blocked_decode(1, 4096)
    rng = np.random.RandomState(5)
    q = rng.randn(1, 4, 1, 8).astype(np.float32)
    ck = rng.randn(2, 1, 2, 4096, 8).astype(np.float32)
    cv = rng.randn(2, 1, 2, 4096, 8).astype(np.float32)
    ref = jatt.gqa_attention_at(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
                                jnp.int32(1), jnp.int32(pos), 1)
    out = tatt.gqa_attention_at(torch.from_numpy(q), torch.from_numpy(ck),
                                torch.from_numpy(cv), 1, pos, 1)
    _close(out, ref, ATT_TOL)


def test_gqa_attention_blocked_prefill():
    """A score tensor past _BLOCKED_THRESHOLD takes the online-softmax
    prefill in both packages."""
    t, s = 264, 4096
    assert 2 * t * s > tatt._BLOCKED_THRESHOLD
    rng = np.random.RandomState(6)
    q = rng.randn(1, 4, t, 8).astype(np.float32)
    k = rng.randn(1, 2, s, 8).astype(np.float32)
    v = rng.randn(1, 2, s, 8).astype(np.float32)
    ref = jatt.gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.int32(100), t)
    out = tatt.gqa_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), 100, t)
    _close(out, ref, ATT_TOL)


def test_sample_on_device_fixed_coins():
    """Same coins → same tokens as the JAX device sampler and the host
    reference, across greedy / multinomial / nucleus / top-k with ties at
    the bar and the vocab mask."""
    rng = np.random.RandomState(11)
    v = 48
    cases = [(t, p, k) for t in (0.0, 0.4, 1.0) for p in (0.0, 0.5, 0.9, 1.0)
             for k in (0, 3, v)]
    n = len(cases)
    logits = (rng.randn(n, v) * 2.0).astype(np.float32)
    logits[:, 7] = logits[:, 3]  # ties through top-k and the stable sort
    coins = rng.rand(n).astype(np.float32)
    temps = np.asarray([c[0] for c in cases], np.float32)
    topps = np.asarray([c[1] for c in cases], np.float32)
    topks = np.asarray([c[2] for c in cases], np.int32)
    mask = np.ones(v, bool)
    mask[::7] = False
    for m in (None, mask):
        host = [sample_with_coin(logits[i], float(coins[i]), temperature=float(temps[i]),
                                 topp=float(topps[i]), topk=int(topks[i]), mask=m)
                for i in range(n)]
        jdev = j_sample(jnp.asarray(logits), jnp.asarray(coins), jnp.asarray(temps),
                        jnp.asarray(topps), jnp.asarray(topks),
                        mask=None if m is None else jnp.asarray(m))
        tdev = t_sample(torch.from_numpy(logits), torch.from_numpy(coins),
                        torch.from_numpy(temps), torch.from_numpy(topps),
                        torch.from_numpy(topks),
                        mask=None if m is None else torch.from_numpy(m))
        assert tdev.dtype == torch.int32
        assert tdev.tolist() == [int(x) for x in np.asarray(jdev)] == host
