"""The port's Q80 codec and matmul (dllama_tpu_torch.ops.q8), and the flat
plane index that the Q40 and Q80 kernels share, against the JAX package's
(dllama_tpu.ops.q8, q40.QLayerView) on the same numpy inputs.

Packing and dequantization must be bit-identical.  The matmuls multiply
the same bf16 operands (exact products in f32) and differ only in the
order of their f32 sums, so they agree to a few f32 ulps of the result's
scale: tolerance 1e-5 · max|ref| (tighter than the 1e-3 a bf16 product
could need).
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu import quants
from dllama_tpu.ops import q8 as jq8, q40 as jq40
from dllama_tpu_torch.ops import q8 as tq8, q40 as tq40

MATMUL_TOL = 1e-5  # f32 summation order only (see module docstring)


def _qvals_scales(seed, lead, n, d):
    rng = np.random.RandomState(seed)
    qvals = rng.randint(-128, 128, size=(*lead, n, d)).astype(np.int8)
    scales = (rng.rand(*lead, n // 32, d) * 0.02 + 1e-3).astype(np.float16)
    scales[..., ::3, :] = np.float16(3e-6)  # f16 subnormals widen exactly
    return qvals, scales


def _jax_q8(tq: tq8.Q8Tensor) -> jq8.Q8Tensor:
    return jq8.Q8Tensor(jnp.asarray(tq.qpacked.numpy()),
                        jnp.asarray(tq.scales.numpy().view(np.uint16)), tq.logical_nd)


def _same_planes(jq, tq):
    assert jq.logical_nd == tq.logical_nd
    np.testing.assert_array_equal(np.asarray(jq.qpacked), tq.qpacked.numpy())
    np.testing.assert_array_equal(np.asarray(jq.scales), tq.scales.numpy().view(np.uint16))


@pytest.mark.parametrize("lead,n,d", [((), 64, 48), ((), 1056, 40), ((2, 3), 1056, 24)])
def test_pack_planes_bit_identical(lead, n, d):
    """Planes, padding (1056 → 2048 rows: zero values and scales), bits."""
    qvals, scales = _qvals_scales(0, lead, n, d)
    jv, js, jnd = jq8.pack_planes_np(qvals, scales)
    tv, ts, tnd = tq8.pack_planes_np(qvals, scales)
    assert jnd == tnd == (n, d) and tv.shape[-2] == tq40.padded_n(n)
    np.testing.assert_array_equal(jv, tv)
    np.testing.assert_array_equal(js.view(np.uint16), ts.view(np.uint16))


@pytest.mark.parametrize("shape", [(1056, 72), (3, 64, 40)])
def test_quantize_bit_identical(shape):
    w = (np.random.RandomState(1).randn(*shape) * 0.1).astype(np.float32)
    w.reshape(-1)[::7] = 0.0  # exact zeros and all-zero blocks round as the codec does
    w[..., :32, :5] = 0.0
    _same_planes(jq8.quantize(w), tq8.quantize(w))


def test_quantize_rejects_scale_overflow():
    w = np.full((32, 4), 1e7, np.float32)  # absmax/127 > 65504: inf in f16
    with pytest.raises(ValueError, match="overflowed"):
        jq8.quantize(w)
    with pytest.raises(ValueError, match="overflowed"):
        tq8.quantize(w)


def _file_groups(seed, n, dims, layers):
    rng = np.random.RandomState(seed)
    return [[(quants.quantize_q80(rng.randn(d, n).astype(np.float32)), d, n) for d in dims]
            for _ in range(layers)]


def test_pack_file_groups_bit_identical():
    """Fused (q|k|v-style) groups straight from `.m` Q80 bytes, two layers,
    a padded n; and the 2-D (wcls) form."""
    groups = _file_groups(2, 1056, (32, 16, 16), 2)
    _same_planes(jq8.pack_file_groups(groups), tq8.pack_file_groups(groups))
    one = groups[:1]
    _same_planes(jq8.pack_file_groups(one, stacked=False),
                 tq8.pack_file_groups(one, stacked=False))


def test_repack_file_bytes_is_the_codec():
    """A repacked `.m` tensor dequantizes (in f32) to the file codec's
    values."""
    n, d = 96, 24
    raw = quants.quantize_q80(np.random.RandomState(3).randn(d, n).astype(np.float32))
    qv = np.zeros((n, d), np.int8)
    sc = np.zeros((n // 32, d), np.float16)
    tq8.repack_file_bytes_into(raw, d, n, qv, sc)
    qt = tq8.Q8Tensor(torch.from_numpy(qv), torch.from_numpy(sc), (n, d))
    expect = quants.dequantize_q80(raw, n * d).reshape(d, n).T
    np.testing.assert_array_equal(tq8.dequantize(qt, torch.float32).numpy(), expect)


def test_pack_file_groups_rejects_inf_scale():
    groups = _file_groups(4, 64, (16,), 1)
    raw = groups[0][0][0].copy()
    raw[:2] = np.frombuffer(np.float16(np.inf).tobytes(), np.uint8)  # block 0's delta
    bad = [[(raw, 16, 64)]]
    with pytest.raises(ValueError, match="inf/NaN"):
        jq8.pack_file_groups(bad)
    with pytest.raises(ValueError, match="inf/NaN"):
        tq8.pack_file_groups(bad)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dequantize_bit_identical(dtype):
    """One bf16 round of f32(v)·f32(s) (or none, in f32), per plane of an
    (L, E, ...) stack addressed by its flat index."""
    qvals, scales = _qvals_scales(5, (2, 3), 1056, 40)
    tqt = tq8.from_np(*tq8.pack_planes_np(qvals, scales))
    jqt = _jax_q8(tqt)
    j = np.asarray(jq8.dequantize(jqt, getattr(jnp, dtype)))
    for flat in (0, 4, 5):
        t = tq8.dequantize(tqt, getattr(torch, dtype), layer=flat)
        bits = t.view(torch.int16 if dtype == "bfloat16" else torch.int32).numpy()
        ref = j[flat // 3, flat % 3]
        np.testing.assert_array_equal(bits, ref.view(bits.dtype))
        assert t.shape == (1056, 40)


@pytest.mark.parametrize("t", [1, 5])
def test_matmul_plain_matches_xla(t):
    """2-D weight with a padded n: the port's matmul ≡ impl="xla"."""
    w = (np.random.RandomState(6).randn(1056, 96) * 0.1).astype(np.float32)
    x = np.random.RandomState(7).randn(t, 1056).astype(np.float32)
    ref = np.asarray(jq8.matmul(jnp.asarray(x), jq8.quantize(w), impl="xla"))
    out = tq8.matmul(torch.from_numpy(x), tq8.quantize(w)).numpy()
    assert out.dtype == np.float32 and out.shape == (t, 96)
    np.testing.assert_allclose(out, ref, rtol=0, atol=MATMUL_TOL * np.abs(ref).max())


@pytest.mark.parametrize("layer", [0, 3])
@pytest.mark.parametrize("t", [1, 3])
def test_stacked_matmul_matches_pallas_interpret(t, layer):
    """Stacked planes at layers 0 and L-1 of 4: the port's matmul ≡ the
    stacked Pallas kernel run in interpret mode on a QLayerView."""
    w = (np.random.RandomState(8).randn(4, 512, 128) * 0.1).astype(np.float32)
    x = np.random.RandomState(9).randn(t, 512).astype(np.float32)
    ref = np.asarray(jq8.matmul(jnp.asarray(x), jq40.QLayerView(jq8.quantize(w),
                                                                jnp.int32(layer)),
                                impl="pallas_interpret"))
    out = tq8.matmul(torch.from_numpy(x), tq8.quantize(w), layer=layer).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=MATMUL_TOL * np.abs(ref).max())


@pytest.mark.parametrize("codec", ["q40", "q80"])
def test_flat_index_over_expert_stack(codec):
    """An (L, E, n, d) expert stack read at ``layer·E + expert``, given as a
    Python int and as an int32 tensor, ≡ the JAX package's
    ``QLayerView(stack, layer).select(expert, E)``."""
    jc, tc = (jq40, tq40) if codec == "q40" else (jq8, tq8)
    L, E = 2, 3
    w = (np.random.RandomState(10).randn(L, E, 256, 64) * 0.1).astype(np.float32)
    x = np.random.RandomState(11).randn(1, 256).astype(np.float32)
    jw, tw = jc.quantize(w), tc.quantize(w)
    for layer, expert in ((0, 0), (1, 2), (1, 0)):
        view = jq40.QLayerView(jw, jnp.int32(layer)).select(jnp.int32(expert), E)
        ref = np.asarray(jc.matmul(jnp.asarray(x), view, impl="xla"))
        flat = layer * E + expert
        for idx in (flat, torch.tensor(flat, dtype=torch.int32)):
            out = tq40.mm(torch.from_numpy(x), tw, idx).numpy()
            np.testing.assert_allclose(out, ref, rtol=0,
                                       atol=MATMUL_TOL * np.abs(ref).max())


def test_mm_dispatches_by_codec():
    """mm: Q40 → q40.matmul, Q80 → q8.matmul, dense → x @ w (a plane of a
    stacked dense weight at a flat index); each codec counts its own
    plain calls on the CPU."""
    rng = np.random.RandomState(12)
    w = (rng.randn(2, 64, 32) * 0.1).astype(np.float32)
    x = torch.from_numpy(rng.randn(3, 64).astype(np.float32))
    w4, w8 = tq40.quantize(w), tq8.quantize(w)
    tq40.reset_counters()
    tq8.reset_counters()
    a = tq40.mm(x, w4, 1)
    b = tq40.mm(x, w8, 1)
    c = tq40.mm(x, torch.from_numpy(w), torch.tensor(1, dtype=torch.int32))
    assert tq40.counters()["plain_calls"] == 1 and tq8.counters()["plain_calls"] == 1
    assert tq8.counters()["kernel_launches"] == 0
    assert torch.equal(a, tq40.matmul_plain(x, w4, 1))
    assert torch.equal(b, tq8.matmul_plain(x, w8, 1))
    np.testing.assert_allclose(c.numpy(), x.numpy() @ w[1], rtol=1e-6, atol=1e-6)
    with pytest.raises(TypeError, match="unsupported weight"):
        tq40.mm(x, w)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrapper launches on CUDA tensors or raises; it has no CPU
    path to fall back to."""
    qt = tq8.quantize(np.random.RandomState(13).randn(64, 32).astype(np.float32))
    with pytest.raises(ValueError, match="q8_matmul: x must be a CUDA tensor"):
        tq8.q8_matmul(torch.ones(1, 64), qt.qpacked, qt.scales, 64)
    assert tq8.counters()["kernel_launches"] == 0


def test_plane_index_checks():
    """The kernels' plane index: a Python int inside the plane count, or one
    int32 on the weight's device; a 2-D plane takes none."""
    dev = torch.device("cpu")
    planes = torch.zeros((2, 3, 64, 8), dtype=torch.int8)
    idx, count = tq40.plane_index(planes, 5, dev, "t")
    assert count == 6 and idx.dtype == torch.int32 and int(idx) == 5
    t = torch.tensor(4, dtype=torch.int32)
    assert tq40.plane_index(planes, t, dev, "t") == (t, 6)
    for bad, msg in ((6, "outside"), (torch.tensor(1), "int32"), (None, "needs a layer")):
        with pytest.raises(ValueError, match=msg):
            tq40.plane_index(planes, bad, dev, "t")
    with pytest.raises(ValueError, match="2-D plane"):
        tq40.plane_index(planes[0, 0], 0, dev, "t")


def test_bind_declares_pointer_arguments():
    """Every pointer and the stream cross ctypes as c_void_p (64-bit); the
    tensor-core body takes its plan, TMA or not and the copy widths as
    c_int, and its layout report a tile height and an int array."""
    class Fake:
        class _Fn:
            pass
        q8_matmul = _Fn()
        q8_matmul_mma = _Fn()
        q8_mma_layout = _Fn()

    lib = tq8.bind(Fake())
    argt = lib.q8_matmul.argtypes  # the decode body: x, values, scales, out, index, workspace
    assert argt[:7] == [ctypes.c_void_p] * 7 and argt[-1] is ctypes.c_void_p
    assert argt[7:15] == [ctypes.c_int] * 8 and lib.q8_matmul.restype is ctypes.c_int
    argt = lib.q8_matmul_mma.argtypes
    assert argt[:6] == [ctypes.c_void_p] * 6 and argt[-1] is ctypes.c_void_p
    assert argt[6:17] == [ctypes.c_int] * 11 and len(argt) == 18
    assert lib.q8_matmul_mma.restype is ctypes.c_int
    assert lib.q8_mma_layout.argtypes == [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
