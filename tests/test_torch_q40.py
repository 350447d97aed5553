"""The port's Q40 codec and matmul (dllama_tpu_torch.ops.q40) against the
JAX package's (dllama_tpu.ops.q40) on the same numpy inputs.

Packing and dequantization must be bit-identical.  The matmuls differ only
in the order of their f32 sums (both multiply the same bf16 operands, whose
products are exact in f32), so they agree to a few f32 ulps of the result's
scale: tolerance 1e-5 · max|ref|.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu import quants
from dllama_tpu.ops import q40 as jq40
from dllama_tpu_torch import device as tdevice
from dllama_tpu_torch.ops import _build, q40 as tq40

MATMUL_TOL = 1e-5  # f32 summation order only (see module docstring)


def _qvals_scales(seed, lead, n, d, subnormal=False):
    rng = np.random.RandomState(seed)
    qvals = rng.randint(-8, 8, size=(*lead, n, d)).astype(np.int8)
    scales = (rng.rand(*lead, n // 32, d) * 0.02 + 1e-3).astype(np.float16)
    if subnormal:  # f16 subnormals (< 6.1e-5) must widen exactly
        scales[..., ::3, :] = np.float16(3e-6)
        scales[..., 1, ::5] = np.float16(-5.96e-8)  # the smallest f16 subnormal
    return qvals, scales


@pytest.mark.parametrize("lead,n,d", [((), 64, 48), ((), 1056, 40), ((3,), 1056, 24)])
def test_pack_planes_bit_identical(lead, n, d):
    """Planes, padding (1056 → 2048 rows, zero scales) and scale bits."""
    qvals, scales = _qvals_scales(0, lead, n, d, subnormal=True)
    jp, js, jnd = jq40.pack_planes_np(qvals, scales)
    tp, ts, tnd = tq40.pack_planes_np(qvals, scales)
    assert jnd == tnd == (n, d)
    assert tp.shape[-2] * 2 == tq40.padded_n(n) == jq40.padded_n(n)
    np.testing.assert_array_equal(jp, tp)
    np.testing.assert_array_equal(js.view(np.uint16), ts.view(np.uint16))


def test_quantize_bit_identical():
    w = (np.random.RandomState(1).randn(1056, 72) * 0.1).astype(np.float32)
    jq, tq = jq40.quantize(w), tq40.quantize(w)
    np.testing.assert_array_equal(np.asarray(jq.qpacked), tq.qpacked.numpy())
    np.testing.assert_array_equal(np.asarray(jq.scales),
                                  tq.scales.numpy().view(np.uint16))


def test_pack_file_groups_bit_identical():
    """Fused (q|k|v-style) groups from `.m` bytes, two layers, padded n."""
    rng = np.random.RandomState(2)
    n = 1056
    groups = []
    for _ in range(2):
        groups.append([(quants.quantize_q40(rng.randn(d, n).astype(np.float32)), d, n)
                       for d in (32, 16, 16)])
    jq = jq40.pack_file_groups(groups)
    tq = tq40.pack_file_groups(groups)
    assert jq.logical_nd == tq.logical_nd == (n, 64)
    np.testing.assert_array_equal(np.asarray(jq.qpacked), tq.qpacked.numpy())
    np.testing.assert_array_equal(np.asarray(jq.scales),
                                  tq.scales.numpy().view(np.uint16))


def test_dequantize_bit_identical():
    qvals, scales = _qvals_scales(3, (2,), 1056, 40, subnormal=True)
    jqt = jq40.pack_planes(qvals, scales)
    tqt = tq40.pack_planes(qvals, scales)
    for layer in (0, 1):
        j = np.asarray(jq40.dequantize(jqt, jnp.float32))[layer]
        t = tq40.dequantize(tqt, torch.float32, layer=layer).numpy()
        np.testing.assert_array_equal(j.view(np.uint32), t.view(np.uint32))
        jb = np.asarray(jq40.dequantize(jqt, jnp.bfloat16))[layer].view(np.uint16)
        tb = tq40.dequantize(tqt, torch.bfloat16, layer=layer).view(torch.int16).numpy()
        np.testing.assert_array_equal(jb, tb.view(np.uint16))


@pytest.mark.parametrize("t", [1, 5])
def test_matmul_plain_matches_xla(t):
    """2-D weight with a padded n: the port's plain matmul ≡ impl="xla"."""
    w = (np.random.RandomState(4).randn(1056, 96) * 0.1).astype(np.float32)
    x = np.random.RandomState(5).randn(t, 1056).astype(np.float32)
    ref = np.asarray(jq40.matmul(jnp.asarray(x), jq40.quantize(w), impl="xla"))
    out = tq40.matmul(torch.from_numpy(x), tq40.quantize(w)).numpy()
    assert out.dtype == np.float32 and out.shape == (t, 96)
    np.testing.assert_allclose(out, ref, rtol=0, atol=MATMUL_TOL * np.abs(ref).max())


@pytest.mark.parametrize("t", [1, 5])
def test_stacked_matmul_matches_pallas_interpret(t):
    """Stacked planes at layer 2 of 3: the port's matmul(layer=2) ≡ the
    Pallas stacked kernel run in interpret mode on a QLayerView."""
    w = (np.random.RandomState(6).randn(3, 1024, 256) * 0.1).astype(np.float32)
    x = np.random.RandomState(7).randn(t, 1024).astype(np.float32)
    ref = np.asarray(jq40.matmul(jnp.asarray(x),
                                 jq40.QLayerView(jq40.quantize(w), jnp.int32(2)),
                                 impl="pallas_interpret"))
    out = tq40.matmul(torch.from_numpy(x), tq40.quantize(w), layer=2).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=MATMUL_TOL * np.abs(ref).max())


def test_cpu_dispatch_counts_plain_only():
    qt = tq40.quantize(np.random.RandomState(8).randn(64, 32).astype(np.float32))
    tq40.reset_counters()
    out = tq40.matmul(torch.ones(2, 3, 64, dtype=torch.bfloat16), qt)
    assert out.shape == (2, 3, 32) and out.dtype == torch.bfloat16
    c = tq40.counters()
    assert (c["kernel_launches"], c["plain_calls"]) == (0, 1)
    assert c["launches_by_shape"] == {}


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrapper launches on CUDA tensors or raises; it has no
    CPU path to fall back to."""
    qt = tq40.quantize(np.random.RandomState(9).randn(64, 32).astype(np.float32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tq40.q40_matmul(torch.ones(1, 64), qt.qpacked, qt.scales, 64)
    assert tq40.counters()["kernel_launches"] == 0


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc → a clear RuntimeError from the kernel build, never a library
    handle or a plain-path substitute."""
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_lib", None)
    if _build.os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed at its default location")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load()
    assert _build._lib is None


def test_cuda_device_request():
    """``cuda`` raises where there is no CUDA device; ``cpu`` always works."""
    assert tdevice.resolve("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert tdevice.resolve(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            tdevice.resolve(None)
        with pytest.raises(RuntimeError, match="cuda"):
            tdevice.resolve("cuda")


@pytest.mark.parametrize("n,d", [(4096, 12288), (4096, 4096), (4096, 22016),
                                 (11008, 4096), (4096, 32000), (64, 48)])
def test_split_plan_covers_reduction(n, d):
    """The decode body's split plan (gemv_plan) covers every quantization
    block exactly once with no empty split and, at the 7B shapes, gives the
    132-SM card at least 96 blocks of 128 columns."""
    splits, per = tq40.gemv_plan(n, d, 132)
    nb = n // 32
    assert (splits - 1) * per < nb <= splits * per
    if n >= 4096:
        assert splits * -(-d // tq40.GEMV_COLS[2]) >= 96


def test_bind_declares_pointer_arguments():
    """Every pointer and the stream cross ctypes as c_void_p (64-bit)."""
    class Fake:
        class _Fn:
            pass
        q40_matmul = _Fn()
        q40_matmul_blocked = _Fn()
        q40_matmul_mma = _Fn()
        q40_matmul_blocked_mma = _Fn()
        q40_mma_layout = _Fn()
        q40_error_string = _Fn()
        tp_allreduce = _Fn()
        tp_enable_peer = _Fn()

    lib = tq40.bind(Fake())
    for fn in (lib.q40_matmul, lib.q40_matmul_blocked):
        argt = fn.argtypes  # the decode body: x, values, scales, out, index, workspace
        assert argt[:7] == [ctypes.c_void_p] * 7 and argt[-1] is ctypes.c_void_p
        assert set(argt[7:-1]) == {ctypes.c_int}
        assert fn.restype is ctypes.c_int
    # kernel 3 takes the tile shape (bn, td, nJ) where kernels 1-2 take the
    # variant: always classic on blocked planes
    assert len(lib.q40_matmul_blocked.argtypes) == len(lib.q40_matmul.argtypes) - 1 + 3
    assert len(lib.q40_matmul_blocked_mma.argtypes) == len(lib.q40_matmul_mma.argtypes) - 1 + 3
    # kernel 4: the host arrays of the ranks' pointers, then ints, the stream
    argt = lib.tp_allreduce.argtypes
    assert argt[:2] == [ctypes.POINTER(ctypes.c_void_p)] * 2 and argt[-1] is ctypes.c_void_p
    assert set(argt[2:-1]) == {ctypes.c_int} and lib.tp_allreduce.restype is ctypes.c_int
