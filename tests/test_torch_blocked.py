"""The port's tile-contiguous ("blocked") Q40 layout (dllama_tpu_torch.ops.q40
``BlockedQTensor``, ``DLLAMA_Q40_LAYOUT=blocked``) against the JAX
package's, on the same numpy inputs.

The blocked planes are a byte permutation of the row-major ones, so they
must be bit-identical to the JAX package's and unblock exactly.  The
matmul over blocked planes multiplies the same bf16 operands as the JAX
blocked Pallas kernel (run in interpret mode, as the JAX tests run it) and
differs only in f32 summation order: tolerance 1e-5 · max|ref|.  Greedy
streams at f32 must be token-identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.models import config as jconfig, params as jparams
from dllama_tpu.ops import q40 as jq40
from dllama_tpu.parallel.mesh import make_mesh
from dllama_tpu.runtime.engine import Engine as JEngine
from dllama_tpu_torch.io import mfile as tmfile
from dllama_tpu_torch.models import config as tconfig, params as tparams
from dllama_tpu_torch.ops import q8 as tq8, q40 as tq40
from dllama_tpu_torch.runtime.engine import Engine

MATMUL_TOL = 1e-5  # f32 summation order only (see module docstring)


def _packed_pair(seed, lead, n, d):
    """The same random Q40 weight packed by both packages."""
    rng = np.random.RandomState(seed)
    qvals = rng.randint(-8, 8, size=(*lead, n, d)).astype(np.int8)
    scales = (rng.rand(*lead, n // 32, d) * 0.02 + 1e-3).astype(np.float16)
    return jq40.pack_planes(qvals, scales), tq40.pack_planes(qvals, scales)


def _same_blocked(tb: tq40.BlockedQTensor, jb):
    assert (tb.logical_nd, tb.tiles, tb.lead_2d) == (jb.logical_nd, jb.tiles, jb.lead_2d)
    np.testing.assert_array_equal(tb.qpacked.numpy(), np.asarray(jb.qpacked))
    np.testing.assert_array_equal(tb.scales.numpy().view(np.uint16), np.asarray(jb.scales))


@pytest.mark.parametrize("lead,n,d,tiles,want", [
    ((3,), 1024, 320, (512, 128), (512, 128)),   # stacked; d not a td multiple
    ((), 1024, 320, (None, None), (512, 384)),   # 2-D wcls, default tiles: td clamps
    ((2,), 1056, 4100, (None, None), (512, 2048)),  # padded n, 3 column tiles
    ((2,), 96, 40, (None, None), (32, 128)),      # tiny: tn falls to 32
    ((2,), 64, 200, (256, 64), (64, 64)),         # tn down the divisor ladder
])
def test_to_blocked_bit_identical(lead, n, d, tiles, want):
    jqt, tqt = _packed_pair(0, lead, n, d)
    jb, tb = jq40.to_blocked(jqt, *tiles), tq40.to_blocked(tqt, *tiles)
    assert tb.tiles == want
    assert tb.shape == ((*lead, n, d) if lead else (n, d))
    _same_blocked(tb, jb)


@pytest.mark.parametrize("spec,want", [("256,128", (256, 128)), ("64,4096", (64, 384)),
                                       ("256", (512, 384)), ("a,b", (512, 384)),
                                       ("0,128", (512, 384))])
def test_block_tiles_env(monkeypatch, capsys, spec, want):
    """``DLLAMA_Q40_BLOCK_TILES`` is read at each conversion; a bad value
    warns once on stderr and keeps the default, as in the JAX package."""
    monkeypatch.setenv("DLLAMA_Q40_BLOCK_TILES", spec)
    monkeypatch.setattr(tq40, "_warned", set())
    jqt, tqt = _packed_pair(1, (2,), 1024, 320)
    tb = tq40.to_blocked(tqt)
    tq40.to_blocked(tqt)
    err = capsys.readouterr().err
    assert tb.tiles == want
    assert err.count("DLLAMA_Q40_BLOCK_TILES") == (1 if want == (512, 384) else 0)
    _same_blocked(tb, jq40.to_blocked(jqt))


@pytest.mark.parametrize("lead", [(), (3,)])
def test_unblock_roundtrips_exactly(lead):
    """``unblock`` restores the planes; the one-plane unblock restores each
    plane (a Python int or an int32 tensor index)."""
    _, tqt = _packed_pair(2, lead, 1056, 320)
    tb = tq40.to_blocked(tqt, 512, 128)
    back = tq40.unblock(tb)
    assert torch.equal(back.qpacked, tqt.qpacked) and torch.equal(back.scales, tqt.scales)
    for layer in ((None,) if not lead else (0, 2, torch.tensor(1, dtype=torch.int32))):
        one = tq40.unblock_plane(tb, layer)
        i = 0 if layer is None else int(layer)
        want_q = tqt.qpacked if not lead else tqt.qpacked[i]
        want_s = tqt.scales if not lead else tqt.scales[i]
        assert torch.equal(one.qpacked, want_q) and torch.equal(one.scales, want_s)
    with pytest.raises(ValueError, match="layer index" if not lead else "needs a layer"):
        tq40.unblock_plane(tb, 0 if not lead else None)


@pytest.mark.parametrize("t", [1, 5])
@pytest.mark.parametrize("lead,tiles", [((3,), (512, 128)), ((), (512, 128)),
                                        ((2,), (64, 64))])
def test_blocked_matmul_matches_pallas_interpret(t, lead, tiles):
    """The port's matmul over blocked planes (the plain route on the CPU)
    ≡ the JAX blocked Pallas kernel in interpret mode, at every layer."""
    n, d = 1024, 320
    jqt, tqt = _packed_pair(3, lead, n, d)
    jb, tb = jq40.to_blocked(jqt, *tiles), tq40.to_blocked(tqt, *tiles)
    x = np.random.RandomState(4).randn(t, n).astype(np.float32)
    tq40.reset_counters()
    for layer in (range(lead[0]) if lead else (None,)):
        jw = jb if layer is None else jq40.QLayerView(jb, jnp.int32(layer))
        ref = np.asarray(jq40.matmul(jnp.asarray(x), jw, impl="pallas_interpret"))
        out = tq40.matmul(torch.from_numpy(x), tb, layer=layer).numpy()
        assert out.shape == (t, d)
        np.testing.assert_allclose(out, ref, rtol=0, atol=MATMUL_TOL * np.abs(ref).max())
        # mm routes a blocked weight the same way
        np.testing.assert_array_equal(tq40.mm(torch.from_numpy(x), tb, layer).numpy(), out)
    c = tq40.counters()
    assert c["plain_calls"] == 2 * (lead[0] if lead else 1)
    assert c["kernel_launches"] == c["blocked_launches"] == 0


def test_blocked_kernel_wrapper_refuses_cpu_tensors():
    """Kernel 3's wrapper launches on CUDA tensors or raises; it has no CPU
    path to fall back to, and counts nothing when it raises."""
    _, tqt = _packed_pair(5, (2,), 64, 48)
    tb = tq40.to_blocked(tqt)
    tq40.reset_counters()
    with pytest.raises(ValueError, match="CUDA tensor"):
        tq40.q40_blocked_matmul(torch.ones(1, 64), tb.qpacked, tb.scales, (64, 48), 0)
    assert tq40.counters()["blocked_launches"] == 0


def _configs(**kw):
    kw = dict(dim=64, hidden_dim=96, n_layers=2, n_heads=4, n_kv_heads=2,
              vocab_size=128, seq_len=64, **kw)
    return jconfig.tiny_config(dtype=jnp.float32, **kw), tconfig.tiny_config(**kw)


def _jax_arrays(params) -> dict:
    """JAX params → numpy: row-major packed weights as (qpacked, scale
    bits, nd), blocked ones with their tiles and lead_2d."""
    out = {}
    for k, v in params.items():
        if isinstance(v, jq40.BlockedQTensor):
            out[k] = (np.asarray(v.qpacked), np.asarray(v.scales), v.logical_nd,
                      v.tiles, v.lead_2d)
        elif isinstance(v, jq40.QTensor):
            out[k] = (np.asarray(v.qpacked), np.asarray(v.scales), v.logical_nd)
        else:
            out[k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def quantized():
    jcfg, tcfg = _configs()
    jp = jparams.quantize_matmuls(jparams.init_params(jcfg, seed=3), jcfg)
    return jcfg, tcfg, jp, tparams.from_jax_params(_jax_arrays(jp), tcfg)


def test_from_jax_params_carries_blocked(quantized):
    """JAX ``blocked_params`` handed over as numpy equals the port's own
    conversion of the same row-major weights, byte for byte."""
    _, tcfg, jp, tp = quantized
    jb = jq40.blocked_params(jp)
    tb_from_jax = tparams.from_jax_params(_jax_arrays(jb), tcfg)
    tb_own = tq40.blocked_params(tp)
    for k in ("wqkv", "wo", "w13", "w2", "wcls"):
        assert isinstance(tb_from_jax[k], tq40.BlockedQTensor)
        _same_blocked(tb_own[k], jb[k])
        _same_blocked(tb_from_jax[k], jb[k])
    assert tb_own["wcls"].lead_2d and not tb_own["wqkv"].lead_2d


def test_engine_blocked_greedy_matches_jax_and_row_major(quantized, monkeypatch):
    """``DLLAMA_Q40_LAYOUT=blocked``: the port's Engine converts every Q40
    matmul weight; its greedy stream equals the JAX blocked engine's and
    the port's row-major engine's, token for token (f32)."""
    jcfg, tcfg, jp, tp = quantized
    prompt = [5, 9, 2, 7]
    rows = [t for t, _ in Engine(tcfg, tp, device="cpu").generate_stream(
        prompt, 20, temperature=0.0, chunk=4)]
    monkeypatch.setenv("DLLAMA_Q40_LAYOUT", "blocked")
    eng = Engine(tcfg, tp, device="cpu")
    assert {k for k, v in eng.params.items() if isinstance(v, tq40.BlockedQTensor)} == \
        {"wqkv", "wo", "w13", "w2", "wcls"}
    tq40.reset_counters()
    blocked = [t for t, _ in eng.generate_stream(prompt, 20, temperature=0.0, chunk=4)]
    assert tq40.counters()["plain_calls"] == 9 * eng.forwards
    je = JEngine(jcfg, jp, mesh=make_mesh(tp=1, devices=jax.devices()[:1]))
    assert isinstance(je.params["wqkv"], jq40.BlockedQTensor)
    ref = [t for t, _ in je.generate_stream(prompt, 20, temperature=0.0, chunk=4)]
    assert blocked == ref == rows
    assert len(blocked) == 20


def test_second_engine_shares_blocked_params(quantized, monkeypatch):
    """A slot engine built from a blocked engine's params (the API server's
    way) neither converts them again nor copies them."""
    _, tcfg, _, tp = quantized
    monkeypatch.setenv("DLLAMA_Q40_LAYOUT", "blocked")
    e1 = Engine(tcfg, tp, device="cpu")
    e2 = Engine(tcfg, e1.params, device="cpu", batch=2, kv_pages=8, kv_page_size=16)
    for k, v in e1.params.items():
        w = e2.params[k]
        assert type(w) is type(v), k
        if isinstance(v, torch.Tensor):
            assert w is v, k
        else:  # the same storage, not a converted or copied one
            assert w.qpacked.data_ptr() == v.qpacked.data_ptr(), k
            assert w.scales.data_ptr() == v.scales.data_ptr(), k


def test_q80_and_expert_stacks_stay_row_major():
    """``blocked_params`` converts 2-D and 3-D Q40 weights only: Q80
    weights, 4-D expert stacks and dense tensors pass unchanged."""
    tcfg = tconfig.tiny_config(tmfile.ARCH_MIXTRAL, n_experts=4, n_active_experts=2)
    dense = tparams.init_params(tcfg, seed=4)
    for codec in (tq40, tq8):
        p = tparams.quantize_matmuls(dense, tcfg, codec=codec)
        b = tq40.blocked_params(p)
        for k, v in p.items():
            if codec is tq40 and k in ("wqkv", "wo", "wcls"):
                assert isinstance(b[k], tq40.BlockedQTensor), k
            else:
                assert b[k] is v, k
        assert p["up"].qpacked.dim() == 4
