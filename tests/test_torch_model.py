"""The port's model and engine (dllama_tpu_torch.models / .runtime) against
the JAX package's and the numpy oracle (tests/reference_impl.py).

Tolerances, relative to max|logits|:
* f32 model, packed Q40 weights: the matmuls multiply the same bf16
  operands in both packages and differ only in f32 summation order; other
  ops differ by f32 ulps — 1e-4.
* bf16 model: every matmul output and residual add rounds to bf16, so a
  last-bit difference before a cast becomes a bf16 ulp (2^-8) and travels
  through two layers — 3e-2.
* dense f32 model against the f64-normed numpy oracle — 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu import quants
from dllama_tpu.io import mfile as jmfile
from dllama_tpu.models import config as jconfig, params as jparams, transformer as jtr
from dllama_tpu.ops import q8 as jq8, q40 as jq40
from dllama_tpu_torch.io import mfile as tmfile
from dllama_tpu_torch.models import config as tconfig, params as tparams, transformer as ttr
from dllama_tpu_torch.runtime.engine import Engine
from dllama_tpu_torch.sampling import Sampler
from fixtures import write_tiny_model
from reference_impl import np_forward

TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _jax_arrays(params) -> dict:
    """JAX params → numpy, packed weights as (qpacked, scale bits, nd)."""
    out = {}
    for k, v in params.items():
        if isinstance(v, jq40.QTensor):
            out[k] = (np.asarray(v.qpacked), np.asarray(v.scales), v.logical_nd)
        else:
            out[k] = np.asarray(v)
    return out


def _configs(dtype):
    kw = dict(dim=64, hidden_dim=96, n_layers=2, n_heads=4, n_kv_heads=2,
              vocab_size=128, seq_len=64)
    return (jconfig.tiny_config(dtype=_JDT[dtype], **kw),
            tconfig.tiny_config(dtype=dtype, **kw))


def _close(t, j, tol):
    t = t.to(torch.float32).numpy()
    j = np.asarray(j, np.float32)
    np.testing.assert_allclose(t, j, rtol=0, atol=tol * np.abs(j).max())


@pytest.fixture(scope="module")
def q40_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("tq40") / "tiny.m"
    write_tiny_model(path, ftype=quants.Q40, vocab_size=128, seq_len=64)
    return str(path)


def _same_params(tp, jp):
    """Every leaf equal bit for bit; packed weights of the same codec."""
    assert set(tp) == set(jp)
    for k, jv in jp.items():
        tv = tp[k]
        if isinstance(jv, (jq40.QTensor, jq8.Q8Tensor)):
            assert type(tv).__name__ == type(jv).__name__, k
            assert tv.logical_nd == jv.logical_nd
            np.testing.assert_array_equal(tv.qpacked.numpy(), np.asarray(jv.qpacked))
            np.testing.assert_array_equal(tv.scales.numpy().view(np.uint16),
                                          np.asarray(jv.scales))
        else:
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _load_both(path):
    jcfg, jp = jparams.load_params(jmfile.MFile(str(path)), keep_quantized=True)
    with tmfile.MFile(str(path)) as mf:
        tcfg, tp = tparams.load_params(mf)
    return jp, tp


def test_load_params_matches_jax(q40_file):
    jp, tp = _load_both(q40_file)
    _same_params(tp, jp)


def test_load_params_q80_matches_jax(tmp_path):
    """A Q80 file keeps its matmuls packed as int8 planes, fused like Q40's,
    bit-identical to the JAX package's ``keep_quantized=True`` load."""
    path = tmp_path / "q80.m"
    write_tiny_model(path, ftype=quants.Q80, vocab_size=128, seq_len=64)
    jp, tp = _load_both(path)
    _same_params(tp, jp)
    assert {k for k, v in tp.items() if not isinstance(v, torch.Tensor)} == \
        {"wqkv", "wo", "w13", "w2", "wcls"}
    assert tp["wqkv"].qpacked.dtype == torch.int8


@pytest.mark.parametrize("arch,ftype", [(jmfile.ARCH_MIXTRAL, quants.Q40),
                                        (jmfile.ARCH_MIXTRAL, quants.Q80),
                                        (jmfile.ARCH_GROK1, quants.Q40),
                                        (jmfile.ARCH_MIXTRAL, quants.F32)])
def test_load_moe_matches_jax(tmp_path, arch, ftype):
    """Tiny Mixtral/Grok-1 `.m` files: the router dense, the experts as
    (L, E, ...) planes (packed for Q40/Q80, dense for F32), Grok's extra
    norms; all equal to the JAX package's load."""
    path = tmp_path / "moe.m"
    write_tiny_model(path, arch=arch, ftype=ftype, n_experts=4, vocab_size=128,
                     seq_len=64)
    jp, tp = _load_both(path)
    _same_params(tp, jp)
    assert tp["up"].shape == (2, 4, 64, 96) and tp["router"].shape == (2, 64, 4)
    assert ("rms_moe" in tp) == (arch == jmfile.ARCH_GROK1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_matches_jax(dtype):
    """Same packed weights (from_jax_params): prefill of 7 tokens, then one
    decode step on the cache the prefill wrote."""
    jcfg, tcfg = _configs(dtype)
    jp = jparams.quantize_matmuls(jparams.init_params(jcfg, seed=3), jcfg)
    tp = tparams.from_jax_params(_jax_arrays(jp), tcfg)
    tokens = np.random.RandomState(4).randint(0, 128, (1, 8))
    jcache = jtr.init_kv_cache(jcfg, 1)
    tcache = ttr.init_kv_cache(tcfg, 1)
    jl, jcache = jtr.forward(jp, jcfg, jnp.asarray(tokens[:, :7]), jcache, jnp.int32(0))
    tl, tcache = ttr.forward(tp, tcfg, torch.from_numpy(tokens[:, :7]), tcache, 0)
    assert tl.dtype == torch.float32 and tl.shape == (1, 7, 128)
    _close(tl, jl, TOL[dtype])
    jl, _ = jtr.forward_last(jp, jcfg, jnp.asarray(tokens[:, 7:]), jcache,
                             jnp.int32(7), jnp.int32(0))
    tl, _ = ttr.forward_last(tp, tcfg, torch.from_numpy(tokens[:, 7:]), tcache, 7, 0)
    _close(tl, jl, TOL[dtype])


def test_dense_forward_matches_reference_impl():
    jcfg, tcfg = _configs(torch.float32)
    tp = tparams.init_params(tcfg, seed=5)
    tokens = np.random.RandomState(6).randint(0, 128, 9)
    ref = np_forward({k: v.numpy() for k, v in tp.items()}, jcfg, tokens)
    out, _ = ttr.forward(tp, tcfg, torch.from_numpy(tokens)[None],
                         ttr.init_kv_cache(tcfg, 1), 0)
    np.testing.assert_allclose(out[0].numpy(), ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


@pytest.fixture(scope="module")
def engine_params():
    _, tcfg = _configs(torch.float32)
    return tcfg, tparams.quantize_matmuls(tparams.init_params(tcfg, seed=7), tcfg)


def test_chunked_greedy_matches_stepwise(engine_params):
    """generate_stream's on-device chunks (sizes 4: pipelined dispatch
    across several chunks) give the host-sampler one-step loop's tokens."""
    cfg, p = engine_params
    prompt = [1, 5, 9, 2]
    a = [t for t, _ in Engine(cfg, p, device="cpu").generate_stream(
        prompt, 20, temperature=0.0, chunk=4)]
    b = [t for t, _ in Engine(cfg, p, device="cpu").generate(
        prompt, 20, Sampler(cfg.vocab_size, 0.0, 0.9, seed=0))]
    assert len(a) == 20 and a == b


def test_sampled_stream_repeats_and_eos_rewinds(engine_params):
    cfg, p = engine_params
    prompt = [1, 5, 9]
    runs = []
    for _ in range(2):
        eng = Engine(cfg, p, device="cpu")
        runs.append([t for t, _ in eng.generate_stream(
            prompt, 24, temperature=0.8, topp=0.9, seed=1, chunk=4)])
    assert runs[0] == runs[1] and len(runs[0]) == 24
    eos = runs[0][6]  # a token the stream emits mid-chunk
    first = runs[0].index(eos, len(prompt))
    eng = Engine(cfg, p, device="cpu")
    out = [t for t, _ in eng.generate_stream(prompt, 24, temperature=0.8,
                                             topp=0.9, seed=1, chunk=4,
                                             eos_ids=(eos,))]
    assert out == runs[0][:first + 1]
    # the chunk's overshoot is rewound: the cache holds everything before
    # the EOS token, which would be the next step's input
    assert eng.pos == first


def _q40_model(n_layers: int, seq_len: int):
    kw = dict(dim=64, hidden_dim=96, n_layers=n_layers, n_heads=4, n_kv_heads=2,
              vocab_size=128, seq_len=seq_len)
    jcfg = jconfig.tiny_config(dtype=jnp.float32, **kw)
    tcfg = tconfig.tiny_config(**kw)
    jp = jparams.quantize_matmuls(jparams.init_params(jcfg, seed=3), jcfg)
    return jcfg, jp, tcfg, tparams.from_jax_params(_jax_arrays(jp), tcfg)


@pytest.mark.parametrize("t", [127, 257])
def test_prefill_agrees_with_jax_to_a_bf16_ulp(t):
    """The widths where the 2-layer f32 Q40 model's logits differ most from
    the JAX package's (ROADMAP queue 3, fault 1), pinned.  Layer 0 differs
    from JAX only in f32 last bits: every f32 op of XLA's CPU backend (the
    mean of rmsnorm, rsqrt, the dots, RoPE's cos/sin, the softmax's exp)
    rounds its last bit otherwise than PyTorch's CPU kernels, and no order of
    operations reproduces XLA's own approximations.  Where such a bit sits on
    a bf16 rounding edge of a Q40 matmul's input (which the kernel contract
    rounds to bf16), it flips a bf16 ulp: inside layer 0 at 257 rows, at
    layer 1's input at both widths.  The logits stay within 1e-3 of max and
    the greedy token agrees."""
    prompt = np.random.RandomState(8).randint(3, 128, t)
    jcfg, jp, tcfg, tp = _q40_model(1, 512)
    jx, _ = jtr.run_blocks(jp, jcfg, jnp.asarray([prompt]), jtr.init_kv_cache(jcfg, 1),
                           jnp.int32(0))
    tx, _ = ttr.run_blocks(tp, tcfg, torch.from_numpy(prompt[None]),
                           ttr.init_kv_cache(tcfg, 1), 0)
    jx = np.asarray(jx)
    gap = np.abs(tx.numpy() - jx).max() / np.abs(jx).max()
    assert gap <= (2e-7 if t == 127 else 2e-5)
    jcfg, jp, tcfg, tp = _q40_model(2, 512)
    eng = Engine(tcfg, tp, device="cpu")
    logits, _ = eng.prefill(prompt.tolist())
    ref, _ = jtr.forward_last(jp, jcfg, jnp.asarray([prompt]), jtr.init_kv_cache(jcfg, 1),
                              jnp.int32(0), jnp.int32(t - 1))
    ref = np.asarray(ref)
    assert np.abs(logits - ref).max() <= 1e-3 * np.abs(ref).max()
    assert int(np.argmax(logits)) == int(np.argmax(ref))


def test_layer0_ops_agree_with_jax_to_the_last_bits():
    """Fault 1's cause, op by op: layer 0 of the f32 Q40 model at t = 127,
    each op of the port fed the JAX op's input (every JAX op jitted alone,
    as XLA compiles it): rmsnorm, the fused wqkv dot, RoPE's angles and
    rotation, attention, wo, rmsnorm, w13, act·mul and w2 each agree with
    JAX to a few f32 ulps of max (2.5e-7), while layer 0's output differs
    from JAX's in its last bits (the test above): no single op is at
    fault."""
    from dllama_tpu.ops import attention as ja, kernels as jk
    from dllama_tpu_torch.ops import attention as tatt, kernels as tk, q40 as tq40
    t, hq, hkv, dh = 127, 4, 2, 16
    jcfg, jp, tcfg, tp = _q40_model(1, 512)
    prompt = np.random.RandomState(8).randint(3, 128, t)

    def T(a):
        return torch.from_numpy(np.array(a))

    def agree(j, p):
        j, p = np.asarray(j, np.float32), p.numpy()
        assert np.abs(p - j).max() <= 2.5e-7 * np.abs(j).max()

    def mm(x, name):
        view = jq40.QLayerView(jp[name], jnp.int32(0))
        j = jax.jit(lambda a: jq40.mm(a, view, impl=jcfg.quant_impl))(x)
        agree(j, tq40.mm(T(x), tp[name], 0, impl=tcfg.quant_impl, out_dtype=torch.float32))
        return np.asarray(j)

    x = np.asarray(jp["embedding"])[prompt][None].astype(np.float32)
    xb = jax.jit(jk.rmsnorm)(x, jp["rms_att"][0])
    agree(xb, tk.rmsnorm(T(x), tp["rms_att"][0]))
    q, k, v = np.split(mm(xb, "wqkv"), [hq * dh, (hq + hkv) * dh], axis=-1)
    q = q.reshape(1, t, hq, dh)
    cos, sin = jk.rope_angles(jnp.arange(t), dh, jcfg.rope_theta)
    tcos, tsin = tk.rope_angles(torch.arange(t), dh, tcfg.rope_theta)
    agree(cos, tcos)
    agree(sin, tsin)
    rope = jax.jit(lambda a, c, s: jk.apply_rope(a, c, s, interleaved=True))
    agree(rope(q, cos, sin), tk.apply_rope(T(q), T(cos), T(sin), interleaved=True))
    q = rope(q, cos, sin)
    k = rope(k.reshape(1, t, hkv, dh), cos, sin)
    qq = np.asarray(q).transpose(0, 2, 1, 3)
    ck = np.zeros((1, hkv, 512, dh), np.float32)
    cv = ck.copy()
    ck[:, :, :t] = np.asarray(k).transpose(0, 2, 1, 3)
    cv[:, :, :t] = v.reshape(1, t, hkv, dh).transpose(0, 2, 1, 3)
    att = jax.jit(lambda a, b, c: ja.gqa_attention(a, b, c, 0, t))(qq, ck, cv)
    agree(att, tatt.gqa_attention(T(qq), T(ck), T(cv), 0, t))
    x2 = x + mm(np.asarray(att).transpose(0, 2, 1, 3).reshape(1, t, hq * dh), "wo")
    xb2 = jax.jit(jk.rmsnorm)(x2, jp["rms_ffn"][0])
    agree(xb2, tk.rmsnorm(T(x2), tp["rms_ffn"][0]))
    h1, h3 = np.split(mm(xb2, "w13"), 2, axis=-1)
    h = jax.jit(lambda a, b: jk.silu(a) * b)(h1, h3)
    agree(h, tk.silu(T(h1)) * T(h3))
    mm(np.asarray(h), "w2")
