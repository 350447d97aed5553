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

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu import quants
from dllama_tpu.io import mfile as jmfile
from dllama_tpu.models import config as jconfig, params as jparams, transformer as jtr
from dllama_tpu.ops import q40 as jq40
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


def test_load_params_matches_jax(q40_file):
    jcfg, jp = jparams.load_params(jmfile.MFile(q40_file), keep_quantized=True)
    with tmfile.MFile(q40_file) as mf:
        tcfg, tp = tparams.load_params(mf)
    assert set(tp) == set(jp)
    for k, jv in jp.items():
        tv = tp[k]
        if isinstance(jv, jq40.QTensor):
            assert tv.logical_nd == jv.logical_nd
            np.testing.assert_array_equal(tv.qpacked.numpy(), np.asarray(jv.qpacked))
            np.testing.assert_array_equal(tv.scales.numpy().view(np.uint16),
                                          np.asarray(jv.scales))
        else:
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_load_params_rejects_q80(tmp_path):
    path = tmp_path / "q80.m"
    write_tiny_model(path, ftype=quants.Q80, vocab_size=128, seq_len=64)
    with tmfile.MFile(path) as mf, pytest.raises(NotImplementedError, match="Q80"):
        tparams.load_params(mf)


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
