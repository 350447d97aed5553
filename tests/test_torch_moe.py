"""The port's mixture-of-experts models (Mixtral, Grok-1) against the JAX
package's, and dense MoE against the numpy oracle (tests/reference_impl.py).

Both packages get the same weights: the port packs them (Q40 or Q80, the
packing is bit-identical to the JAX package's, see test_torch_q8.py) and
the JAX side receives the same planes.  Tolerances, relative to max|out|:
* f32, ``moe_ffn`` and full forwards: both packages multiply the same
  operands (bf16 for packed weights, exact products in f32) and differ in
  f32 summation order and in f32 ulps of softmax/norm/activation — 1e-4;
* bf16 forwards: every matmul output and residual rounds to bf16, so a
  last-bit difference becomes a bf16 ulp (2^-8) and travels through two
  layers — 3e-2;
* dense f32 against the f64-normed numpy oracle — 1e-4.
The expert choice itself must agree exactly; tied router logits go to the
lower expert index in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.io import mfile as jmfile
from dllama_tpu.models import config as jconfig, params as jparams, transformer as jtr
from dllama_tpu.ops import q8 as jq8, q40 as jq40
from dllama_tpu.ops.kernels import softmax_f32
from dllama_tpu_torch.models import config as tconfig, params as tparams, transformer as ttr
from dllama_tpu_torch.ops import q8 as tq8, q40 as tq40
from dllama_tpu_torch.ops.kernels import top_k
from reference_impl import np_forward

TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
CODECS = {"q40": tq40, "q80": tq8}


def _configs(arch=jmfile.ARCH_MIXTRAL, dtype=torch.float32):
    kw = dict(dim=64, hidden_dim=96, n_layers=2, n_heads=4, n_kv_heads=2,
              n_experts=4, n_active_experts=2, vocab_size=128, seq_len=64,
              hidden_act=jmfile.ACT_GELU if arch == jmfile.ARCH_GROK1 else jmfile.ACT_SILU)
    return (jconfig.tiny_config(arch, dtype=_JDT[dtype], **kw),
            tconfig.tiny_config(arch, dtype=dtype, **kw))


def _to_jax(tp: dict) -> dict:
    """The port's params as the JAX package's: packed weights keep their
    bits (Q40 → QTensor, Q80 → Q8Tensor), dense ones their values."""
    out = {}
    for k, v in tp.items():
        if isinstance(v, (tq40.QTensor, tq8.Q8Tensor)):
            cls = jq8.Q8Tensor if isinstance(v, tq8.Q8Tensor) else jq40.QTensor
            out[k] = cls(jnp.asarray(v.qpacked.numpy()),
                         jnp.asarray(v.scales.numpy().view(np.uint16)), v.logical_nd)
        elif v.dtype == torch.bfloat16:
            out[k] = jnp.asarray(v.to(torch.float32).numpy(), jnp.bfloat16)
        else:
            out[k] = jnp.asarray(v.numpy())
    return out


def _params(tcfg, codec: str, seed: int):
    tp = tparams.init_params(tcfg, seed=seed)
    if codec != "dense":
        tp = tparams.quantize_matmuls(tp, tcfg, codec=CODECS[codec])
    return tp, _to_jax(tp)


def _jax_layer(jp: dict, layer: int) -> dict:
    """JAX ``moe_ffn``'s per-layer dict, as its ``run_blocks`` builds it:
    packed weights as a QLayerView at the layer, dense ones sliced."""
    return {k: jq40.QLayerView(v, jnp.int32(layer))
            if isinstance(v, (jq40.QTensor, jq8.Q8Tensor)) else v[layer]
            for k, v in jp.items() if k not in ("embedding", "rms_final", "wcls")}


def _close(t, j, tol):
    t = t.to(torch.float32).numpy()
    j = np.asarray(j, np.float32)
    np.testing.assert_allclose(t, j, rtol=0, atol=tol * np.abs(j).max())


@pytest.mark.parametrize("codec", ["dense", "q40", "q80"])
@pytest.mark.parametrize("n", [1, 3, 8])
def test_moe_ffn_matches_jax(n, codec):
    """n = 1, 3: the decode route (selected experts only; packed experts at
    their device-side flat index); n = 8: every expert, masked."""
    jcfg, tcfg = _configs()
    tp, jp = _params(tcfg, codec, seed=1)
    x = (np.random.RandomState(2).randn(n, tcfg.dim)).astype(np.float32)
    for layer in (0, 1):
        ref = jtr.moe_ffn(jnp.asarray(x), _jax_layer(jp, layer), jcfg)
        out = ttr.moe_ffn(torch.from_numpy(x), tp, layer, tcfg)
        assert out.shape == (n, tcfg.dim) and out.dtype == torch.float32
        _close(out, ref, TOL[torch.float32])


def test_moe_decode_route_reads_each_selected_expert_once():
    """The decode route launches 3 matmuls per (token, selected expert) and
    none of the other experts' (counted as plain calls on the CPU)."""
    _, tcfg = _configs()
    tp, _ = _params(tcfg, "q80", seed=3)
    x = torch.from_numpy(np.random.RandomState(4).randn(3, tcfg.dim).astype(np.float32))
    tq8.reset_counters()
    ttr.moe_ffn(x, tp, 1, tcfg)
    assert tq8.counters()["plain_calls"] == 3 * 3 * tcfg.n_active_experts
    tq8.reset_counters()
    ttr.moe_ffn(torch.cat([x, x, x]), tp, 1, tcfg)  # 9 tokens: every expert
    assert tq8.counters()["plain_calls"] == 3 * tcfg.n_experts


@pytest.mark.parametrize("codec", ["dense", "q80"])
@pytest.mark.parametrize("n", [1, 8])
@pytest.mark.parametrize("tie", ["all", "pair"])
def test_tied_router_logits_pick_the_lower_expert(tie, n, codec):
    """Equal router logits (a zero router: every expert ties; or two equal
    router columns above the rest) choose the lower expert index first, as
    jax.lax.top_k does, and the outputs agree with JAX's."""
    jcfg, tcfg = _configs()
    tp = tparams.init_params(tcfg, seed=5)
    router = tp["router"]
    if tie == "all":
        router.zero_()
    else:  # experts 1 and 3 tie and dominate; the top-2 is {1, 3} either way
        router[..., 3] = router[..., 1]
        router[..., 1] += 1.0
        router[..., 3] += 1.0
    if codec != "dense":
        tp = tparams.quantize_matmuls(tp, tcfg, codec=tq8)
    jp = _to_jax(tp)
    x = np.abs(np.random.RandomState(6).randn(n, tcfg.dim)).astype(np.float32)
    ref = jtr.moe_ffn(jnp.asarray(x), _jax_layer(jp, 0), jcfg)
    out = ttr.moe_ffn(torch.from_numpy(x), tp, 0, tcfg)
    _close(out, ref, TOL[torch.float32])
    probs = np.array(softmax_f32(jnp.asarray(x @ router[0].numpy())))
    want = [0, 1] if tie == "all" else [1, 3]
    assert np.asarray(jax.lax.top_k(jnp.asarray(probs), 2)[1]).tolist() == [want] * n
    assert top_k(torch.from_numpy(probs), 2)[1].tolist() == [want] * n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("codec", ["q40", "q80"])
@pytest.mark.parametrize("arch", [jmfile.ARCH_MIXTRAL, jmfile.ARCH_GROK1])
def test_forward_matches_jax(arch, codec, dtype):
    """Prefill of 7 tokens (the all-experts route), then one decode step
    (the selected-experts route) on the cache the prefill wrote.  In bf16
    a router near-tie can flip between two correct runs (seed 7 puts Grok
    Q80's experts 0 and 3 at 0.23720 and 0.23721 in layer 0 of the decode
    step); seed 11's top-2 margins stay above bf16's noise everywhere."""
    jcfg, tcfg = _configs(arch, dtype)
    tp, jp = _params(tcfg, codec, seed=11)
    tokens = np.random.RandomState(8).randint(0, 128, (1, 8))
    jcache, tcache = jtr.init_kv_cache(jcfg, 1), ttr.init_kv_cache(tcfg, 1)
    jl, jcache = jtr.forward(jp, jcfg, jnp.asarray(tokens[:, :7]), jcache, jnp.int32(0))
    tl, tcache = ttr.forward(tp, tcfg, torch.from_numpy(tokens[:, :7]), tcache, 0)
    assert tl.dtype == torch.float32 and tl.shape == (1, 7, 128)
    _close(tl, jl, TOL[dtype])
    jl, _ = jtr.forward_last(jp, jcfg, jnp.asarray(tokens[:, 7:]), jcache,
                             jnp.int32(7), jnp.int32(0))
    tl, _ = ttr.forward_last(tp, tcfg, torch.from_numpy(tokens[:, 7:]), tcache, 7, 0)
    _close(tl, jl, TOL[dtype])


@pytest.mark.parametrize("arch", [jmfile.ARCH_MIXTRAL, jmfile.ARCH_GROK1])
def test_dense_moe_forward_matches_reference_impl(arch):
    """Dense experts, f32, 9 tokens, against the numpy oracle (a third
    implementation: Grok's scales and post-block norms included)."""
    jcfg, tcfg = _configs(arch)
    tp = tparams.init_params(tcfg, seed=9)
    tokens = np.random.RandomState(10).randint(0, 128, 9)
    ref = np_forward({k: v.numpy() for k, v in tp.items()}, jcfg, tokens)
    out, _ = ttr.forward(tp, tcfg, torch.from_numpy(tokens)[None],
                         ttr.init_kv_cache(tcfg, 1), 0)
    np.testing.assert_allclose(out[0].numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_grok_config_constants():
    jcfg, tcfg = _configs(jmfile.ARCH_GROK1)
    assert (tcfg.embedding_scale, tcfg.logit_scale) == (jcfg.embedding_scale, jcfg.logit_scale)
    assert tcfg.post_block_norms and not tcfg.add_bos and not tcfg.rope_interleaved
    _, mix = _configs()
    assert (mix.embedding_scale, mix.logit_scale, mix.post_block_norms) == (1.0, 1.0, False)
    assert set(tparams.param_shapes(tcfg)) == set(jparams.param_shapes(jcfg))
    assert tparams.param_shapes(tcfg) == jparams.param_shapes(jcfg)
