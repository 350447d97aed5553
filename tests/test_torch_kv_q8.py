"""The contiguous int8 KV cache of the port (``--kv-cache-dtype q8``:
``models.transformer.init_kv_cache(quant=True)``, ``update_cache_at``,
the dequantizing read of ``ops.attention.gqa_attention_at``) against the
JAX package's on the same numpy inputs and weights.

Tolerances: the codec (int8 values and f32 scales of the same step
window) is bit for bit; attention over the same int8 cache within
``ATTN_TOL`` = 1e-5 of max (f32 summation order, as the other attention
tests); logits of the f32 model within 1e-4 of max|logits|
(tests/test_torch_model.py's bar: the same bf16 operands in both
packages, f32 summation order apart); greedy tokens exactly.  The graph
bodies, run eagerly on the CPU, equal the eager decode loop bit for bit.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu import quants
from dllama_tpu.models import config as jconfig, params as jparams, transformer as jtr
from dllama_tpu.ops import attention as jattn, q40 as jq40
from dllama_tpu.parallel.mesh import make_mesh
from dllama_tpu.runtime.engine import Engine as JEngine
from dllama_tpu_torch.models import config as tconfig, params as tparams, transformer as ttr
from dllama_tpu_torch.ops import attention as tattn
from dllama_tpu_torch.runtime import graphs
from dllama_tpu_torch.runtime.engine import Engine
from fixtures import REPO, run_cli, write_tiny_model, write_tiny_tokenizer

ATTN_TOL = 1e-5
TOL = 1e-4
PROMPT = [1, 5, 9, 2, 7, 3, 11]


def _tiny(seq_len: int):
    kw = dict(dim=64, hidden_dim=96, n_layers=2, n_heads=4, n_kv_heads=2,
              vocab_size=128, seq_len=seq_len)
    jcfg = jconfig.tiny_config(dtype=jnp.float32, **kw)
    tcfg = tconfig.tiny_config(**kw)
    jp = jparams.quantize_matmuls(jparams.init_params(jcfg, seed=3), jcfg)
    arrays = {k: (np.asarray(v.qpacked), np.asarray(v.scales), v.logical_nd)
              if isinstance(v, jq40.QTensor) else np.asarray(v) for k, v in jp.items()}
    return jcfg, jp, tcfg, tparams.from_jax_params(arrays, tcfg)


@pytest.fixture(scope="module", params=[64, 4096], ids=["oneshot", "walk"])
def tiny(request):
    """seq_len 64 reads the whole cache in one shot; 4096 takes the
    length-aware decode walk, which dequantizes block by block."""
    return _tiny(request.param)


def _jax_engine(jcfg, jp, **kw):
    return JEngine(jcfg, jp, mesh=make_mesh(tp=1, devices=jax.devices()[:1]), **kw)


@pytest.mark.parametrize("t,pos", [(7, 0), (1, 7), (1, 30)])
def test_codec_matches_jax_bit_for_bit(t, pos):
    """init_kv_cache(quant) and update_cache_at write the same int8 values
    and f32 scales as the JAX package's, at a Python position and at a
    device position (the captured decode step's)."""
    jcfg, _, tcfg, _ = _tiny(64)
    rng = np.random.RandomState(t * 100 + pos)
    k = rng.randn(2, 2, t, 16).astype(np.float32)
    k[0, 1, 0] = 0.0  # an all-zero position keeps a zero scale
    v = rng.randn(2, 2, t, 16).astype(np.float32)
    jc = jtr.init_kv_cache(jcfg, 2, quant=True)
    jc = jtr.update_cache_at(jc, jnp.asarray(k), jnp.asarray(v), jnp.int32(1), jnp.int32(pos))
    for p in (pos, tattn.DevicePos(torch.tensor(pos), pos)):
        tc = ttr.init_kv_cache(tcfg, 2, quant=True)
        assert tc.quantized and tc.k.dtype == torch.int8
        assert tuple(tc.k_scale.shape) == tuple(jc.k_scale.shape)
        ttr.update_cache_at(tc, torch.from_numpy(k), torch.from_numpy(v), 1, p)
        for a, b in zip(tc, jc):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("t,s,pos", [(5, 64, 0), (1, 64, 40), (1, 4096, 3000)])
def test_dequantizing_read_matches_jax(t, s, pos):
    """gqa_attention_at with the scale planes: the one-shot read and the
    decode walk (s = 4096) against the JAX package's, ragged key floors
    included."""
    rng = np.random.RandomState(s + pos)
    b, hq, hkv, dh, L = 2, 4, 2, 16, 2
    q = rng.randn(b, hq, t, dh).astype(np.float32)
    kv = [rng.randn(L, b, hkv, s, dh).astype(np.float32) for _ in range(2)]
    q8 = [jattn.quantize_kv(jnp.asarray(x)) for x in kv]
    (ck, ks), (cv, vs) = q8
    start = np.array([0, 3], np.int32)
    ref = np.asarray(jattn.gqa_attention_at(
        jnp.asarray(q), ck, cv, jnp.int32(1), jnp.int32(pos), t,
        start=jnp.asarray(start), scales=(ks, vs)))
    th = [torch.from_numpy(np.array(a)) for a in (ck, cv, ks, vs)]
    out = tattn.gqa_attention_at(torch.from_numpy(q), th[0], th[1], 1, pos, t,
                                 start=torch.from_numpy(start),
                                 scales=(th[2], th[3])).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATTN_TOL * np.abs(ref).max())


def test_prefill_and_decode_logits_match_jax(tiny):
    """A batch-1 engine on the int8 cache: the prompt's logits and 6
    decode steps fed the JAX argmax, within 1e-4 of max; the caches hold
    the same int8 values."""
    jcfg, jp, tcfg, tp = tiny
    je = _jax_engine(jcfg, jp, kv_dtype="q8")
    te = Engine(tcfg, tp, device="cpu", kv_dtype="q8")
    assert je.cache.quantized and te.cache.quantized
    ref, _ = je.prefill(PROMPT)
    got, _ = te.prefill(PROMPT)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * np.abs(ref).max())
    for _ in range(6):
        tok = int(np.argmax(ref[0]))
        ref, _ = je.decode_one(tok)
        got, _ = te.decode_one(tok)
        np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * np.abs(ref).max())
    np.testing.assert_array_equal(te.cache.k.numpy(), np.asarray(je.cache.k))


def test_greedy_stream_and_lockstep_batch_match_jax(tiny):
    """Greedy tokens of a batch-1 stream and of a ragged lockstep batch on
    the int8 cache equal the JAX package's."""
    jcfg, jp, tcfg, tp = tiny
    je = _jax_engine(jcfg, jp, kv_dtype="q8")
    te = Engine(tcfg, tp, device="cpu", kv_dtype="q8")
    want = [t for t, _ in je.generate_stream(PROMPT, 24, temperature=0.0, chunk=4)]
    got = [t for t, _ in te.generate_stream(PROMPT, 24, temperature=0.0, chunk=4)]
    assert got == want
    prompts = [PROMPT, [1, 4], [1, 8, 6, 10]]
    jb = _jax_engine(jcfg, jp, kv_dtype="q8", batch=3)
    tb = Engine(tcfg, tp, device="cpu", kv_dtype="q8", batch=3)
    assert tb.generate_batch(prompts, 16, chunk=4) == jb.generate_batch(prompts, 16, chunk=4)


def test_graph_bodies_equal_the_eager_step(tiny):
    """The chunk body (the captured decode step) on an int8 cache, run
    eagerly on CPU buffers, gives the eager loop's tokens, logits and
    cache bit for bit, batch-1 and ragged."""
    _, _, tcfg, tp = tiny
    for batch, prompts in ((1, [PROMPT]), (2, [PROMPT, [1, 4]])):
        engines = []
        for body in (False, True):
            eng = Engine(tcfg, tp, device="cpu", kv_dtype="q8", batch=batch)
            if body:
                eng.graphs = graphs.DecodeGraphs(eng.device, capture=False)
            toks = [r.tolist() for r in eng.generate_batch_stream(prompts, 20, chunk=4)] \
                if batch > 1 else \
                [t for t, _ in eng.generate_stream(PROMPT, 20, temperature=0.0, chunk=4)]
            engines.append((eng, toks))
        (a, ta), (b, tb) = engines
        assert ta == tb and b.graphs.eager_steps > 0
        assert torch.equal(a.last_logits, b.last_logits)
        for x, y in zip(a.cache, b.cache):
            assert torch.equal(x, y)


def test_slot_engine_refuses_a_contiguous_int8_cache(tiny):
    """As in the JAX package: slot steps need a dense cache or an int8
    pool; the lockstep batch serves on the same engine."""
    _, _, tcfg, tp = tiny
    eng = Engine(tcfg, tp, device="cpu", kv_dtype="q8", batch=2)
    with pytest.raises(ValueError, match="slot serving needs"):
        eng.slot_step(np.array([[3], [4]], np.int32), np.zeros(2, np.int32),
                      np.ones(2, np.int32), temps_np=np.zeros(2, np.float32),
                      topps_np=np.full(2, 0.9, np.float32))


def test_cli_generate_q8_matches_jax(tmp_path):
    """``generate --kv-cache-dtype q8 --device cpu``: the same greedy text
    as ``python -m dllama_tpu generate --kv-cache-dtype q8``."""
    m, t = str(tmp_path / "tiny.m"), str(tmp_path / "tiny.t")
    write_tiny_model(m, ftype=quants.Q40)
    write_tiny_tokenizer(t)
    args = ["generate", "--model", m, "--tokenizer", t, "--prompt", "hello",
            "--steps", "24", "--temperature", "0", "--buffer-float-type", "f32",
            "--kv-cache-dtype", "q8"]
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    port = subprocess.run([sys.executable, "-m", "dllama_tpu_torch", *args, "--device", "cpu"],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    ref = run_cli(args)
    assert port.returncode == 0, port.stderr[-2000:]
    assert ref.returncode == 0, ref.stderr[-2000:]

    def text(out):
        return [ln for ln in out.splitlines() if not ln.startswith(("💡", "⚠️"))]

    assert text(port.stdout) == text(ref.stdout)
    assert len(text(port.stdout)[0]) > len("<s>hello")
