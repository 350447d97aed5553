"""The port's lockstep ragged batch (``Engine.prefill_ragged``,
``generate_batch``, ``python -m dllama_tpu_torch batch``) against the JAX
package's, on the same numpy inputs and weights.

Ragged attention differs from the JAX package's only in f32 summation
order (tolerance 1e-5 · max|ref|, as the other attention tests); logits
after a whole forward at f32 within 1e-4 · max|ref| (the forward tests'
bar); greedy tokens must be identical.
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
from dllama_tpu.models import config as jconfig, params as jparams
from dllama_tpu.ops import attention as jattn, q40 as jq40
from dllama_tpu.parallel.mesh import make_mesh
from dllama_tpu.runtime.engine import Engine as JEngine
from dllama_tpu_torch.models import config as tconfig, params as tparams
from dllama_tpu_torch.ops import attention as tattn
from dllama_tpu_torch.runtime.engine import Engine
from fixtures import REPO, run_cli, write_tiny_model, write_tiny_tokenizer

ATTN_TOL = 1e-5
LOGIT_TOL = 1e-4
PROMPTS = [[1, 5, 9, 2, 7, 3, 11], [1, 4], [1, 8, 6, 10]]


@pytest.mark.parametrize("t,s,pos", [(7, 64, 0), (300, 4096, 0), (1, 64, 40),
                                     (1, 4096, 3000)])
def test_ragged_attention_matches_jax(t, s, pos):
    """Per-row key floors ``start`` through every contiguous route: one-shot
    prefill, the blocked online-softmax prefill (g·t·s past the
    threshold), one-shot decode and the live-block decode walk (s = 4096)."""
    rng = np.random.RandomState(t + s)
    b, hq, hkv, dh, L = 3, 4, 2, 16, 2
    q = rng.randn(b, hq, t, dh).astype(np.float32)
    ck = rng.randn(L, b, hkv, s, dh).astype(np.float32)
    cv = rng.randn(L, b, hkv, s, dh).astype(np.float32)
    start = np.array([0, 3, 5], np.int32)
    ref = np.asarray(jattn.gqa_attention_at(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.int32(1), jnp.int32(pos),
        t, start=jnp.asarray(start)))
    out = tattn.gqa_attention_at(torch.from_numpy(q), torch.from_numpy(ck),
                                 torch.from_numpy(cv), 1, pos, t,
                                 start=torch.from_numpy(start)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATTN_TOL * np.abs(ref).max())


def _jax_arrays(params) -> dict:
    out = {}
    for k, v in params.items():
        if isinstance(v, jq40.QTensor):
            out[k] = (np.asarray(v.qpacked), np.asarray(v.scales), v.logical_nd)
        else:
            out[k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def models():
    kw = dict(dim=64, hidden_dim=96, n_layers=2, n_heads=4, n_kv_heads=2,
              vocab_size=128, seq_len=64)
    jcfg = jconfig.tiny_config(dtype=jnp.float32, **kw)
    tcfg = tconfig.tiny_config(**kw)
    jp = jparams.quantize_matmuls(jparams.init_params(jcfg, seed=3), jcfg)
    return jcfg, tcfg, jp, tparams.from_jax_params(_jax_arrays(jp), tcfg)


def _jax_engine(jcfg, jp, batch):
    return JEngine(jcfg, jp, mesh=make_mesh(tp=1, devices=jax.devices()[:1]), batch=batch)


def test_prefill_ragged_logits_match_jax(models):
    jcfg, tcfg, jp, tp = models
    ref, _ = _jax_engine(jcfg, jp, 3).prefill_ragged(PROMPTS)
    eng = Engine(tcfg, tp, device="cpu", batch=3)
    out, _ = eng.prefill_ragged(PROMPTS)
    assert out.shape == (3, 128) and eng.pos == 7
    np.testing.assert_allclose(out, ref, rtol=0, atol=LOGIT_TOL * np.abs(ref).max())
    with pytest.raises(ValueError, match="fresh batch"):
        eng.prefill_ragged(PROMPTS)


def test_generate_batch_greedy_matches_jax_and_single_streams(models):
    """Greedy lockstep batch at f32: token for token the JAX package's
    ``Engine.generate_batch``, and each row the single-stream run of its
    prompt (24 steps fit every row's share of the shared clock)."""
    jcfg, tcfg, jp, tp = models
    steps = 24
    ref = _jax_engine(jcfg, jp, 3).generate_batch(PROMPTS, steps, temperature=0.0,
                                                  chunk=5)
    outs = Engine(tcfg, tp, device="cpu", batch=3).generate_batch(
        PROMPTS, steps, temperature=0.0, chunk=5)
    assert outs == ref
    for p, row in zip(PROMPTS, outs):
        assert len(row) == steps
        solo = [t for t, _ in Engine(tcfg, tp, device="cpu").generate_stream(
            p, steps, temperature=0.0, chunk=5)]
        assert row == solo


def test_generate_batch_stream_yields_every_row_and_rewinds(models):
    """The stream core yields one (B,) row a step; a consumer that stops
    early gets the speculative chunk's random draws back, so a sampled
    batch run twice from one seed repeats."""
    _, tcfg, _, tp = models
    eng = Engine(tcfg, tp, device="cpu", batch=3)
    rows = list(eng.generate_batch_stream(PROMPTS, 10, temperature=0.0, chunk=4))
    assert len(rows) == 10 and all(r.shape == (3,) for r in rows)
    runs = []
    for _ in range(2):
        eng = Engine(tcfg, tp, device="cpu", batch=3)
        stream = eng.generate_batch_stream(PROMPTS, 20, temperature=0.9, seed=4, chunk=4)
        runs.append([next(stream).tolist() for _ in range(6)])
        state = eng._gen.get_state()
        stream.close()
        # a chunk is in flight past the consumed ones: closing returns its draws
        assert not torch.equal(eng._gen.get_state(), state)
    assert runs[0] == runs[1]


def run_port(args, env=None, input_text=None) -> subprocess.CompletedProcess:
    full = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    full.update(env or {})
    return subprocess.run([sys.executable, "-m", "dllama_tpu_torch", *args], cwd=REPO,
                          env=full, input=input_text, capture_output=True, text=True,
                          timeout=180)


def _streams(stdout: str) -> list[str]:
    """The batch output without the 💡/⚠️ lines and the wall-clock rate."""
    return [ln for ln in stdout.splitlines()
            if not ln.startswith(("💡", "⚠️", "Batched throughput"))]


@pytest.mark.parametrize("layout", ["", "blocked"])
def test_cli_batch_matches_jax(tmp_path, layout):
    """``batch --prompts-file`` on the CPU prints the same streams as ``python
    -m dllama_tpu batch`` (greedy, f32), row-major and blocked."""
    m, t, pf = tmp_path / "tiny.m", tmp_path / "tiny.t", tmp_path / "prompts.txt"
    write_tiny_model(m, ftype=quants.Q40)
    write_tiny_tokenizer(t)
    pf.write_text("hello\nhi hi hello hello\n\nhe\n")
    args = ["batch", "--model", str(m), "--tokenizer", str(t), "--prompts-file", str(pf),
            "--steps", "20", "--temperature", "0", "--buffer-float-type", "f32",
            "--chunk", "4"]
    env = {"DLLAMA_Q40_LAYOUT": layout}
    port = run_port(args + ["--device", "cpu"], env=env)
    assert port.returncode == 0, port.stderr[-2000:]
    ref = run_cli(args, env=env)
    assert ref.returncode == 0, ref.stderr[-2000:]
    assert _streams(port.stdout) == _streams(ref.stdout)
    assert [ln for ln in _streams(port.stdout) if ln.startswith("▶")] == \
        ["▶ stream 0", "▶ stream 1", "▶ stream 2"]
    last = port.stdout.splitlines()[-1]
    assert last.startswith("💡 q40 launches: kernel=0 ")
    assert ("layout=blocked" in last) == (layout == "blocked")
