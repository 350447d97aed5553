"""Batch-1 prompt-lookup decoding of the port (``Engine.generate_pld``,
``generate_pld_stream``, ``pld_windows``; ``--pld K``) against plain
greedy decode and the JAX package's ``generate_pld`` on the same weights
and prompts, on the CPU:

* every emitted token is an argmax at its position, so the stream equals
  ``generate_stream``'s greedy one byte for byte, and JAX's PLD stream,
  whatever is accepted (a repetitive prompt makes real acceptances);
* the window's graph body (``graphs.pld_step``, run eagerly) equals the
  eager window;
* the prompt echoes whole, EOS truncates as plain decode does, the tail
  that no longer fits a window runs single steps;
* the refusals (batch != 1, a paged engine, ``--pld`` sampled);
* the CLI's ``generate --pld`` text equals ``generate``'s and JAX's, and
  ``inference --pld`` reports its windows.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from dllama_tpu.models import config as jconfig, params as jparams
from dllama_tpu.runtime.engine import Engine as JEngine
from dllama_tpu_torch.models import config as tconfig, params as tparams
from dllama_tpu_torch.runtime import graphs
from dllama_tpu_torch.runtime.engine import Engine
from fixtures import REPO, run_cli, write_tiny_model, write_tiny_tokenizer

SEQ = 96
PROMPTS = [[5, 9, 2], [7, 3, 11, 4, 6, 1, 8], [2, 3, 4, 2, 3, 4, 2, 3, 4, 2, 3]]


@pytest.fixture(scope="module")
def weights():
    jcfg = jconfig.tiny_config(seq_len=SEQ)
    jp = jparams.init_params(jcfg, seed=4)
    tcfg = tconfig.tiny_config(seq_len=SEQ)
    return jcfg, jp, tcfg, tparams.from_jax_params({k: np.asarray(v) for k, v in jp.items()},
                                                   tcfg)


def _engine(weights, graphs_body=False, **kw):
    _, _, tcfg, tp = weights
    eng = Engine(tcfg, tp, device="cpu", **kw)
    if graphs_body:
        eng.graphs = graphs.DecodeGraphs(eng.device, capture=False)
    return eng


def _greedy(weights, prompt, steps, eos=()):
    return [t for t, _ in _engine(weights).generate_stream(prompt, steps, temperature=0.0,
                                                           chunk=8, eos_ids=eos)]


@pytest.mark.parametrize("graphs_body", [False, True], ids=["eager", "graph-body"])
@pytest.mark.parametrize("k,ngram", [(5, 2), (3, 3), (7, 1)])
def test_pld_equals_greedy_and_jax(weights, k, ngram, graphs_body):
    jcfg, jp, *_ = weights
    accepted = 0
    for prompt in PROMPTS:
        ref = _greedy(weights, prompt, 40)
        eng = _engine(weights, graphs_body)
        got = eng.generate_pld(prompt, 40, ngram=ngram, k=k)
        assert got == ref, (prompt, k, ngram)
        assert got == JEngine(jcfg, jp).generate_pld(prompt, 40, ngram=ngram, k=k)
        accepted += eng.pld_stats["accepted"]
        assert eng.pos == len(got) - 1  # the last token is not fed yet
    assert accepted > 0  # the repetitive prompt's windows accept drafts
    if graphs_body:
        assert eng.graphs.eager_steps >= eng.pld_stats["windows"] > 0


def test_pld_windows_stream_and_stats(weights):
    eng = _engine(weights)
    prompt = PROMPTS[2]
    eng.generate_pld(PROMPTS[0], 20, k=4)
    eng.reset()
    windows = list(eng.pld_windows(prompt, 40, k=4))  # the stats are this run's
    assert windows[0][0] == prompt and windows[0][1].generation_ms > 0
    flat = [t for toks, _ in windows for t in toks]
    assert flat == _greedy(weights, prompt, 40)
    s = eng.pld_stats
    assert s["windows"] == len(windows) - 2 and s["proposed"] == 4 * s["windows"]
    # a window emits its accepted drafts and one more token
    assert sum(len(toks) for toks, _ in windows[2:]) == s["accepted"] + s["windows"]
    assert all(st.generation_ms > 0 for _, st in windows[2:])


def test_pld_echo_eos_and_tail(weights):
    prompt = [5, 9, 2, 7, 1]
    assert _engine(weights).generate_pld(prompt, 3) == prompt
    ref = _greedy(weights, [5, 9, 2], 40)
    eos = ref[10]
    want = _greedy(weights, [5, 9, 2], 40, eos=(eos,))
    got = _engine(weights).generate_pld([5, 9, 2], 40, k=5, eos_ids=(eos,))
    assert got == want and got[-1] == eos
    # the last positions do not fit a window of k + 1: single steps finish
    full = _greedy(weights, [5, 9, 2], SEQ)
    assert _engine(weights).generate_pld([5, 9, 2], SEQ, k=7) == full
    assert len(full) == SEQ


def test_pld_refusals(weights):
    with pytest.raises(ValueError, match="batch=1"):
        _engine(weights, batch=2).generate_pld([1, 2], 8)
    with pytest.raises(ValueError, match="paged"):
        _engine(weights, kv_pages=30, kv_page_size=4).generate_pld([1, 2], 8)


@pytest.fixture(scope="module")
def model_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("pld")
    m, t = str(d / "tiny.m"), str(d / "tiny.t")
    write_tiny_model(m)
    write_tiny_tokenizer(t)
    return m, t


def _port(args):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.run([sys.executable, "-m", "dllama_tpu_torch", *args], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=180)


def _text(stdout):
    return [ln for ln in stdout.splitlines() if not ln.startswith(("💡", "⚠"))]


def test_cli_generate_pld_equals_generate_and_jax(model_files):
    m, t = model_files
    base = ["generate", "--model", m, "--tokenizer", t, "--prompt", "hello hello hello",
            "--steps", "40", "--temperature", "0", "--buffer-float-type", "f32"]
    plain = _port(base + ["--device", "cpu"])
    pld = _port(base + ["--device", "cpu", "--pld", "4"])
    ref = run_cli(base + ["--pld", "4"])
    for r in (plain, pld, ref):
        assert r.returncode == 0, r.stderr[-2000:]
    assert _text(pld.stdout) == _text(plain.stdout) == _text(ref.stdout)


def test_cli_inference_pld_reports_windows_and_refuses_sampling(model_files):
    m, t = model_files
    base = ["inference", "--model", m, "--tokenizer", t, "--prompt", "hello hello",
            "--steps", "12", "--device", "cpu"]
    r = _port(base + ["--temperature", "0", "--pld", "3"])
    assert r.returncode == 0, r.stderr[-2000:]
    out = r.stdout
    assert "Generated tokens:" in out and "Avg tokens / second:" in out
    line = [ln for ln in out.splitlines() if ln.startswith("💡 pld:")]
    assert len(line) == 1 and "verify windows of k=3" in line[0]
    plain = _port(base + ["--temperature", "0"])
    pieces = [ln.split("|", 1)[1] for ln in out.splitlines() if ln.startswith("🔶")]
    want = [ln.split("|", 1)[1] for ln in plain.stdout.splitlines() if ln.startswith("🔶")]
    assert pieces == want
    bad = _port(base + ["--temperature", "0.8", "--pld", "3"])
    assert bad.returncode != 0 and "--pld is greedy-only" in bad.stderr
