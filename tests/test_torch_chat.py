"""The port's ``chat`` mode (python -m dllama_tpu_torch chat) on the CPU
against the JAX package's, greedy at f32: a system prompt and user turns
on stdin, the same assistant text byte for byte, and the context window
filling at the same turn.

The tiny model's chat-EOS logit row is scaled up (x1.6) so that greedy
replies end on the chat EOS after a token instead of running to the end of
the context: each turn is short and the next turn continues the cache.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from dllama_tpu import quants
from dllama_tpu.io import mfile
from fixtures import REPO, run_cli, write_tiny_tokenizer

STDIN = "Be terse.\nhi\nhello\n"


@pytest.fixture(scope="module")
def chat_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_chat")
    m, t = d / "chat.m", d / "chat.t"
    eos = write_tiny_tokenizer(t).chat_eos_id
    spec = mfile.ModelSpec(arch=mfile.ARCH_LLAMA, dim=64, hidden_dim=96, n_layers=2,
                           n_heads=4, n_kv_heads=2, vocab_size=300, seq_len=512,
                           hidden_act=mfile.ACT_SILU, rope_theta=10000.0,
                           weights_ftype=quants.Q40)
    rng = np.random.RandomState(0)
    with mfile.MFileWriter(m, spec) as w:
        for info in w.plan:
            a = (rng.randn(*info.shape) * 0.05).astype(np.float32)
            if info.name == "wcls":
                a[eos] *= 1.6
            w.write_tensor(info.name, a)
    return str(m), str(t)


def run_port(args, env, input_text) -> subprocess.CompletedProcess:
    full = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    full.update(env)
    return subprocess.run([sys.executable, "-m", "dllama_tpu_torch", *args], cwd=REPO,
                          env=full, input=input_text, capture_output=True, text=True,
                          timeout=180)


def _chat(stdout: str) -> list[str]:
    """The conversation: every line but the 💡 banner and counter lines."""
    return [ln for ln in stdout.splitlines() if not ln.startswith("💡")]


def _both(chat_files, extra, layout):
    m, t = chat_files
    args = ["chat", "--model", m, "--tokenizer", t, "--temperature", "0",
            "--buffer-float-type", "f32", *extra]
    env = {"DLLAMA_Q40_LAYOUT": layout}
    port = run_port(args + ["--device", "cpu"], env, STDIN)
    assert port.returncode == 0, port.stderr[-2000:]
    ref = run_cli(args, input_text=STDIN, env=env)
    assert ref.returncode == 0, ref.stderr[-2000:]
    return port.stdout, ref.stdout


@pytest.mark.parametrize("layout", ["", "blocked"])
def test_chat_two_turns_match_jax(chat_files, layout):
    port, ref = _both(chat_files, [], layout)
    assert _chat(port) == _chat(ref)
    lines = _chat(port)
    assert lines.count("🤖 Assistant") == 2
    replies = [lines[i + 1] for i, ln in enumerate(lines) if ln == "🤖 Assistant"]
    assert all(replies), replies
    assert "context window is full" not in port
    assert ("layout=blocked" in port.splitlines()[-1]) == (layout == "blocked")


def test_chat_context_full_at_the_same_turn(chat_files):
    """A context that holds the first turn but not the second: both
    packages answer once, then print the context-full line."""
    port, ref = _both(chat_files, ["--max-seq-len", "120"], "blocked")
    assert _chat(port) == _chat(ref)
    assert _chat(port).count("🤖 Assistant") == 1
    assert port.count("🚫 context window is full") == 1
