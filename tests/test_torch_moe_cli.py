"""The port's entry points on Q80 and mixture-of-experts `.m` files, on the
CPU: greedy ``generate`` at f32 activations is byte-identical to
``python -m dllama_tpu generate`` (tiny Mixtral in Q40 and Q80, tiny
Llama in Q80), and the API server answers greedy completions on tiny
Mixtral Q80 through 2 slots and a paged pool with the text of the batch-1
path (a server without slots)."""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

from dllama_tpu import quants
from dllama_tpu.io import mfile
from fixtures import REPO, run_cli, write_tiny_model, write_tiny_tokenizer

MODELS = {"mixtral-q40": (mfile.ARCH_MIXTRAL, quants.Q40, 4),
          "mixtral-q80": (mfile.ARCH_MIXTRAL, quants.Q80, 4),
          "llama-q80": (mfile.ARCH_LLAMA, quants.Q80, 0)}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_moe_cli")
    t = d / "tiny.t"
    write_tiny_tokenizer(t)
    paths = {}
    for name, (arch, ftype, n_experts) in MODELS.items():
        paths[name] = str(d / f"{name}.m")
        write_tiny_model(paths[name], arch=arch, ftype=ftype, n_experts=n_experts)
    return paths, str(t)


def run_port(args, timeout=120) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.run([sys.executable, "-m", "dllama_tpu_torch", *args], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=timeout)


def _text(stdout: str) -> list[str]:
    """Output lines other than the 💡 banner/summary lines."""
    return [ln for ln in stdout.splitlines() if not ln.startswith("💡")]


@pytest.mark.parametrize("name", list(MODELS))
def test_greedy_generate_byte_identical_to_jax(files, name):
    paths, t = files
    args = ["generate", "--model", paths[name], "--tokenizer", t, "--prompt", "hello",
            "--steps", "24", "--temperature", "0", "--buffer-float-type", "f32"]
    port = run_port(args + ["--device", "cpu"])
    assert port.returncode == 0, port.stderr[-2000:]
    ref = run_cli(args)
    assert ref.returncode == 0, ref.stderr[-2000:]
    assert _text(port.stdout) == _text(ref.stdout)
    assert len(_text(port.stdout)[0]) > len("<s>hello")
    codec = "q8" if name.endswith("q80") else "q40"
    last = port.stdout.splitlines()[-1]
    assert last.startswith(f"💡 {codec} launches: kernel=0 plain=") and last.endswith("device=cpu")


def _post(base: str, body: dict) -> tuple[int, str]:
    req = urllib.request.Request(base + "/v1/completions", json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())["choices"][0]["text"]


def test_server_greedy_completions_through_slots(files):
    """Two concurrent greedy completions ride the slot scheduler (2 slots,
    a 40-page pool) and answer what the batch-1 path answers."""
    from dllama_tpu_torch.server import api
    paths, t = files
    base_args = ["--model", paths["mixtral-q80"], "--tokenizer", t, "--device", "cpu",
                 "--temperature", "0", "--buffer-float-type", "f32",
                 "--host", "127.0.0.1", "--port", "0"]
    bodies = [{"prompt": p, "max_tokens": 12, "temperature": 0} for p in ("hello", "hi hello")]
    answers = {}
    for mode, extra in (("slots", ["--batch-slots", "2", "--kv-pages", "40",
                                   "--kv-page-size", "4"]), ("batch-1", [])):
        srv = api.start(base_args + extra)
        try:
            base = f"http://127.0.0.1:{srv.server_address[1]}"
            out = [None, None]
            threads = [threading.Thread(target=lambda i=i: out.__setitem__(i, _post(base, b)))
                       for i, b in enumerate(bodies)]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            assert [code for code, _ in out] == [200, 200]
            answers[mode] = [text for _, text in out]
            # a handler records its request after the response has gone out,
            # so the client can read both answers before both records land
            t_end = time.monotonic() + 10
            while len(srv.state.finished) < 2 and time.monotonic() < t_end:
                time.sleep(0.01)
            on_sched = [r["scheduler"] for r in list(srv.state.finished)[-2:]]
            assert on_sched == [mode == "slots"] * 2
        finally:
            api.stop(srv)
    assert answers["slots"] == answers["batch-1"] and all(answers["slots"])
