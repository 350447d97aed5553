"""The port's CLI (python -m dllama_tpu_torch) driven end to end on the CPU,
against the JAX package's CLI, plus the port's isolation from JAX: it
imports neither ``jax`` nor anything of ``dllama_tpu``."""

import os
import re
import subprocess
import sys

import pytest
import torch

from dllama_tpu import quants
from fixtures import REPO, cpu_env, run_cli, write_tiny_model, write_tiny_tokenizer

PORT = os.path.join(REPO, "dllama_tpu_torch")


@pytest.fixture(scope="module")
def model_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli")
    m, t = d / "tiny.m", d / "tiny.t"
    write_tiny_model(m, ftype=quants.Q40)
    write_tiny_tokenizer(t)
    return str(m), str(t)


def run_port(args, timeout=120) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.run([sys.executable, "-m", "dllama_tpu_torch", *args], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=timeout)


def _text(stdout: str) -> list[str]:
    """Output lines other than the 💡 banner/summary lines."""
    return [ln for ln in stdout.splitlines() if not ln.startswith("💡")]


def test_greedy_generate_byte_identical_to_jax(model_files):
    m, t = model_files
    args = ["generate", "--model", m, "--tokenizer", t, "--prompt", "hello",
            "--steps", "24", "--temperature", "0", "--buffer-float-type", "f32"]
    port = run_port(args + ["--device", "cpu"])
    assert port.returncode == 0, port.stderr[-2000:]
    ref = run_cli(args)
    assert ref.returncode == 0, ref.stderr[-2000:]
    assert _text(port.stdout) == _text(ref.stdout)
    assert len(_text(port.stdout)[0]) > len("<s>hello")
    # 24 steps = 2 prompt tokens + 22 generated: 1 prefill + 21 decode forwards,
    # each 2 layers x (wqkv, wo, w13, w2) + wcls = 9 plain matmuls on the CPU
    assert port.stdout.splitlines()[-1] == (
        "💡 q40 launches: kernel=0 plain=198 dense_prefill=0 forwards=22 "
        "kernel_per_forward=0 device=cpu")


def test_inference_prints_stats(model_files):
    m, t = model_files
    r = run_port(["inference", "--model", m, "--tokenizer", t, "--prompt", "hello",
                  "--steps", "8", "--temperature", "0", "--warmup", "4",
                  "--chunk", "4", "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-2000:]
    out = r.stdout
    assert out.count("🔶 G") == 10  # 2 prompt tokens + 8 generated
    for line in ("Generated tokens:    8", "Avg tokens / second:",
                 "Avg generation time:", "Avg inference time:",
                 "Avg transfer time:", "Avg sent / recv:", "💡 warmup: 4 tokens"):
        assert line in out
    assert out.splitlines()[-1].startswith("💡 q40 launches: kernel=0 ")


@pytest.mark.parametrize("extra,named", [
    (["chat"], "mode 'chat'"),
    (["generate", "--workers", "tpu:2"], "--workers"),
    (["generate", "--pld", "4", "--sp", "2"], "--sp, --pld"),
    (["generate", "--kv-cache-dtype", "q8"], "--kv-cache-dtype q8"),
])
def test_unported_flags_exit_naming_them(model_files, extra, named):
    m, t = model_files
    r = run_port(extra + ["--model", m, "--tokenizer", t, "--device", "cpu"])
    assert r.returncode != 0
    assert "not yet ported" in r.stderr and named in r.stderr


def test_cuda_request_without_cuda_fails(model_files):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    m, t = model_files
    r = run_port(["generate", "--model", m, "--tokenizer", t, "--prompt", "hi"])
    assert r.returncode != 0
    assert "torch.cuda.is_available() is False" in r.stderr


def test_port_never_imports_jax_or_dllama_tpu(model_files):
    """Import every module of the port, run its CLI, then look at
    sys.modules: no jax, no dllama_tpu."""
    m, t = model_files
    code = f"""
import importlib, pkgutil, sys
import dllama_tpu_torch
for mod in pkgutil.walk_packages(dllama_tpu_torch.__path__, "dllama_tpu_torch."):
    if not mod.name.endswith("__main__"):
        importlib.import_module(mod.name)
from dllama_tpu_torch import cli
cli.main(["generate", "--model", {m!r}, "--tokenizer", {t!r}, "--prompt", "hello",
          "--steps", "6", "--temperature", "0", "--device", "cpu"])
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "dllama_tpu"))
print("FOREIGN", bad)
"""
    env = cpu_env()
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.splitlines()[-1] == "FOREIGN []"


_FOREIGN_IMPORT = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|dllama_tpu)(?:\.|\s|$)", re.M)


def test_static_scan_finds_no_foreign_imports():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    hits = []
    for f in files:
        with open(f, encoding="utf-8") as fh:
            hits += [f"{f}: {m.group(0).strip()}" for m in _FOREIGN_IMPORT.finditer(fh.read())]
    assert hits == []
