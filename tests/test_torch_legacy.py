"""Legacy-magic ``.m`` files, ``--weights-float-type`` and ``--dequantize``
in the port, against the JAX package.

* A legacy-magic file (``0xABCD00`` llama, ``0xABCD01`` grok1: the
  reference's older converters, a fixed 9-int header naming no weights
  float type) written here from a v2 file's tensor bytes reads in both
  packages to the same spec and the same tensors, given the weights' type;
  without it both refuse; a v2 header's own type wins over the argument.
* ``generate --weights-float-type q40`` on the legacy file and
  ``--dequantize`` (dense weights in the compute dtype, plain products) on
  the v2 file print the JAX CLI's greedy text, byte for byte, and the
  legacy file's text equals its v2 twin's; ``batch`` takes both flags;
  the API server on the legacy file with both flags answers its v2 twin's
  greedy completion.

Tolerance: none -- bit-equal tensors and greedy bytes (the tiny f32 runs'
margins are decisive).
"""

import json
import struct
import urllib.request

import numpy as np
import pytest

from dllama_tpu import quants
from dllama_tpu.io import mfile as jmfile
from dllama_tpu_torch.io import mfile as tmfile
from dllama_tpu_torch.io.integrity import ArtifactError
from fixtures import run_cli, write_tiny_model, write_tiny_tokenizer
from test_torch_cli import _text, run_port

SPEC_FIELDS = ("arch", "dim", "hidden_dim", "n_layers", "n_heads", "n_kv_heads", "n_experts",
               "n_active_experts", "vocab_size", "seq_len", "hidden_act", "rope_theta",
               "weights_ftype", "header_size")


def write_legacy(v2_path: str, path: str) -> None:
    """The legacy-magic twin of a v2 file: the arch as the magic, the 9-int
    header, then the v2 file's tensor bytes."""
    spec = jmfile.read_spec(v2_path)
    head = struct.pack("<10i", spec.arch, spec.dim, spec.hidden_dim, spec.n_layers,
                       spec.n_heads, spec.n_kv_heads, spec.n_experts, spec.n_active_experts,
                       spec.vocab_size, spec.seq_len)
    with open(v2_path, "rb") as f:
        f.seek(spec.header_size)
        body = f.read()
    with open(path, "wb") as f:
        f.write(head + body)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_legacy")
    m, t, lm = str(d / "tiny.m"), str(d / "tiny.t"), str(d / "legacy.m")
    write_tiny_model(m, ftype=quants.Q40)
    write_tiny_tokenizer(t)
    write_legacy(m, lm)
    return m, t, lm


@pytest.mark.parametrize("arch,ftype", [(jmfile.ARCH_LLAMA, quants.Q40),
                                        (jmfile.ARCH_LLAMA, quants.Q80),
                                        (jmfile.ARCH_GROK1, quants.Q40)],
                         ids=["llama-q40", "llama-q80", "grok1-q40"])
def test_legacy_file_reads_as_jax_reads_it(tmp_path, arch, ftype):
    """Both packages read the legacy file to one spec (the magic is the
    arch, rope_theta and the activation their defaults) and one set of
    tensors, which are the v2 twin's."""
    v2, legacy = str(tmp_path / "v2.m"), str(tmp_path / "legacy.m")
    write_tiny_model(v2, arch=arch, ftype=ftype, n_experts=4 if arch == jmfile.ARCH_GROK1 else 0)
    write_legacy(v2, legacy)
    jm = jmfile.MFile(legacy, weights_ftype=ftype)
    with tmfile.MFile(legacy, weights_ftype=ftype) as tm, tmfile.MFile(v2) as t2:
        for f in SPEC_FIELDS:
            assert getattr(tm.spec, f) == getattr(jm.spec, f), f
        assert tm.spec.header_size == 40 and tm.spec.arch == arch
        assert [(x.name, x.shape, x.offset - 40) for x in tm.plan] == [
            (x.name, x.shape, x.offset - t2.spec.header_size) for x in t2.plan]
        for info in tm.plan:
            got = tm.tensor(info.name)
            np.testing.assert_array_equal(got, jm.tensor(info.name))
            np.testing.assert_array_equal(got, t2.tensor(info.name))


def test_legacy_file_without_its_float_type_is_refused(files):
    """No weights float type, no read: both packages refuse, naming the
    field; a v2 header's own type wins over the caller's."""
    m, _, legacy = files
    with pytest.raises(ArtifactError, match="weights_ftype"):
        tmfile.read_spec(legacy)
    with pytest.raises(jmfile.ArtifactError, match="weights_ftype"):
        jmfile.read_spec(legacy)
    assert tmfile.read_spec(m, quants.F32).weights_ftype == quants.Q40
    assert jmfile.read_spec(m, quants.F32).weights_ftype == quants.Q40


@pytest.mark.parametrize("which", ["legacy", "dequantize"])
def test_generate_with_the_loading_flags_matches_jax(files, which):
    """``generate`` on the legacy file with ``--weights-float-type q40``,
    and on the v2 file with ``--dequantize``: the JAX CLI's greedy text,
    byte for byte.  The legacy file's text is its v2 twin's; the dense run
    launches no Q40 matmul (its products are plain)."""
    m, t, legacy = files
    extra = (["--model", legacy, "--weights-float-type", "q40"] if which == "legacy"
             else ["--model", m, "--dequantize"])
    args = ["generate", "--tokenizer", t, "--prompt", "hello", "--steps", "16",
            "--temperature", "0", "--buffer-float-type", "f32", *extra]
    port = run_port(args + ["--device", "cpu"])
    assert port.returncode == 0, port.stderr[-2000:]
    ref = run_cli(args)
    assert ref.returncode == 0, ref.stderr[-2000:]
    assert _text(port.stdout) == _text(ref.stdout)
    if which == "legacy":
        twin = run_port(["generate", "--tokenizer", t, "--prompt", "hello", "--steps", "16",
                         "--temperature", "0", "--buffer-float-type", "f32", "--model", m,
                         "--device", "cpu"])
        assert _text(twin.stdout) == _text(port.stdout)
    else:
        assert "plain=0 " in port.stdout.splitlines()[-1]


def test_batch_takes_both_flags_and_matches_jax(files, tmp_path):
    """``batch`` on the legacy file with both flags: the JAX CLI's streams."""
    _, t, legacy = files
    prompts = tmp_path / "p.txt"
    prompts.write_text("hello\nhi\n")
    args = ["batch", "--model", legacy, "--tokenizer", t, "--prompts-file", str(prompts),
            "--steps", "12", "--temperature", "0", "--buffer-float-type", "f32",
            "--weights-float-type", "q40", "--dequantize"]
    port = run_port(args + ["--device", "cpu"])
    assert port.returncode == 0, port.stderr[-2000:]
    ref = run_cli(args)
    assert ref.returncode == 0, ref.stderr[-2000:]
    keep = [ln for ln in _text(port.stdout) if not ln.startswith("Batched throughput")]
    want = [ln for ln in _text(ref.stdout) if not ln.startswith("Batched throughput")]
    assert keep == want and any(ln.startswith("▶ stream 1") for ln in keep)


def _complete(base: str) -> str:
    req = urllib.request.Request(base + "/v1/completions", json.dumps(
        {"prompt": "hello", "max_tokens": 10, "temperature": 0}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())["choices"][0]["text"]


def test_server_takes_both_flags(files):
    """The API server on the legacy file with ``--weights-float-type q40
    --dequantize`` (paged slots) answers the greedy completion of the
    server on its v2 twin with ``--dequantize``."""
    from dllama_tpu_torch.server import api
    m, t, legacy = files
    serve = ["--tokenizer", t, "--device", "cpu", "--buffer-float-type", "f32",
             "--batch-slots", "2", "--kv-pages", "40", "--kv-page-size", "4", "--port", "0",
             "--host", "127.0.0.1", "--dequantize"]
    texts = []
    for model in (["--model", legacy, "--weights-float-type", "q40"], ["--model", m]):
        server = api.start(model + serve)
        try:
            texts.append(_complete(f"http://127.0.0.1:{server.server_address[1]}"))
        finally:
            api.stop(server)
    assert texts[0] == texts[1] and texts[0]
