"""The port's checksum manifests (dllama_tpu_torch.io.integrity, MFile
``verify=True``, read_tfile) against the JAX package's, on the tiny Q40
and Q80 fixtures and the tokenizer.

* ``build_manifest`` equals JAX's, and ``write_manifest`` writes the same
  bytes: one sidecar format.
* A manifest written by either package verifies in the other, eagerly
  (``verify_file``) and lazily (``MFile(verify=True)`` reading every
  tensor, ``read_tfile``).
* A flipped byte raises ``ArtifactError`` with the same field and offset
  as JAX's: in the header (at open, always), in a tensor (on its first
  read under ``verify=True``), in the tokenizer; the counters move the
  same way.
* ``io.read_tensor=corrupt`` under ``verify=True`` names the tensor, as
  JAX's does.
* ``--verify-weights`` runs through the port's CLI on the CPU (and
  without a manifest it is refused before any weight is read).
"""

import json
import os
import shutil

import numpy as np
import pytest

from dllama_tpu import quants
from dllama_tpu.io import integrity as jintegrity, mfile as jmfile, tfile as jtfile
from dllama_tpu.runtime import faults as jfaults
from dllama_tpu_torch.io import integrity, mfile, tfile
from dllama_tpu_torch.io.integrity import ArtifactError
from dllama_tpu_torch.runtime import faults
from fixtures import write_tiny_model, write_tiny_tokenizer


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_integrity")
    out = {}
    for name, ftype in (("q40", quants.Q40), ("q80", quants.Q80)):
        out[name] = str(d / f"{name}.m")
        write_tiny_model(out[name], ftype=ftype, seed=3)
    out["tok"] = str(d / "tiny.t")
    write_tiny_tokenizer(out["tok"])
    return out


def _copy(src, dst, manifest_of=None):
    shutil.copy(src, dst)
    if manifest_of is not None:
        manifest_of.write_manifest(dst)
    return dst


def _flip(path, offset, xor=0x01):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ xor]))


@pytest.mark.parametrize("which", ["q40", "q80", "tok"])
def test_manifest_equals_jax(files, which, tmp_path):
    path = files[which]
    assert integrity.build_manifest(path) == jintegrity.build_manifest(path)
    a = integrity.write_manifest(path, str(tmp_path / "port.sum"))
    b = jintegrity.write_manifest(path, str(tmp_path / "jax.sum"))
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("which", ["q40", "q80"])
def test_manifests_verify_across_packages(files, tmp_path, writer, which):
    """A sidecar written by one package verifies in the other: every
    region eagerly, every tensor lazily, and the tokenizer whole."""
    w = integrity if writer == "port" else jintegrity
    m = _copy(files[which], str(tmp_path / "m.m"), w)
    t = _copy(files["tok"], str(tmp_path / "t.t"), w)
    n = len(integrity.load_manifest_for(m)["tensors"]) + 1
    assert integrity.verify_file(m) == jintegrity.verify_file(m) == n
    for mod in (mfile, jmfile):
        with mod.MFile(m, verify=True) as f:
            for info in f.plan:
                f.raw(info.name)
            assert len(f._verified) == n - 1
    assert tfile.read_tfile(t).vocab == jtfile.read_tfile(t).vocab


def _error(fn):
    with pytest.raises(ValueError) as ei:
        fn()
    e = ei.value
    return type(e).__name__, e.field, e.offset, e.expected, e.got


@pytest.mark.parametrize("where", ["header", "embedding", "wcls", "layer"])
def test_flipped_byte_raises_like_jax(files, tmp_path, where):
    m = _copy(files["q40"], str(tmp_path / "m.m"), integrity)
    man = integrity.load_manifest_for(m)
    if where == "header":
        off, name = 20, None
    else:
        name = {"embedding": "token_embedding", "wcls": "wcls",
                "layer": "layers.1.w2"}[where]
        ent = man["tensors"][name]
        off = ent["offset"] + ent["nbytes"] // 3
    _flip(m, off)

    def read(mod):
        def run():
            with mod.MFile(m, verify=True) as f:
                f.raw(name)
        return run

    integrity.reset_counters()
    jintegrity.reset_counters()
    got, want = _error(read(mfile)), _error(read(jmfile))
    assert got == want
    assert got[0] == "ArtifactError" and got[2] == (0 if name is None else man["tensors"][name]["offset"])
    assert integrity.counters() == jintegrity.counters()
    assert integrity.counters()["checksum_failures"] == 1
    # the eager check names the same region
    assert _error(lambda: integrity.verify_file(m)) == _error(lambda: jintegrity.verify_file(m))


def test_tokenizer_flip_raises_like_jax(files, tmp_path):
    t = _copy(files["tok"], str(tmp_path / "t.t"), integrity)
    _flip(t, os.path.getsize(t) - 5)
    assert _error(lambda: tfile.read_tfile(t)) == _error(lambda: jtfile.read_tfile(t))


def test_manifest_refusals_like_jax(files, tmp_path):
    """verify=True without a manifest, a corrupt manifest, a stale one
    (another file's tensor plan): each an ArtifactError of the same
    field in both packages."""
    m = _copy(files["q40"], str(tmp_path / "m.m"))
    assert _error(lambda: mfile.MFile(m, verify=True))[:2] == \
        _error(lambda: jmfile.MFile(m, verify=True))[:2] == ("ArtifactError", "manifest")
    mp = integrity.manifest_path_for(m)
    with open(mp, "w") as f:
        f.write("{not json")
    assert _error(lambda: mfile.MFile(m))[:2] == _error(lambda: jmfile.MFile(m))[:2]
    with open(mp, "w") as f:
        json.dump(dict(integrity.build_manifest(m), version=9), f)
    assert _error(lambda: mfile.MFile(m))[1:] == _error(lambda: jmfile.MFile(m))[1:]


def test_read_tensor_fault_names_the_tensor_like_jax(files, tmp_path):
    """``io.read_tensor=corrupt`` flips a byte of the returned buffer;
    under ``verify=True`` the checksum catches it, naming the tensor and
    its offset; the fault spent, the next read is clean."""
    m = _copy(files["q80"], str(tmp_path / "m.m"), integrity)
    got = {}
    for name, mod, fmod in (("port", mfile, faults), ("jax", jmfile, jfaults)):
        with fmod.injected("io.read_tensor=corrupt@2x1"):
            with mod.MFile(m, verify=True) as f:
                f.raw("token_embedding")
                f.raw("layers.0.wq")
                with pytest.raises(ValueError) as ei:
                    f.raw("layers.0.wk")
                got[name] = (type(ei.value).__name__, ei.value.field, ei.value.offset)
                assert np.array_equal(f.tensor("layers.0.wk"),
                                      jmfile.MFile(m).tensor("layers.0.wk"))
    assert got["port"] == got["jax"]
    assert got["port"][:2] == ("ArtifactError", "tensor 'layers.0.wk'")


def test_cli_verify_weights(files, tmp_path, capsys):
    """``--verify-weights`` through the port's CLI: a manifested model
    generates; without the sidecar the run is refused before any weight is
    read; a corrupt tensor is an ArtifactError naming it."""
    from dllama_tpu_torch import cli
    m = _copy(files["q40"], str(tmp_path / "m.m"))
    argv = ["generate", "--model", m, "--tokenizer", files["tok"], "--prompt", "hello",
            "--steps", "6", "--temperature", "0", "--device", "cpu", "--verify-weights"]
    with pytest.raises(ArtifactError, match="no checksum manifest"):
        cli.main(argv)
    integrity.write_manifest(m)
    integrity.reset_counters()
    plain = cli.main(argv[:-1])
    verified = cli.main(argv)
    assert verified.forwards == plain.forwards
    n_tensors = len(integrity.load_manifest_for(m)["tensors"])
    # the header at each open and every tensor once
    assert integrity.counters()["checksum_verified"] == 2 + n_tensors
    out = capsys.readouterr().out.splitlines()
    texts = [ln for ln in out if ln and not ln.startswith("💡")]
    assert len(texts) == 2 and texts[0] == texts[1]
    _flip(m, integrity.load_manifest_for(m)["tensors"]["layers.0.w3"]["offset"] + 7)
    with pytest.raises(ArtifactError, match="layers.0.w3"):
        cli.main(argv)


def test_module_cli_writes_and_verifies(files, tmp_path, capsys):
    m = _copy(files["q80"], str(tmp_path / "m.m"))
    assert integrity.main(["write", m]) == 0
    assert integrity.main(["verify", m]) == 0
    out = capsys.readouterr().out
    assert f"wrote {m}.sum" in out and "regions verified" in out
    assert jintegrity.verify_file(m) == len(integrity.load_manifest_for(m)["tensors"]) + 1
