"""The port's DLSNAP02 snapshots (runtime.snapshot, Engine.snapshot and
restore, SlotScheduler.snapshot_paged and restore_paged, the server's warm
boot) against the JAX package's, on the tiny f32 model with the same
weights (tests/test_snapshot.py's scenarios).

* Round trips: a restored engine continues token for token, the sampled
  cross-turn stream included, on the contiguous bf16/f32 cache, the
  contiguous int8 cache and the paged pool with its radix tree.
* Refusals: a corrupt, truncated or superseded (DLSNAP01) file, another
  fingerprint, a position past the context, a missing cache array, another
  pool geometry; the engine is untouched by a refused restore.
* Interchange: a file the JAX package's ``snapshot.save`` wrote loads in
  the port with equal bytes (bf16 too), and the reverse; the port's
  ``config_fingerprint`` and ``handoff_fingerprint`` equal JAX's for the
  same model, batch, context and pool (the dtype names, not
  ``str(torch.dtype)``); a JAX engine snapshot restores into the port's
  engine (and the reverse) with the same cache bytes.
* bf16 without ml_dtypes: a subprocess that blocks ml_dtypes round-trips a
  bf16 pool.
"""

import os
import subprocess
import sys

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from dllama_tpu.models import config as jconfig, params as jparams
from dllama_tpu.parallel.mesh import make_mesh as jmake_mesh
from dllama_tpu.runtime import snapshot as jsnap
from dllama_tpu.runtime.engine import Engine as JEngine
from dllama_tpu_torch.io.integrity import ArtifactError, counters, reset_counters
from dllama_tpu_torch.models import config as tconfig, params as tparams
from dllama_tpu_torch.obs import metrics as obs_metrics
from dllama_tpu_torch.runtime import snapshot as snapfmt
from dllama_tpu_torch.runtime.engine import Engine
from dllama_tpu_torch.runtime.scheduler import SlotScheduler
from dllama_tpu_torch.runtime.snapshot import SnapshotMismatch
from fixtures import cpu_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ = 64


@pytest.fixture(scope="module")
def weights():
    jcfg = jconfig.tiny_config(seq_len=SEQ)
    jp = jparams.init_params(jcfg, seed=4)
    tcfg = tconfig.tiny_config(seq_len=SEQ)
    return jcfg, jp, tcfg, tparams.from_jax_params(
        {k: np.asarray(v) for k, v in jp.items()}, tcfg)


def make_engine(weights, seq_len=SEQ, **kw):
    _, _, tcfg, tp = weights
    if kw.get("kv_dtype") == "f16":
        kw["kv_dtype"] = torch.float16
    return Engine(tcfg.with_(seq_len=seq_len) if seq_len != SEQ else tcfg, tp,
                  device="cpu", **kw)


def make_jax_engine(weights, **kw):
    jcfg, jp, _, _ = weights
    if kw.get("kv_dtype") == "f16":
        kw["kv_dtype"] = jax.numpy.float16
    return JEngine(jcfg, jp, mesh=jmake_mesh(tp=1, devices=jax.devices()[:1]), **kw)


def turn(eng, prompt, seed, n=10):
    """One sampled chat turn; ``seed=None`` continues the generator."""
    return [t for t, _ in eng.generate_stream(prompt, n, temperature=0.8, seed=seed,
                                              chunk=4)]


def test_roundtrip_token_identical(weights, tmp_path):
    """A restored engine continues the conversation token for token, the
    sampled stream across turns included."""
    path = str(tmp_path / "engine.snap")
    e1 = make_engine(weights)
    turn(e1, [3, 4, 1], seed=7)
    e1.snapshot(path, extra={"note": "turn-1"})
    pos = e1.pos
    uninterrupted = turn(e1, [8, 2], seed=None)
    e2 = make_engine(weights)
    assert e2.restore(path)["note"] == "turn-1"
    assert e2.pos == pos
    assert turn(e2, [8, 2], seed=None) == uninterrupted


def test_roundtrip_quantized_cache(weights, tmp_path):
    """The contiguous int8 cache snapshots its four planes (values and
    scales) and restores token for token."""
    path = str(tmp_path / "q8.snap")
    e1 = make_engine(weights, kv_dtype="q8")
    assert e1.cache.quantized
    turn(e1, [5, 9, 2], seed=3)
    e1.snapshot(path)
    scales = e1.cache.k_scale.clone()
    uninterrupted = turn(e1, [7], seed=None)
    e2 = make_engine(weights, kv_dtype="q8")
    e2.restore(path)
    assert torch.equal(e2.cache.k_scale, scales)
    assert turn(e2, [7], seed=None) == uninterrupted


def test_restore_writes_in_place(weights, tmp_path):
    """restore writes the existing cache tensors (captured graphs read
    their addresses), never rebinds them."""
    path = str(tmp_path / "e.snap")
    e1 = make_engine(weights)
    turn(e1, [3, 4], seed=1)
    e1.snapshot(path)
    e2 = make_engine(weights)
    ptrs = (e2.cache.k.data_ptr(), e2.cache.v.data_ptr())
    e2.restore(path)
    assert (e2.cache.k.data_ptr(), e2.cache.v.data_ptr()) == ptrs
    assert torch.equal(e2.cache.k, e1.cache.k)


def test_fingerprint_mismatch_cold_start(weights, tmp_path):
    path = str(tmp_path / "engine.snap")
    e1 = make_engine(weights, seq_len=32)
    turn(e1, [3], seed=1)
    e1.snapshot(path)
    e2 = make_engine(weights)
    with pytest.raises(SnapshotMismatch, match="differently-configured"):
        e2.restore(path)
    assert isinstance(SnapshotMismatch(path, "x", "y"), ArtifactError)
    assert e2.pos == 0


def test_quantized_vs_dense_layout_mismatch(weights, tmp_path):
    path = str(tmp_path / "dense.snap")
    make_engine(weights).snapshot(path)
    with pytest.raises(SnapshotMismatch):
        make_engine(weights, kv_dtype="q8").restore(path)


def test_corrupt_snapshot_rejected(weights, tmp_path):
    """Any single flipped byte fails the load's crc32 (meta and payload)."""
    path = str(tmp_path / "engine.snap")
    e = make_engine(weights)
    turn(e, [3, 4], seed=2)
    e.snapshot(path)
    data = open(path, "rb").read()
    rng = np.random.RandomState(9)
    for off in sorted({0, 9, len(data) - 1} | {int(o) for o in rng.randint(len(data), size=12)}):
        flipped = bytearray(data)
        flipped[off] ^= 0x10
        bad = str(tmp_path / "bad.snap")
        with open(bad, "wb") as f:
            f.write(flipped)
        with pytest.raises(ArtifactError):
            make_engine(weights).restore(bad)


def test_truncated_snapshot_rejected(weights, tmp_path):
    path = str(tmp_path / "engine.snap")
    make_engine(weights).snapshot(path)
    data = open(path, "rb").read()
    for keep in (0, 7, 13, len(data) // 2, len(data) - 1):
        bad = str(tmp_path / "trunc.snap")
        with open(bad, "wb") as f:
            f.write(data[:keep])
        with pytest.raises(ArtifactError):
            make_engine(weights).restore(bad)


def test_legacy_dlsnap01_magic_rejected(weights, tmp_path):
    path = str(tmp_path / "engine.snap")
    make_engine(weights).snapshot(path)
    data = bytearray(open(path, "rb").read())
    assert data[:8] == b"DLSNAP02"
    data[:8] = b"DLSNAP01"
    old = str(tmp_path / "old.snap")
    with open(old, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(ArtifactError, match="superseded"):
        snapfmt.load(old)
    with pytest.raises(ArtifactError, match="superseded"):
        make_engine(weights).restore(old)


def test_pos_out_of_range_rejected(weights, tmp_path):
    e = make_engine(weights)
    arrays = {f"cache.{n}": snapfmt.to_numpy(ts[0]) for n, ts in e.kv_planes().items()}
    path = str(tmp_path / "forged.snap")
    snapfmt.save(path, fingerprint=e.config_fingerprint(), pos=e.seq_len + 1,
                 chunk_counter=0, arrays=arrays)
    with pytest.raises(SnapshotMismatch, match="position"):
        e.restore(path)


def test_missing_cache_array_rejected(weights, tmp_path):
    e = make_engine(weights)
    path = str(tmp_path / "partial.snap")
    snapfmt.save(path, fingerprint=e.config_fingerprint(), pos=0, chunk_counter=0,
                 arrays={"cache.k": snapfmt.to_numpy(e.cache.k)})
    with pytest.raises(SnapshotMismatch, match="cache.v"):
        e.restore(path)


def test_restore_counter_exported(weights, tmp_path):
    reset_counters()
    path = str(tmp_path / "engine.snap")
    make_engine(weights).snapshot(path)
    make_engine(weights).restore(path)
    assert counters()["snapshot_restores"] == 1
    assert "dllama_snapshot_restores_total 1" in obs_metrics.render_prometheus()


# -- interchange with the JAX package -------------------------------------

@pytest.mark.parametrize("kw", [{}, {"kv_dtype": "q8"}, {"batch": 2},
                                {"batch": 2, "kv_pages": 17, "kv_page_size": 8},
                                {"batch": 2, "kv_pages": 17, "kv_page_size": 8,
                                 "kv_dtype": "q8"}],
                         ids=["contiguous", "contiguous-int8", "batch2", "paged",
                              "paged-int8"])
def test_fingerprints_equal_jax(weights, kw):
    """The digests hash dtype names (``float32``, ``int8``), so they equal
    the JAX package's for the same model, batch, context and pool."""
    te, je = make_engine(weights, **kw), make_jax_engine(weights, **kw)
    assert te.config_fingerprint() == je.config_fingerprint()
    if kw.get("kv_pages"):
        assert te.handoff_fingerprint() == je.handoff_fingerprint()


def test_bf16_fingerprints_equal_jax(weights):
    """A bf16 pool hashes ``bfloat16`` in both (``torch.bfloat16`` was the
    fault)."""
    jcfg, jp, tcfg, _ = weights
    tcfg16 = tcfg.with_(dtype=torch.bfloat16)
    te = Engine(tcfg16, tparams.from_jax_params({k: np.asarray(v) for k, v in jp.items()},
                                                 tcfg16),
                device="cpu", batch=2, kv_pages=17, kv_page_size=8)
    je = JEngine(jconfig.tiny_config(seq_len=SEQ, dtype=jax.numpy.bfloat16), jp,
                 mesh=jmake_mesh(tp=1, devices=jax.devices()[:1]), batch=2, kv_pages=17,
                 kv_page_size=8)
    assert te.cache.k.dtype == torch.bfloat16
    assert te.config_fingerprint() == je.config_fingerprint()
    assert te.handoff_fingerprint() == je.handoff_fingerprint()


def _arrays(rng):
    a = rng.randn(2, 3, 4).astype(np.float32)
    return a, {"f32": a, "i8": np.arange(-5, 7, dtype=np.int8).reshape(3, 4),
               "u32": np.array([7, 11], np.uint32), "empty": np.zeros((0, 3), np.float32)}


def test_jax_file_loads_in_the_port_and_back(tmp_path):
    """A DLSNAP02 file written by the JAX package loads in the port with
    equal bytes, bf16 as its raw words; the port writes the same file
    byte for byte."""
    rng = np.random.RandomState(0)
    a, arrays = _arrays(rng)
    jarrays = dict(arrays, bf16=a.astype(ml_dtypes.bfloat16))
    tarrays = dict(arrays, bf16=snapfmt.bf16_words(a.astype(ml_dtypes.bfloat16)
                                                   .view(np.uint16)))
    jpath, tpath = str(tmp_path / "j.snap"), str(tmp_path / "t.snap")
    jsnap.save(jpath, fingerprint="fp", pos=5, chunk_counter=2, arrays=jarrays,
               extra={"k": [1, 2]})
    snapfmt.save(tpath, fingerprint="fp", pos=5, chunk_counter=2, arrays=tarrays,
                 extra={"k": [1, 2]})
    assert open(jpath, "rb").read() == open(tpath, "rb").read()
    meta, got = snapfmt.load(jpath)
    assert (meta["pos"], meta["chunk_counter"], meta["extra"]) == (5, 2, {"k": [1, 2]})
    assert isinstance(got["bf16"], snapfmt.Bf16Words)
    np.testing.assert_array_equal(got["bf16"].view(np.uint16),
                                  jarrays["bf16"].view(np.uint16))
    assert torch.equal(snapfmt.to_torch(got["bf16"], torch.bfloat16).float(),
                       torch.from_numpy(jarrays["bf16"].astype(np.float32)))
    for n in arrays:
        assert got[n].dtype == arrays[n].dtype
        np.testing.assert_array_equal(got[n], arrays[n])
    jmeta, jgot = jsnap.load(tpath)
    assert jgot["bf16"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(jgot["bf16"].view(np.uint16),
                                  jarrays["bf16"].view(np.uint16))


@pytest.mark.parametrize("kw", [{}, {"batch": 2, "kv_pages": 17, "kv_page_size": 8},
                                {"batch": 2, "kv_pages": 17, "kv_page_size": 8,
                                 "kv_dtype": "f16"}],
                         ids=["contiguous", "paged", "paged-f16"])
def test_engine_snapshots_cross_implementations(weights, tmp_path, kw):
    """A JAX engine's snapshot restores into the port's engine with the
    same cache bytes and position, and the port's into JAX's (an f16 pool
    as f16 arrays both ways); the sampled stream is each engine's own (a
    threefry key does not seed a torch generator: the port reseeds, the JAX
    engine starts its key afresh)."""
    je = make_jax_engine(weights, **kw)
    te = make_engine(weights, **kw)
    if not kw:
        list(je.generate_stream([3, 4, 1], 8, temperature=0.0, chunk=4))
    jpath, tpath = str(tmp_path / "j.snap"), str(tmp_path / "t.snap")
    je.snapshot(jpath)
    te.restore(jpath)
    assert te.pos == je.pos
    np.testing.assert_array_equal(te.cache.k.numpy(), np.asarray(je.cache.k))
    np.testing.assert_array_equal(te.cache.v.numpy(), np.asarray(je.cache.v))
    if not kw:
        list(te.generate_stream([5], 6, temperature=0.0, chunk=4))
    te.snapshot(tpath)
    je2 = make_jax_engine(weights, **kw)
    je2.restore(tpath)
    assert je2.pos == te.pos
    np.testing.assert_array_equal(np.asarray(je2.cache.k), te.cache.k.numpy())


# -- the paged scheduler ----------------------------------------------------

def make_paged_stack(weights, kv_pages=17, page=8, batch=2, **kw):
    eng = make_engine(weights, batch=batch, kv_pages=kv_pages, kv_page_size=page, **kw)
    return eng, SlotScheduler(eng, prefill_chunk=4)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16-or-f32", "int8"])
def test_paged_scheduler_snapshot_roundtrip(weights, tmp_path, quant):
    """snapshot_paged keeps the pool, the page tables and the radix tree's
    keys; restore_paged rebuilds them: a prompt that matched the tree
    before the restart matches after it, and decodes the same tokens."""
    path = str(tmp_path / "sched.snap")
    prompt = list(range(1, 18))  # two full 8-token blocks + a suffix
    kv = {"kv_dtype": "q8"} if quant else {}
    _, s1 = make_paged_stack(weights, **kv)
    try:
        ref = list(s1.submit(prompt, 8, temperature=0.0).tokens())
        assert len(s1.prefix_cache) == 2
        s1.snapshot_paged(path, extra={"note": "pre-restart"})
    finally:
        s1.close()
    e2, s2 = make_paged_stack(weights, **kv)
    try:
        k_ptr = e2.cache.k.data_ptr()
        assert s2.restore_paged(path)["note"] == "pre-restart"
        assert e2.cache.k.data_ptr() == k_ptr
        assert len(s2.prefix_cache) == 2 and s2.pool.in_use == 2
        s2.pool.check()
        reused0 = s2.stats["prefix_tokens_reused"]
        out = list(s2.submit(prompt, 8, temperature=0.0).tokens())
        assert s2.stats["prefix_tokens_reused"] - reused0 == 16
        assert out == ref
    finally:
        s2.close()


def test_paged_pool_geometry_mismatch(weights, tmp_path):
    path = str(tmp_path / "sched.snap")
    _, s1 = make_paged_stack(weights, kv_pages=17)
    try:
        s1.snapshot_paged(path)
    finally:
        s1.close()
    for kw in ({"kv_pages": 9}, {"kv_pages": 34, "page": 4}):
        _, s2 = make_paged_stack(weights, **kw)
        try:
            with pytest.raises(SnapshotMismatch):
                s2.restore_paged(path)
            assert s2.pool.in_use == 0
        finally:
            s2.close()


def test_bf16_roundtrip_without_ml_dtypes(tmp_path):
    """The port reads and writes bf16 with ml_dtypes blocked: a bf16 paged
    engine's snapshot restores the same bytes."""
    code = f"""
import sys
sys.modules["ml_dtypes"] = None
import torch
from dllama_tpu_torch.models import config, params
from dllama_tpu_torch.runtime.engine import Engine
cfg = config.tiny_config(seq_len=32, dtype=torch.bfloat16)
p = params.init_params(cfg, seed=3)
e1 = Engine(cfg, p, device="cpu", batch=2, kv_pages=9, kv_page_size=8)
torch.manual_seed(0)
e1.cache.k.copy_(torch.randn(e1.cache.k.shape))
e1.snapshot({str(tmp_path / "bf16.snap")!r})
e2 = Engine(cfg, p, device="cpu", batch=2, kv_pages=9, kv_page_size=8)
e2.restore({str(tmp_path / "bf16.snap")!r})
assert torch.equal(e1.cache.k.view(torch.int16), e2.cache.k.view(torch.int16))
got = e2.read_pool_pages([1, 3])
assert got["pages.k"].dtype.name == "uint16"
print("OK", "ml_dtypes" in sys.modules and sys.modules["ml_dtypes"] is not None)
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=cpu_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.splitlines()[-1] == "OK False"
