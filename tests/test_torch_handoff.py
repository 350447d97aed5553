"""The port's per-request KV hand-off (DLREQ01 records,
SlotScheduler.handoff_export_all / checkpoint_export / import_request,
Engine.read_pool_pages / write_pool_pages) against the JAX package's, on
the tiny f32 model with the same weights (tests/test_handoff.py's
scenarios).

* Records: DLREQ01 round-trips meta and arrays exactly; a flipped byte or
  a truncation is an ArtifactError; the two magics refuse each other; the
  port encodes the JAX package's bytes.
* Byte parity: a greedy request exported mid-decode from one port
  scheduler and imported into another resumes to exactly the undisturbed
  run's tokens, with no re-prefill; the same with the overlapped pipeline
  on (the export flushes it first: no dispatch in flight while pages are
  read), across tp = 2 → 1 and 1 → 2, and on int8 pools.
* Across implementations: a record the JAX scheduler exported resumes in
  the port, and the port's in the JAX scheduler, to the uninterrupted
  greedy stream; the next-token logits of both packages over the moved
  pages agree within 1e-4 of max|logits| (tests/test_torch_slots.py's f32
  tolerance).  A sampled record from another generator is refused on both
  sides.
* Refusals: another geometry, pages inconsistent with the position, an
  int8 record without its scale planes; the queued tickets of a drain
  retire ``handoff`` with no record.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.models import config as jconfig, params as jparams, transformer as jtr
from dllama_tpu.parallel.mesh import make_mesh as jmake_mesh
from dllama_tpu.runtime import snapshot as jsnap
from dllama_tpu.runtime.engine import Engine as JEngine
from dllama_tpu.runtime.faults import injected
from dllama_tpu.runtime.scheduler import SlotScheduler as JScheduler
from dllama_tpu_torch.io.integrity import ArtifactError
from dllama_tpu_torch.models import config as tconfig, params as tparams, transformer as ttr
from dllama_tpu_torch.parallel.mesh import make_mesh
from dllama_tpu_torch.runtime import snapshot as snapfmt
from dllama_tpu_torch.runtime.engine import Engine
from dllama_tpu_torch.runtime.scheduler import SlotScheduler
from dllama_tpu_torch.runtime.snapshot import SnapshotMismatch

SEQ = 64
PAGE = 4
P = [5, 9, 2]
N = 30
LOGIT_TOL = 1e-4  # of max|logits|, f32 model (tests/test_torch_slots.py)


def _weights(**kw):
    jcfg = jconfig.tiny_config(seq_len=SEQ, **kw)
    jp = jparams.init_params(jcfg, seed=4)
    tcfg = tconfig.tiny_config(seq_len=SEQ, **kw)
    return jcfg, jp, tcfg, tparams.from_jax_params(
        {k: np.asarray(v) for k, v in jp.items()}, tcfg)


@pytest.fixture(scope="module")
def weights():
    return _weights()


def paged_engine(weights, batch=2, mesh=None, **kw):
    _, _, tcfg, tp = weights
    return Engine(tcfg, tp, device="cpu", batch=batch, mesh=mesh,
                  kv_pages=batch * (SEQ // PAGE) + 1, kv_page_size=PAGE, **kw)


def jax_paged_engine(weights, batch=2, **kw):
    jcfg, jp, _, _ = weights
    return JEngine(jcfg, jp, mesh=jmake_mesh(tp=1, devices=jax.devices()[:1]), batch=batch,
                   kv_pages=batch * (SEQ // PAGE) + 1, kv_page_size=PAGE, **kw)


def scheduler(eng, **kw):
    return SlotScheduler(eng, prefill_chunk=4, max_wait_ms=20.0, decode_burst=4, **kw)


def slowed(sched, s=0.05):
    """Each dispatch of ``sched`` sleeps ``s`` first: a consumer can stop
    reading mid-decode."""
    eng = sched.engine
    step = eng.slot_step_async

    def slow(*a, **k):
        time.sleep(s)
        return step(*a, **k)
    eng.slot_step_async = slow
    return sched


def solo(weights, prompt=P, n=N):
    _, _, tcfg, tp = weights
    eng = Engine(tcfg, tp, device="cpu")
    return [t for t, _ in eng.generate_stream(prompt, len(prompt) + n, temperature=0.0,
                                              chunk=5)][len(prompt):]


@pytest.fixture(scope="module")
def solo_ref(weights):
    return solo(weights)


def export_mid_decode(sched, prompt=P, n=N, consume=6):
    """Submit a greedy request, read ``consume`` tokens, drain with export;
    returns (ticket, record, replayed completion)."""
    t = sched.submit(prompt, n, temperature=0.0)
    it = t.tokens()
    consumed = [next(it) for _ in range(consume)]
    records = sched.handoff_export_all()
    list(it)
    assert t.finish == "handoff" and set(records) == {t.rid}
    meta, _ = snapfmt.loads_request(records[t.rid])
    replayed = [int(x) for x in meta["extra"]["completion"]]
    assert replayed[:consume] == consumed
    return t, records[t.rid], replayed


# -- DLREQ01 records ---------------------------------------------------------

def _record(mod, bf16):
    arrays = {"pages.k": np.arange(24, dtype=np.float32).reshape(2, 3, 4),
              "pages.v": bf16,
              "rng_key": np.array([7, 11], dtype=np.uint32)}
    extra = {"rid": "req-abc", "prompt": [1, 2, 3], "completion": [9, 8],
             "max_new": 16, "temperature": 0.0, "stop": ["END"]}
    return mod.dumps_request(fingerprint="fp-1", pos=7, chunk_counter=3, arrays=arrays,
                             extra=extra), arrays, extra


def test_dlreq01_roundtrip_and_jax_bytes():
    import ml_dtypes
    v = np.linspace(-2, 2, 24, dtype=np.float32).reshape(2, 3, 4).astype(ml_dtypes.bfloat16)
    jblob, _, _ = _record(jsnap, v)
    blob, arrays, extra = _record(snapfmt, snapfmt.bf16_words(v.view(np.uint16)))
    assert blob == jblob
    meta, got = snapfmt.loads_request(jblob)
    assert meta["fingerprint"] == "fp-1" and meta["pos"] == 7
    assert meta["chunk_counter"] == 3 and meta["extra"] == extra
    assert set(got) == set(arrays)
    np.testing.assert_array_equal(got["pages.k"], arrays["pages.k"])
    np.testing.assert_array_equal(got["pages.v"].view(np.uint16), v.view(np.uint16))
    jmeta, jgot = jsnap.loads_request(blob)
    assert jgot["pages.v"].dtype == ml_dtypes.bfloat16 and jmeta["extra"] == extra


def test_dlreq01_detects_corruption():
    blob, _, _ = _record(snapfmt, np.ones((2, 3, 4), np.float32))
    for off in (20, len(blob) - 5):
        bad = bytearray(blob)
        bad[off] ^= 0xFF
        with pytest.raises(ArtifactError):
            snapfmt.loads_request(bytes(bad))
    with pytest.raises(ArtifactError):
        snapfmt.loads_request(blob[:len(blob) // 2])
    with pytest.raises(ArtifactError):
        snapfmt.loads_request(b"")


def test_magics_are_mutually_exclusive(tmp_path):
    blob, _, _ = _record(snapfmt, np.ones((2, 3, 4), np.float32))
    with pytest.raises(ArtifactError, match="hand-off"):
        snapfmt.loads_request(snapfmt.MAGIC + blob[len(snapfmt.REQ_MAGIC):])
    p = tmp_path / "req.dlsnap"
    p.write_bytes(blob)
    with pytest.raises(ArtifactError):
        snapfmt.load(p)


# -- the pool's pages ------------------------------------------------------

def test_read_write_pool_pages_in_place(weights):
    """write_pool_pages writes the given pages in place (index_copy_ into
    the same tensors) and read_pool_pages reads them back exactly; the
    async read on the CPU hands back the same arrays."""
    eng = paged_engine(weights, kv_dtype="q8")
    rng = np.random.RandomState(1)
    shape = (eng.cfg.n_layers, 2, eng.cfg.n_kv_heads, PAGE, eng.cfg.head_size)
    arrays = {"pages.k": rng.randint(-127, 128, shape).astype(np.int8),
              "pages.v": rng.randint(-127, 128, shape).astype(np.int8),
              "pages.k_scale": rng.rand(*shape[:-1], 1).astype(np.float32),
              "pages.v_scale": rng.rand(*shape[:-1], 1).astype(np.float32)}
    ptrs = [t[0].data_ptr() for t in eng.kv_planes().values()]
    eng.write_pool_pages([5, 2], arrays)
    assert [t[0].data_ptr() for t in eng.kv_planes().values()] == ptrs
    got = eng.read_pool_pages([5, 2])
    for n, a in arrays.items():
        np.testing.assert_array_equal(got[n], a)
    assert not eng.cache.k[:, [1, 3, 4]].any()
    got = {n: h.wait() for n, h in eng.read_pool_pages_async([2]).items()}
    np.testing.assert_array_equal(got["pages.v_scale"], arrays["pages.v_scale"][:, 1:])


# -- port to port ----------------------------------------------------------

@pytest.mark.parametrize("overlap", [False, True], ids=["sync", "overlap"])
def test_handoff_resume_byte_parity(weights, solo_ref, overlap):
    """Export mid-decode from scheduler A, import into B: the replayed and
    resumed tokens equal the undisturbed run, and B decodes only the rest
    of the budget.  With the overlapped pipeline on, the export reads the
    pages with no dispatch in flight (it flushes first)."""
    sa = slowed(scheduler(paged_engine(weights), overlap=overlap))
    sb = scheduler(paged_engine(weights))
    seen = []
    read = sa.engine.read_pool_pages

    def watch(pages):
        seen.append(sa._inflight_n)
        return read(pages)
    sa.engine.read_pool_pages = watch
    try:
        t, rec, replayed = export_mid_decode(sa)
        assert seen == [0]
        if overlap:
            assert sa.stats["overlapped"] >= 1
        t2, extra = sb.import_request(rec)
        assert t2.rid == t.rid and extra["completion"] == replayed
        resumed = list(t2.tokens())
        assert t2.finish == "length"
        assert replayed + resumed == solo_ref
        assert len(resumed) == N - len(replayed)
        assert sb.stats["imported"] == 1 and sb.stats["prefill_tokens"] == 0
    finally:
        sa.close()
        sb.close()


def test_checkpoint_export_is_non_destructive(weights, solo_ref):
    """checkpoint_export copies a live slot without stopping it; the copy
    resumes elsewhere to the same tokens."""
    sa = slowed(scheduler(paged_engine(weights)))
    sb = scheduler(paged_engine(weights))
    try:
        t = sa.submit(P, N, temperature=0.0)
        it = t.tokens()
        for _ in range(4):
            next(it)
        rec = sa.checkpoint_export(t.rid)
        assert rec is not None and sa.checkpoint_export("nobody") is None
        rest = list(it)
        assert t.finish == "length"
        meta, _ = snapfmt.loads_request(rec)
        replayed = [int(x) for x in meta["extra"]["completion"]]
        t2, _ = sb.import_request(rec)
        assert replayed + list(t2.tokens()) == solo_ref
        assert len(rest) + 4 == N
    finally:
        sa.close()
        sb.close()


def test_int8_handoff_and_codec_refusal(weights):
    """An int8 pool's record resumes on another int8 replica to the
    uninterrupted int8 run's tokens; a dense pool refuses it (the codec is
    in the fingerprint)."""
    ref_sched = scheduler(paged_engine(weights, kv_dtype="q8"))
    try:
        ref = list(ref_sched.submit(P, N, temperature=0.0).tokens())
    finally:
        ref_sched.close()
    sa = slowed(scheduler(paged_engine(weights, kv_dtype="q8")))
    sb = scheduler(paged_engine(weights, kv_dtype="q8"))
    sd = scheduler(paged_engine(weights))
    try:
        _, rec, replayed = export_mid_decode(sa, consume=4)
        meta, arrays = snapfmt.loads_request(rec)
        assert arrays["pages.k"].dtype == np.int8 and "pages.k_scale" in arrays
        with pytest.raises(SnapshotMismatch, match="geometry"):
            sd.import_request(rec)
        t2, _ = sb.import_request(rec)
        assert replayed + list(t2.tokens()) == ref
    finally:
        for s in (sa, sb, sd):
            s.close()


@pytest.mark.parametrize("tps", [(2, 1), (1, 2)], ids=["tp2-to-tp1", "tp1-to-tp2"])
def test_tp_handoff_byte_parity(tps):
    """A record exported at one tp imports at another and resumes byte for
    byte: the pages are the global (L, n, Hkv, ps, Dh) arrays, the ranks'
    heads joined on axis 2, and the fingerprint leaves the mesh out."""
    w = _weights(hidden_dim=128, n_kv_heads=4)
    ref = solo(w)
    meshes = [make_mesh(tp, "cpu") if tp > 1 else None for tp in tps]
    sa = slowed(scheduler(paged_engine(w, mesh=meshes[0])))
    sb = scheduler(paged_engine(w, mesh=meshes[1]))
    try:
        assert sa.engine.handoff_fingerprint() == sb.engine.handoff_fingerprint()
        _, rec, replayed = export_mid_decode(sa)
        _, arrays = snapfmt.loads_request(rec)
        assert arrays["pages.k"].shape[2] == 4
        t2, _ = sb.import_request(rec)
        assert replayed + list(t2.tokens()) == ref
    finally:
        sa.close()
        sb.close()


def test_import_rejects_incompatible_geometry(weights):
    sa = scheduler(paged_engine(weights))
    try:
        blob = snapfmt.dumps_request(
            fingerprint="some-other-fleet", pos=4, chunk_counter=0,
            arrays={"pages.k": np.zeros((2, 1, 2, PAGE, 16), np.float32),
                    "pages.v": np.zeros((2, 1, 2, PAGE, 16), np.float32)},
            extra={"rid": "alien", "prompt": [1, 2], "max_new": 4})
        with pytest.raises(SnapshotMismatch, match="geometry"):
            sa.import_request(blob)
    finally:
        sa.close()


@pytest.mark.parametrize("drop", [None, "pages.k_scale"], ids=["wrong-pages", "no-scales"])
def test_import_rejects_inconsistent_pages(weights, drop):
    """The right fingerprint, but a page payload that disagrees with the
    position (or an int8 record without a scale plane): refused before any
    state is written."""
    kv = {"kv_dtype": "q8"} if drop else {}
    sa = scheduler(paged_engine(weights, **kv))
    try:
        eng = sa.engine
        L, _, H, ps, D = eng.cache.k.shape
        n = 3 if drop else 1  # pos 9 needs 3 pages
        arrays = {"pages.k": np.zeros((L, n, H, ps, D), eng.cache.k.numpy().dtype),
                  "pages.v": np.zeros((L, n, H, ps, D), eng.cache.k.numpy().dtype)}
        if drop:
            arrays["pages.v_scale"] = np.zeros((L, n, H, ps, 1), np.float32)
        blob = snapfmt.dumps_request(
            fingerprint=eng.handoff_fingerprint(), pos=9, chunk_counter=0, arrays=arrays,
            extra={"rid": "torn", "prompt": [1, 2], "max_new": 4, "fed": 2,
                   "produced": 0})
        with pytest.raises(SnapshotMismatch, match=drop or "position"):
            sa.import_request(blob)
        assert sa.pool.in_use == 0 and sa.occupancy()["active"] == 0
    finally:
        sa.close()


def test_export_fails_queued_tickets_without_records(weights):
    sa = slowed(scheduler(paged_engine(weights)))
    try:
        tickets = [sa.submit([3 + i, 4, 6], N, temperature=0.0) for i in range(3)]
        its = [t.tokens() for t in tickets]
        next(its[0])
        records = sa.handoff_export_all()
        for it in its:
            list(it)
        assert all(t.finish == "handoff" for t in tickets)
        admitted = {t.rid for t in tickets if t.slot is not None}
        assert len({t.rid for t in tickets} - admitted) == 1
        assert set(records) == admitted
    finally:
        sa.close()


# -- across implementations -----------------------------------------------

def _next_logits(fwd, params, cfg, cache, ptab, pos, last, tensor):
    """Row 0's next-token logits after writing ``last`` at ``pos`` over
    page table ``ptab`` (row 1 idles at position 0 on scratch)."""
    toks = np.array([[last], [0]], np.int32)
    rows = np.array([pos, 0], np.int32)
    nv = np.ones(2, np.int32)
    logits, _ = fwd(params, cfg, tensor(toks), cache, tensor(rows), tensor(nv), tensor(ptab))
    return np.asarray(logits)[0]


def _logits_agree(weights, rec):
    """Write the record's pages into a JAX pool and a port pool at the same
    page ids and compare the next-token logits of both packages."""
    jcfg, jp, _, _ = weights
    meta, arrays = snapfmt.loads_request(rec)
    pos, last = int(meta["pos"]), int(meta["extra"]["last"])
    n = -(-pos // PAGE)
    pages = list(range(3, 3 + n + 1))  # one more page for the step's write
    ptab = np.zeros((2, SEQ // PAGE), np.int32)
    ptab[0, :len(pages)] = pages
    te = paged_engine(weights)
    te.write_pool_pages(pages[:n], arrays)
    je = jax_paged_engine(weights)
    _, jarrays = jsnap.loads_request(rec)
    je.write_pool_pages(pages[:n], {k: v for k, v in jarrays.items() if k.startswith("pages.")})
    got = _next_logits(ttr.forward_slots, te.params, te.cfg, te.cache, ptab, pos, last,
                       lambda a: torch.from_numpy(a))
    want = _next_logits(jtr.forward_slots, je.params, je.cfg, je.cache, ptab, pos, last,
                        jnp.asarray)
    assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()


def test_jax_record_resumes_in_the_port(weights, solo_ref):
    """A greedy record the JAX scheduler exported mid-decode resumes in
    the port's scheduler to JAX's uninterrupted stream."""
    je = jax_paged_engine(weights)
    ja = JScheduler(je, prefill_chunk=4, max_wait_ms=20.0, decode_burst=4, overlap=False)
    sb = scheduler(paged_engine(weights))
    try:
        with injected("engine.device_step=delay:0.05"):
            t = ja.submit(P, N, temperature=0.0)
            it = t.tokens()
            for _ in range(6):
                next(it)
            records = ja.handoff_export_all()
        list(it)
        rec = records[t.rid]
        meta, _ = snapfmt.loads_request(rec)
        replayed = [int(x) for x in meta["extra"]["completion"]]
        assert replayed + list(sb.import_request(rec)[0].tokens()) == solo_ref
        _logits_agree(weights, rec)
        # a sampled JAX record (a threefry stream) is refused here
        extra = dict(meta["extra"], temperature=0.8)
        _, arrays = jsnap.loads_request(rec)
        sampled = jsnap.dumps_request(fingerprint=meta["fingerprint"], pos=meta["pos"],
                                      chunk_counter=0, arrays=arrays, extra=extra)
        with pytest.raises(SnapshotMismatch, match="rng_kind"):
            sb.import_request(sampled)
    finally:
        ja.close()
        sb.close()


def test_port_record_resumes_in_jax(weights, solo_ref):
    """The port's greedy record resumes in the JAX scheduler to the same
    stream; a sampled port record is refused there (its sampling path
    names the torch generator)."""
    sa = slowed(scheduler(paged_engine(weights)))
    jb = JScheduler(jax_paged_engine(weights), prefill_chunk=4, max_wait_ms=20.0,
                    decode_burst=4, overlap=False)
    try:
        _, rec, replayed = export_mid_decode(sa)
        t2, _ = jb.import_request(rec)
        assert replayed + list(t2.tokens()) == solo_ref
        _logits_agree(weights, rec)
        sa2 = slowed(scheduler(paged_engine(weights)))
        try:
            t = sa2.submit(P, N, temperature=0.8)
            it = t.tokens()
            next(it)
            sampled = sa2.handoff_export_all()[t.rid]
            list(it)
        finally:
            sa2.close()
        with pytest.raises(jsnap.SnapshotMismatch, match="sampling_path"):
            jb.import_request(sampled)
    finally:
        sa.close()
        jb.close()


def test_sampled_record_carries_the_generator(weights):
    """A sampled record carries the generator's state, and an idle
    importer of the same kind takes it."""
    sa = slowed(scheduler(paged_engine(weights)))
    sb = slowed(scheduler(paged_engine(weights)), 0.5)
    try:
        t = sa.submit(P, N, temperature=0.8)
        it = t.tokens()
        next(it)
        rec = sa.handoff_export_all()[t.rid]
        list(it)
        _, arrays = snapfmt.loads_request(rec)
        state = sa.engine._gen.get_state()
        assert np.array_equal(arrays["rng_state"], state.numpy())
        sb.engine._gen.manual_seed(123)
        t2, extra = sb.import_request(rec)
        # read before the importer's first dispatch (it sleeps first) draws
        assert torch.equal(sb.engine._gen.get_state(), state)
        assert extra["rng_kind"] == "torch-cpu" and extra["sampling_path"] != "device"
        list(t2.tokens())
        assert t2.finish == "length"
    finally:
        sa.close()
        sb.close()


def test_f16_pool_records_cross_implementations(weights):
    """An f16 pool's DLREQ01 record (``--kv-cache-dtype f16``): the port's
    export carries f16 pages, which the JAX package reads as float16, and
    resumes in the JAX scheduler on its f16 pool to the uninterrupted f16
    run's tokens; JAX's export of the same request resumes in the port's."""
    ref_sched = scheduler(paged_engine(weights, kv_dtype=torch.float16))
    try:
        ref = list(ref_sched.submit(P, N, temperature=0.0).tokens())
    finally:
        ref_sched.close()
    sa = slowed(scheduler(paged_engine(weights, kv_dtype=torch.float16)))
    jb = JScheduler(jax_paged_engine(weights, kv_dtype=jnp.float16), prefill_chunk=4,
                    max_wait_ms=20.0, decode_burst=4, overlap=False)
    sb = scheduler(paged_engine(weights, kv_dtype=torch.float16))
    try:
        _, rec, replayed = export_mid_decode(sa, consume=5)
        _, arrays = snapfmt.loads_request(rec)
        _, jarrays = jsnap.loads_request(rec)
        assert arrays["pages.k"].dtype == np.float16 == jarrays["pages.k"].dtype
        np.testing.assert_array_equal(arrays["pages.v"], jarrays["pages.v"])
        t2, _ = jb.import_request(rec)
        assert replayed + list(t2.tokens()) == ref
        ja = JScheduler(jax_paged_engine(weights, kv_dtype=jnp.float16), prefill_chunk=4,
                        max_wait_ms=20.0, decode_burst=4, overlap=False)
        try:
            with injected("engine.device_step=delay:0.05"):
                t = ja.submit(P, N, temperature=0.0)
                it = t.tokens()
                for _ in range(6):
                    next(it)
                jrec = ja.handoff_export_all()[t.rid]
            list(it)
        finally:
            ja.close()
        meta, _ = snapfmt.loads_request(jrec)
        jreplayed = [int(x) for x in meta["extra"]["completion"]]
        assert jreplayed + list(sb.import_request(jrec)[0].tokens()) == ref
    finally:
        for s in (sa, jb, sb):
            s.close()
