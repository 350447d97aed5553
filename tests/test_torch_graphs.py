"""The decode-step bodies that the port captures as CUDA graphs
(dllama_tpu_torch.runtime.graphs), run eagerly on the CPU: device
positions, static buffers, the bucketed walk.  Each is held against the
port's eager ``decode_loop`` and against the JAX package on the same
weights and inputs.

Tolerances, relative to max|logits| (tests/test_torch_model.py's): the f32
model with packed weights multiplies the same bf16 operands in both
packages and differs in f32 summation order only — 1e-4.  Against the
port's eager loop the body computes the same ops in the same order, but a
CPU BLAS call may pick another summation order for operands at other
addresses, so logits are held to the same 1e-4 there too.  Greedy tokens
are compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu import quants
from dllama_tpu.io import mfile as jmfile
from dllama_tpu.models import config as jconfig, params as jparams, transformer as jtr
from dllama_tpu.ops import attention as jattn, q40 as jq40
from dllama_tpu.parallel.mesh import make_mesh
from dllama_tpu.runtime.engine import Engine as JEngine
from dllama_tpu_torch.io import mfile as tmfile
from dllama_tpu_torch.models import config as tconfig, params as tparams
from dllama_tpu_torch.ops import attention as tattn, q8 as tq8, q40 as tq40
from dllama_tpu_torch.runtime import graphs
from dllama_tpu_torch.runtime.engine import Engine
from fixtures import write_tiny_model

TOL = 1e-4
ATTN_TOL = 1e-5
PAGE = 4


def _tiny(seq_len: int):
    kw = dict(dim=64, hidden_dim=96, n_layers=2, n_heads=4, n_kv_heads=2,
              vocab_size=128, seq_len=seq_len)
    jcfg = jconfig.tiny_config(dtype=jnp.float32, **kw)
    tcfg = tconfig.tiny_config(**kw)
    jp = jparams.quantize_matmuls(jparams.init_params(jcfg, seed=3), jcfg)
    arrays = {k: (np.asarray(v.qpacked), np.asarray(v.scales), v.logical_nd)
              if isinstance(v, jq40.QTensor) else np.asarray(v) for k, v in jp.items()}
    return jcfg, jp, tcfg, tparams.from_jax_params(arrays, tcfg)


@pytest.fixture(scope="module")
def tiny():
    return _tiny(64)


def _body_engine(cfg, params, **kw) -> Engine:
    """A CPU engine whose decode steps run the graph bodies eagerly."""
    eng = Engine(cfg, params, device="cpu", **kw)
    eng.graphs = graphs.DecodeGraphs(eng.device, capture=False)
    return eng


def _close(t: torch.Tensor, ref) -> None:
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(t.numpy(), ref, rtol=0, atol=TOL * np.abs(ref).max())


def _jax_engine(jcfg, jp, **kw):
    return JEngine(jcfg, jp, mesh=make_mesh(tp=1, devices=jax.devices()[:1]), **kw)


# -- pure functions ----------------------------------------------------------

def test_walk_bucket_is_the_live_block_count():
    """The bucket is the number of blocks ``blocked_live_fold`` walks at
    that position (1024-position blocks at 4096: 4 buckets), and 0 where
    the one-shot attention reads the whole cache."""
    s = 4096
    got = [tattn.walk_bucket(p, s) for p in (0, 1, 1023, 1024, 2047, 2048, 3071, 3072, 4095)]
    assert got == [1, 1, 1, 2, 2, 3, 3, 4, 4]
    for p in range(0, s, 97):
        w = tattn.walk_bucket(p, s)
        assert min(p, s - 1) // tattn._kv_chunk(s) + 1 == w
        assert p <= tattn.walk_bound(w, s) < p + tattn._kv_chunk(s)
    assert tattn.walk_bucket(40, 64) == 0 and tattn.walk_bound(0, 64) == 63
    assert tattn.walk_bucket(100, 6144) == 1 and tattn._kv_chunk(6144) == 1024


def test_graph_keys_of_each_path(tiny, monkeypatch):
    """The key a step takes: path, rows, greedy or sampled, walk bucket
    (0 below the walk's cache size).  Greedy and sampled batch-1 chunks,
    the ragged lockstep batch and the slot engine each take their own."""
    keys = []
    monkeypatch.setattr(graphs.DecodeGraphs, "_step",
                        lambda self, key, body: (keys.append(key), body()))
    jcfg, jp, tcfg, tp = tiny
    eng = _body_engine(tcfg, tp)
    list(eng.generate_stream([1, 5, 9], 8, temperature=0.0, chunk=4))
    list(eng.generate_stream([1, 5, 9], 8, temperature=0.7, seed=2, chunk=4))
    beng = _body_engine(tcfg, tp, batch=2)
    list(beng.generate_batch_stream([[1, 2], [3]], 5, temperature=0.0, chunk=4))
    seng = _body_engine(tcfg, tp, batch=2)
    seng.slot_step(np.array([[3], [4]], np.int32), np.zeros(2, np.int32),
                   np.ones(2, np.int32), temps_np=np.array([0.0, 0.5], np.float32),
                   topps_np=np.full(2, 0.9, np.float32), steps=2)
    assert keys == [graphs.GraphKey("chunk", 1, True, 0)] * 4 + \
        [graphs.GraphKey("chunk", 1, False, 0)] * 4 + \
        [graphs.GraphKey("ragged", 2, True, 0)] * 4 + \
        [graphs.GraphKey("slot", 2, False, 0)] * 2


def test_counter_deltas_are_added_per_replay():
    """A capture's counter deltas (plain ints and per-shape counts) are
    taken back, then added once a replay."""
    tq40.reset_counters()
    tq8.reset_counters()
    tattn.reset_counters()
    tq40.kernel_launches = 3
    tq40.launches_by_shape[(64, 128)] = 3
    before = graphs.counter_snapshot()
    # what one captured step launches
    tq40.kernel_launches += 9
    tq40.launches_by_shape[(64, 128)] += 8
    tq40.launches_by_shape[(64, 300)] = 1
    tattn.kernel_launches += 2
    delta = graphs.counter_delta(before, graphs.counter_snapshot())
    assert delta == {("dllama_tpu_torch.ops.q40", "kernel_launches"): 9,
                     ("dllama_tpu_torch.ops.q40", "launches_by_shape", (64, 128)): 8,
                     ("dllama_tpu_torch.ops.q40", "launches_by_shape", (64, 300)): 1,
                     ("dllama_tpu_torch.ops.attention", "kernel_launches"): 2}
    graphs.add_counts(delta, -1)  # the capture launched nothing
    assert graphs.counter_snapshot() == before
    assert (64, 300) not in tq40.launches_by_shape
    for _ in range(3):
        graphs.add_counts(delta)
    c = tq40.counters()
    assert c["kernel_launches"] == 3 + 27 and c["launches_by_shape"] == {
        (64, 128): 3 + 24, (64, 300): 3}
    assert tattn.counters()["kernel_launches"] == 6 and tq8.counters()["kernel_launches"] == 0
    tq40.reset_counters()
    tattn.reset_counters()


def test_cpu_engine_never_builds_a_graph(tiny):
    jcfg, jp, tcfg, tp = tiny
    eng = Engine(tcfg, tp, device="cpu")
    assert eng.graphs is None
    list(eng.generate_stream([1, 5, 9], 12, temperature=0.0, chunk=4))
    assert eng.graphs is None
    slot = Engine(tcfg, tp, device="cpu", batch=2, kv_pages=40, kv_page_size=PAGE)
    slot.slot_step(np.array([[3], [4]], np.int32), np.zeros(2, np.int32),
                   np.ones(2, np.int32), temps_np=np.zeros(2, np.float32),
                   topps_np=np.full(2, 0.9, np.float32), steps=3,
                   page_tables_np=np.arange(2 * 16, dtype=np.int32).reshape(2, 16) + 1)
    assert slot.graphs is None
    with pytest.raises(ValueError, match="cuda"):
        Engine(tcfg, tp, device="cpu", graphs=True)
    with pytest.raises(ValueError, match="cuda"):
        graphs.DecodeGraphs(torch.device("cpu"))
    # the body runner on the CPU runs eagerly and captures nothing
    b = _body_engine(tcfg, tp)
    list(b.generate_stream([1, 5, 9], 12, temperature=0.0, chunk=4))
    assert b.graphs.captures == 0 and b.graphs.replays == 0 and b.graphs.eager_steps == 8


# -- device positions in attention -------------------------------------------

@pytest.mark.parametrize("pos", [0, 1023, 1024, 2047, 3000, 4095])
def test_device_position_attention_matches_int_and_jax(pos):
    """The decode walk at a DevicePos (the bucket's bound walks, the device
    position masks) equals the walk at the Python int bit for bit, and the
    JAX package's within its bar; so does the KV write at a device index."""
    rng = np.random.RandomState(pos)
    b, hq, hkv, dh, L, s = 2, 4, 2, 16, 2, 4096
    q = torch.from_numpy(rng.randn(b, hq, 1, dh).astype(np.float32))
    ck = torch.from_numpy(rng.randn(L, b, hkv, s, dh).astype(np.float32))
    cv = torch.from_numpy(rng.randn(L, b, hkv, s, dh).astype(np.float32))
    start = torch.tensor([0, 3])
    dpos = tattn.DevicePos(torch.tensor(pos), tattn.walk_bound(tattn.walk_bucket(pos, s), s))
    at_int = tattn.gqa_attention_at(q, ck, cv, 1, pos, 1, start=start)
    at_dev = tattn.gqa_attention_at(q, ck, cv, 1, dpos, 1, start=start)
    assert torch.equal(at_int, at_dev)
    ref = np.asarray(jattn.gqa_attention_at(
        jnp.asarray(q.numpy()), jnp.asarray(ck.numpy()), jnp.asarray(cv.numpy()),
        jnp.int32(1), jnp.int32(pos), 1, start=jnp.asarray(start.numpy())))
    np.testing.assert_allclose(at_dev.numpy(), ref, rtol=0, atol=ATTN_TOL * np.abs(ref).max())
    k_new = torch.from_numpy(rng.randn(b, hkv, 1, dh).astype(np.float32))
    a, b_ = ck.clone(), ck.clone()
    tattn.update_kv_cache_at(a, a.clone(), k_new, k_new, 0, pos)
    tattn.update_kv_cache_at(b_, b_.clone(), k_new, k_new, 0, dpos)
    assert torch.equal(a, b_)


# -- the chunk body: batch-1 and the ragged lockstep batch --------------------

def _model_file(tmp_path_factory, name, **kw):
    path = tmp_path_factory.mktemp(name) / "tiny.m"
    write_tiny_model(path, vocab_size=128, seq_len=64, **kw)
    jcfg, jp = jparams.load_params(jmfile.MFile(str(path)), keep_quantized=True)
    with tmfile.MFile(str(path)) as mf:
        tcfg, tp = tparams.load_params(mf)
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module", params=["llama-q40", "llama-q80", "mixtral-q40"])
def file_model(request, tmp_path_factory):
    kw = {"llama-q40": dict(ftype=quants.Q40), "llama-q80": dict(ftype=quants.Q80),
          "mixtral-q40": dict(ftype=quants.Q40, arch=jmfile.ARCH_MIXTRAL, n_experts=4)}
    return _model_file(tmp_path_factory, request.param, **kw[request.param])


def test_chunk_body_greedy_matches_eager_and_jax(file_model):
    """Llama Q40/Q80 and Mixtral Q40 from one .m file: the body's greedy
    stream equals the port's eager loop and the JAX engine's token for
    token, and the last step's logits agree with the eager loop's."""
    jcfg, jp, tcfg, tp = file_model
    prompt = [1, 5, 9, 2]
    ref = [t for t, _ in _jax_engine(jcfg, jp).generate_stream(
        prompt, 30, temperature=0.0, chunk=5)]
    eager = Engine(tcfg, tp, device="cpu")
    body = _body_engine(tcfg, tp)
    a = [t for t, _ in eager.generate_stream(prompt, 30, temperature=0.0, chunk=5)]
    b = [t for t, _ in body.generate_stream(prompt, 30, temperature=0.0, chunk=5)]
    assert a == b == ref and len(b) == 30
    assert body.pos == eager.pos and body.forwards == eager.forwards
    _close(body.last_logits, eager.last_logits)


def test_chunk_body_crosses_a_walk_block_edge(monkeypatch):
    """At seq_len 4096 the decode walk has 4 buckets: steps from 1018 to
    1030 cross the first block edge, where the key's bucket changes from 1
    to 2.  Every step's logits stay within 1e-4 of the eager loop's and its
    token is the eager loop's.  Against the JAX forward, fed the same
    tokens, the logits stay within 3e-2 (test_torch_model.py's bf16 bar:
    the matmul inputs round to bf16, and every f32 op of XLA's CPU backend
    rounds its last bit otherwise than PyTorch's CPU kernels, so over a
    1000-token context a bit on a bf16 rounding edge flips an ulp now and
    then, at any width: ROADMAP queue 3, fault 1) and the token agrees
    wherever the JAX top-2 margin exceeds twice the largest logit
    difference."""
    keys = []
    real_step = graphs.DecodeGraphs._step
    monkeypatch.setattr(graphs.DecodeGraphs, "_step",
                        lambda self, key, body: (keys.append(key), real_step(self, key, body)))
    jcfg, jp, tcfg, tp = _tiny(4096)
    prompt = np.random.RandomState(8).randint(3, 128, 1018).tolist()
    body, eager = _body_engine(tcfg, tp), Engine(tcfg, tp, device="cpu")
    # the prompt in pieces of 127 rows, each a continuation prefill at a new
    # position (the pieces' width does not set the agreement: fault 1's last
    # bits differ at every width)
    jcache = jtr.init_kv_cache(jcfg, 1)
    for at in range(0, len(prompt), 127):
        piece = prompt[at:at + 127]
        for e in (body, eager):
            logits, _ = e.prefill(piece)
        _, jcache = jtr.forward_last(jp, jcfg, jnp.asarray([piece]), jcache, jnp.int32(at),
                                     jnp.int32(len(piece) - 1))
    tok = int(np.argmax(logits[0]))
    for step in range(12):
        p = len(prompt) + step
        bt, _ = body.decode(np.array([tok]), 1, temperature=0.0, topp=0.9)
        et, _ = eager.decode(np.array([tok]), 1, temperature=0.0, topp=0.9)
        _close(body.last_logits, eager.last_logits)
        assert int(bt[0, 0]) == int(et[0, 0]), p
        jl, jcache = jtr.forward_last(jp, jcfg, jnp.asarray([[tok]]), jcache, jnp.int32(p),
                                      jnp.int32(0))
        ref = np.asarray(jl)[0]
        got = body.last_logits.numpy()[0]
        diff = np.abs(got - ref).max()
        assert diff <= 3e-2 * np.abs(ref).max(), p
        top2 = np.sort(ref)[-2:]
        if top2[1] - top2[0] > 2 * diff:
            assert int(bt[0, 0]) == int(np.argmax(ref)), p
        tok = int(bt[0, 0])
    assert body.pos == eager.pos == len(prompt) + 12
    assert [k.walk for k in keys] == [1] * 6 + [2] * 6


def test_chunk_body_sampled_and_eos_rewind(tiny):
    """Sampled streams draw the eager loop's coins (one uniform a row a
    step from the engine's generator), so a seeded stream is the eager
    stream; an EOS mid-chunk rewinds the position and returns the
    speculative chunk's draws, so the next turn repeats too."""
    jcfg, jp, tcfg, tp = tiny
    prompt = [1, 5, 9]
    runs = []
    for make in (lambda: Engine(tcfg, tp, device="cpu"), lambda: _body_engine(tcfg, tp)):
        eng = make()
        full = [t for t, _ in eng.generate_stream(prompt, 24, temperature=0.8, topp=0.9,
                                                  seed=1, chunk=4)]
        eos = full[6]
        eng = make()
        cut = [t for t, _ in eng.generate_stream(prompt, 24, temperature=0.8, topp=0.9,
                                                 seed=1, chunk=4, eos_ids=(eos,))]
        nxt = [t for t, _ in eng.generate_stream([3], 10, temperature=0.8, topp=0.9,
                                                 seed=None, chunk=4)]
        runs.append((full, cut, nxt, eng.pos))
    assert runs[0] == runs[1]
    full, cut, _, _ = runs[1]
    assert cut == full[:full.index(full[6], len(prompt)) + 1]


def test_ragged_batch_body_matches_eager_and_jax(tiny):
    """The lockstep ragged batch (offsets in a static buffer): greedy rows
    equal the eager loop's and the JAX engine's ``generate_batch``."""
    jcfg, jp, tcfg, tp = tiny
    prompts = [[1, 5, 9, 2, 7, 3, 11], [1, 4], [1, 8, 6, 10]]
    ref = _jax_engine(jcfg, jp, batch=3).generate_batch(prompts, 24, temperature=0.0, chunk=5)
    eager = Engine(tcfg, tp, device="cpu", batch=3).generate_batch(
        prompts, 24, temperature=0.0, chunk=5)
    beng = _body_engine(tcfg, tp, batch=3)
    body = beng.generate_batch(prompts, 24, temperature=0.0, chunk=5)
    assert body == eager == ref
    # a second batch on the same engine reloads the offsets buffer
    beng.reset()
    again = beng.generate_batch(prompts[::-1], 24, temperature=0.0, chunk=5)
    assert again == [r for r in _jax_engine(jcfg, jp, batch=3).generate_batch(
        prompts[::-1], 24, temperature=0.0, chunk=5)]


# -- the slot body: contiguous rows and the paged pool ------------------------

@pytest.mark.parametrize("layout", ["contiguous", "paged", "paged_int8"])
def test_slot_body_matches_eager_and_jax(tiny, layout):
    """A mixed step (through the mixed-step body), then pure-decode
    dispatches chained on the device (``feed_dev``) through the slot body:
    the ids equal the
    eager dispatches', greedy and sampled, and the greedy ids the JAX
    engine's slot steps; the logits agree with the eager loop's."""
    jcfg, jp, tcfg, tp = tiny
    b = 3
    kw = dict(batch=b)
    jkw = dict(batch=b)
    table = None
    if layout != "contiguous":
        maxp = tcfg.seq_len // PAGE
        kw.update(kv_pages=1 + b * maxp, kv_page_size=PAGE,
                  kv_dtype="q8" if layout == "paged_int8" else None)
        jkw.update(kv_pages=1 + b * maxp, kv_page_size=PAGE,
                   kv_dtype="q8" if layout == "paged_int8" else None)
        # rows own interleaved pages, so a wrong table index reads a neighbor
        table = (1 + np.arange(b * maxp, dtype=np.int32)).reshape(maxp, b).T.copy()
    tokens = np.array([[5, 9, 2, 7], [8, 1, 6, 0], [3, 0, 0, 0]], np.int32)
    n_valid = np.array([4, 3, 1], np.int32)
    pos0 = np.zeros(b, np.int32)
    topps = np.full(b, 0.9, np.float32)

    def run(eng, temps, bursts=(1, 4, 2)):
        """The ids of every dispatch, and each dispatch's last logits (a
        tensor of its own: a later dispatch must not overwrite it)."""
        h = eng.slot_step_async(tokens, pos0, n_valid, temps_np=temps, topps_np=topps,
                                page_tables_np=table)
        outs, pos, logits = [h.wait()], pos0 + n_valid, [eng.last_logits]
        for steps in bursts:
            h = eng.slot_step_async(None, pos, np.ones(b, np.int32), temps_np=temps,
                                    topps_np=topps, steps=steps, page_tables_np=table,
                                    feed_dev=h.last_dev)
            outs.append(h.wait())
            logits.append(eng.last_logits)
            pos = pos + steps
        return np.concatenate(outs), torch.stack(logits)

    for temps in (np.zeros(b, np.float32), np.array([0.0, 0.8, 1.1], np.float32)):
        eager = Engine(tcfg, tp, device="cpu", **kw)
        body = _body_engine(tcfg, tp, **kw)
        for e in (eager, body):
            e._gen.manual_seed(5)
        ids_e, log_e = run(eager, temps)
        ids_b, log_b = run(body, temps)
        np.testing.assert_array_equal(ids_b, ids_e)
        _close(log_b, log_e)
        assert body.graphs.eager_steps == 8 and body.slot_decode_forwards == 7
    jeng = _jax_engine(jcfg, jp, **jkw)
    h = jeng.slot_step_async(tokens, pos0, n_valid, temps_np=np.zeros(b, np.float32),
                             topps_np=topps, page_tables_np=table)
    jouts, pos = [h.wait()], pos0 + n_valid
    for steps in (1, 4, 2):
        h = jeng.slot_step_async(None, pos, np.ones(b, np.int32),
                                 temps_np=np.zeros(b, np.float32), topps_np=topps,
                                 steps=steps, page_tables_np=table, feed_dev=h.last_dev)
        jouts.append(h.wait())
        pos = pos + steps
    body = _body_engine(tcfg, tp, **kw)
    ids_b, log_b = run(body, np.zeros(b, np.float32))
    np.testing.assert_array_equal(ids_b, np.concatenate(jouts))


def test_captures_hold_the_collector_off():
    """Python's cyclic collector stays off while any capture runs, also when
    captures on two threads overlap, and is restored after the last."""
    import gc
    import threading

    from dllama_tpu_torch.runtime.graphs import _no_collection
    assert gc.isenabled()
    inside, go = threading.Event(), threading.Event()
    seen = []

    def other():
        with _no_collection():
            inside.set()
            go.wait(10)
            seen.append(gc.isenabled())

    th = threading.Thread(target=other)
    with _no_collection():
        th.start()
        assert inside.wait(10)
        seen.append(gc.isenabled())
    seen.append(gc.isenabled())  # the other capture still runs
    go.set()
    th.join(10)
    assert not th.is_alive()
    assert seen == [False, False, False] and gc.isenabled()
