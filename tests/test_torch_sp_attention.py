"""Sequence parallelism on the CPU: the port's ``ops/sp_attention.py`` (the
sp ranks' tensors as lists, every rank on the CPU, the combine's sums
through kernel 4's plain version) against the JAX package's shard_map
functions on its virtual CPU mesh, and the Engine on an sp mesh against
the JAX Engine on the same mesh and against the port's sp = 1.

Tolerances: the ops at rtol = atol = 1e-5, as ``tests/test_sp_attention.py``
holds the JAX package's against single-device attention (f32 inputs; the
two differ in summation order only); engine logits at 1e-4 abs / 1e-3 rel
(the JAX test's), the ring prefill's at 1e-4 + 1e-4·max; greedy tokens
equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from dllama_tpu.models import config as jconfig
from dllama_tpu.ops import sp_attention as jsp
from dllama_tpu.ops.attention import update_kv_cache_at as jupdate
from dllama_tpu.parallel.mesh import make_mesh as jmake_mesh
from dllama_tpu.runtime.engine import Engine as JEngine
from dllama_tpu.sampling import Sampler
from dllama_tpu_torch.models import config as tconfig, params as tparams
from dllama_tpu_torch.ops import attention, q40, sp_attention as tsp
from dllama_tpu_torch.parallel.mesh import make_mesh
from dllama_tpu_torch.runtime.engine import Engine

TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(b=1, hq=4, hkv=2, s=32, dh=8, t=1, seed=0):
    r = np.random.RandomState(seed)
    return (r.randn(b, hq, t, dh).astype(np.float32), r.randn(b, hkv, s, dh).astype(np.float32),
            r.randn(b, hkv, s, dh).astype(np.float32))


def _shards(a: np.ndarray, sp: int, axis: int = 2) -> list:
    return [torch.from_numpy(c.copy()) for c in np.split(a, sp, axis=axis)]


def _port_sp_gqa(q, k, v, pos, t, sp, tp=1):
    """The port's sp_gqa_attention over ``sp`` shards for each of ``tp``
    head slices, the slices' outputs joined on the head axis."""
    outs = []
    for qh, kh, vh in zip(np.split(q, tp, 1), np.split(k, tp, 1), np.split(v, tp, 1)):
        qs = [torch.from_numpy(qh.copy()) for _ in range(sp)]
        got = tsp.sp_gqa_attention(qs, _shards(kh, sp), _shards(vh, sp), pos, t)
        for g in got[1:]:  # every shard holds the combined output (each rank
            # adds the partials in kernel 4's ring order from its own)
            torch.testing.assert_close(g, got[0], **TOL)
        outs.append(got[0].numpy())
    return np.concatenate(outs, axis=1)


def _jax_sp_gqa(q, k, v, pos, t, sp, tp=1):
    mesh = jmake_mesh(tp=tp, sp=sp, dp=1, devices=jax.devices()[:sp * tp])
    return np.asarray(jax.jit(lambda q, k, v: jsp.sp_gqa_attention(
        q, k, v, jnp.int32(pos), t, mesh))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))


@pytest.mark.parametrize("sp,pos,t", [
    (2, 0, 1), (2, 15, 1), (2, 16, 1), (2, 31, 1), (4, 7, 1), (4, 8, 1), (8, 17, 1),
    (8, 3, 8), (4, 5, 8), (2, 12, 8), (8, 24, 8)])
def test_sp_gqa_attention_matches_jax(sp, pos, t):
    """Decode and continuations at positions on and around the shard edges
    (chunk 32/sp), windows that straddle one: equal to the JAX package's
    one-round combine and to the port's single-device attention."""
    q, k, v = _qkv(s=32, t=t, seed=sp + pos)
    got = _port_sp_gqa(q, k, v, pos, t, sp)
    np.testing.assert_allclose(got, _jax_sp_gqa(q, k, v, pos, t, sp), **TOL)
    ref = attention.gqa_attention(*map(torch.from_numpy, (q, k, v)), pos, t)
    np.testing.assert_allclose(got, ref.numpy(), **TOL)


@pytest.mark.parametrize("pos", [0, 100, 4095, 4096, 8191, 16383])
def test_blocked_long_chunk_matches_jax(pos):
    """Chunks of 4096 positions (16384 over sp = 4) take the per-shard walk
    over the live blocks alone (``_local_partials_blocked`` through
    ``blocked_live_fold``'s ``base``): the JAX package's numbers at every
    position class, block and shard edges included."""
    q, k, v = _qkv(s=16384, t=1, seed=pos % 7)
    assert attention._use_blocked_decode(1, 4096)
    got = _port_sp_gqa(q, k, v, pos, 1, 4)
    np.testing.assert_allclose(got, _jax_sp_gqa(q, k, v, pos, 1, 4), **TOL)


def test_blocked_live_fold_base_offsets_the_walk():
    """A shard's walk from its chunk start equals the partials of the whole
    chunk folded at once; ``base`` 0 is the function's former walk."""
    q, k, v = _qkv(s=8192, t=1, seed=3)
    qf = torch.from_numpy(q).reshape(1, 2, 2, 1, 8)
    kc, vc = torch.from_numpy(k[:, :, 4096:]), torch.from_numpy(v[:, :, 4096:])
    for pos in (4096, 5000, 8191, 100000):
        m, l, acc = attention.blocked_live_fold(qf, tsp._slice_seq, kc, vc, pos, 4096,
                                                base=4096)
        o2, l2, m2 = tsp._local_partials(qf, kc, vc, pos, 1, 4096)
        np.testing.assert_allclose((acc / l[..., None]).numpy(),
                                   (o2 / l2[..., None]).numpy(), **TOL)
    whole = attention.blocked_live_fold(qf, tsp._slice_seq, torch.from_numpy(k),
                                        torch.from_numpy(v), 5000, 8192)
    based = attention.blocked_live_fold(qf, tsp._slice_seq, torch.from_numpy(k),
                                        torch.from_numpy(v), 5000, 8192, base=0)
    for a, b in zip(whole, based):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_sp4_tp2_matches_jax():
    """Heads on tp, the sequence on sp (a 2 x 4 mesh)."""
    q, k, v = _qkv(hq=4, hkv=2, s=32, t=1)
    got = _port_sp_gqa(q, k, v, 9, 1, 4, tp=2)
    np.testing.assert_allclose(got, _jax_sp_gqa(q, k, v, 9, 1, 4, tp=2), **TOL)


def test_empty_shards_no_nan():
    """pos 0 over sp = 8: only shard 0 has a live key; the other seven
    contribute the empty partials (no KV read), exact zeros after the
    rescale, not NaN."""
    q, k, v = _qkv(s=64)
    got = _port_sp_gqa(q, k, v, 0, 1, 8)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _jax_sp_gqa(q, k, v, 0, 1, 8), **TOL)


@pytest.mark.parametrize("pos", [0, 7, 8, 31])
def test_shard_local_write_equals_plain_update(pos):
    """The decode write on sp = 4 shards (each tp = 2 rank's heads): only
    the owner's chunk changes, and the shards joined equal the plain
    update and the JAX package's shard-local write, bit for bit."""
    r = np.random.RandomState(pos)
    kc, vc = (r.randn(3, 1, 2, 32, 8).astype(np.float32) for _ in range(2))
    kn, vn = (r.randn(1, 2, 1, 8).astype(np.float32) for _ in range(2))
    ek, ev = attention.update_kv_cache_at(torch.from_numpy(kc.copy()),
                                          torch.from_numpy(vc.copy()),
                                          torch.from_numpy(kn), torch.from_numpy(vn), 1, pos)
    jk, jv = jupdate(jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(kn), jnp.asarray(vn),
                     jnp.int32(1), jnp.int32(pos))
    mesh = jmake_mesh(tp=2, sp=4, dp=1, devices=jax.devices()[:8])
    gk, gv = jax.jit(lambda *a: jsp.sp_update_kv_cache_at(*a, jnp.int32(1), jnp.int32(pos),
                                                          mesh))(kc, vc, kn, vn)
    np.testing.assert_array_equal(np.asarray(gk), np.asarray(jk))
    for t in range(2):  # each tp rank's head
        ks = _shards(kc[:, :, t:t + 1], 4, axis=3)
        vs = _shards(vc[:, :, t:t + 1], 4, axis=3)
        before = [x.clone() for x in ks]
        tsp.sp_update_kv_cache_at(ks, vs, torch.from_numpy(kn[:, t:t + 1]),
                                  torch.from_numpy(vn[:, t:t + 1]), 1, pos)
        for s in range(4):
            if s != pos // 8:
                torch.testing.assert_close(ks[s], before[s], rtol=0, atol=0)
        np.testing.assert_array_equal(torch.cat(ks, 3).numpy(), ek[:, :, t:t + 1].numpy())
        np.testing.assert_array_equal(torch.cat(vs, 3).numpy(), ev[:, :, t:t + 1].numpy())
        np.testing.assert_array_equal(torch.cat(ks, 3).numpy(), np.asarray(gk)[:, :, t:t + 1])
        np.testing.assert_array_equal(torch.cat(vs, 3).numpy(), np.asarray(gv)[:, :, t:t + 1])


def test_multi_token_write_rejected():
    kc = [torch.zeros(2, 1, 2, 8, 8) for _ in range(4)]
    kn = torch.zeros(1, 2, 3, 8)  # T = 3: could straddle shards
    with pytest.raises(ValueError, match="one decode step"):
        tsp.sp_update_kv_cache_at(kc, kc, kn, kn, 0, 0)


@pytest.mark.parametrize("pos,t", [(0, 32), (5, 3), (6, 4), (14, 12)])
def test_window_write_cut_over_shards(pos, t):
    """A T > 1 window at any position, straddling shard edges (chunk 8):
    the shards joined equal the plain update."""
    r = np.random.RandomState(t)
    kc = r.randn(2, 1, 2, 32, 8).astype(np.float32)
    kn = r.randn(1, 2, t, 8).astype(np.float32)
    ek, _ = attention.update_kv_cache_at(torch.from_numpy(kc.copy()), torch.from_numpy(kc.copy()),
                                         torch.from_numpy(kn), torch.from_numpy(kn), 1, pos)
    ks, vs = _shards(kc, 4, axis=3), _shards(kc, 4, axis=3)
    tsp.sp_update_kv_window_at(ks, vs, torch.from_numpy(kn), torch.from_numpy(kn), 1, pos)
    np.testing.assert_array_equal(torch.cat(ks, 3).numpy(), ek.numpy())
    np.testing.assert_array_equal(torch.cat(vs, 3).numpy(), ek.numpy())


def _jax_ring(q, k, v, sp, tp=1, pos0=0):
    mesh = jmake_mesh(tp=tp, sp=sp, dp=1, devices=jax.devices()[:sp * tp])
    return np.asarray(jax.jit(lambda q, k, v: jsp.ring_attention(
        q, k, v, mesh, pos0=pos0, q_spec=P("dp", "tp", "sp", None)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))


def _port_ring(q, k, v, sp, tp=1, pos0=0):
    outs = []
    for qh, kh, vh in zip(np.split(q, tp, 1), np.split(k, tp, 1), np.split(v, tp, 1)):
        got = tsp.ring_attention(_shards(qh, sp), _shards(kh, sp), _shards(vh, sp), pos0)
        outs.append(torch.cat(got, dim=2).numpy())
    return np.concatenate(outs, axis=1)


@pytest.mark.parametrize("sp,t,pos0", [(2, 16, 0), (4, 32, 0), (8, 64, 0), (4, 16, 8)])
def test_ring_attention_matches_jax(sp, t, pos0):
    """Sharded-query prefill over the rotating KV blocks: the JAX package's
    ring and dense causal attention over the window (f64 softmax)."""
    r = np.random.RandomState(1)
    b, hq, hkv, dh = 1, 4, 2, 8
    q = r.randn(b, hq, t, dh).astype(np.float32)
    k, v = (r.randn(b, hkv, t, dh).astype(np.float32) for _ in range(2))
    got = _port_ring(q, k, v, sp, pos0=pos0)
    np.testing.assert_allclose(got, _jax_ring(q, k, v, sp, pos0=pos0), **TOL)
    qf = q.astype(np.float64).reshape(b, hkv, hq // hkv, t, dh)
    scores = np.einsum("bhgtd,bhsd->bhgts", qf, k.astype(np.float64)) / np.sqrt(dh)
    scores = np.where(np.tril(np.ones((t, t), bool)), scores, -np.inf)
    p = np.exp(scores - scores.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    ref = np.einsum("bhgts,bhsd->bhgtd", p, v.astype(np.float64)).reshape(b, hq, t, dh)
    np.testing.assert_allclose(got, ref, **TOL)


def test_ring_with_tp_matches_jax():
    r = np.random.RandomState(2)
    q = r.randn(1, 4, 32, 8).astype(np.float32)
    k, v = (r.randn(1, 2, 32, 8).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(_port_ring(q, k, v, 4, tp=2), _jax_ring(q, k, v, 4, tp=2), **TOL)


def test_ring_skips_future_blocks(monkeypatch):
    """Shard ``my`` folds the blocks of shards 0..my (in the ring's order,
    newest first) and never a block of its future."""
    seen = []
    real = tsp._local_partials

    def spy(q, k, v, pos, q_len, chunk_start):
        seen.append((pos, chunk_start))
        return real(q, k, v, pos, q_len, chunk_start)

    monkeypatch.setattr(tsp, "_local_partials", spy)
    q, k, v = _qkv(s=16, t=16)
    tsp.ring_attention(_shards(q, 4), _shards(k, 4), _shards(v, 4))
    assert seen == [(4 * my, 4 * ((my - i) % 4)) for my in range(4) for i in range(4)
                    if (my - i) % 4 <= my]


# -- the Engine on an sp mesh ------------------------------------------------

KW = dict(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=2,
          vocab_size=128, seq_len=64)


def _pair(seed, **kw):
    cfg = dict(KW, **kw)
    tcfg, jcfg = tconfig.tiny_config(**cfg), jconfig.tiny_config(**cfg)
    from test_torch_tp import _to_jax
    p = tparams.init_params(tcfg, seed=seed)
    return tcfg, jcfg, p, _to_jax(p)


def _jax_greedy(engine, prompt, steps):
    s = Sampler(engine.cfg.vocab_size, 0.0, 0.9, 0)
    return [t for t, _ in engine.generate(prompt, steps=steps, sampler=s)]


def _greedy(engine, prompt, steps):
    return [t for t, _ in engine.generate_stream(prompt, steps, temperature=0.0, chunk=4)]


def test_engine_sp4_tp2_greedy_matches_jax_and_sp1():
    """An sp = 4 x tp = 2 engine generates the JAX package's greedy tokens
    on the same mesh and the port's sp = 1 tokens; its decode steps run
    the one-round combine (kernel 4's plain version over the sp group)."""
    tcfg, jcfg, p, jp = _pair(1)
    q40.reset_counters()
    eng = Engine(tcfg, p, device="cpu", mesh=make_mesh(2, "cpu", sp=4))
    got = _greedy(eng, [5, 9, 2], 12)
    assert q40.counters()["allreduce_plain_calls"] > 0
    assert got == _greedy(Engine(tcfg, p, device="cpu"), [5, 9, 2], 12)
    jmesh = jmake_mesh(tp=2, sp=4, dp=1, devices=jax.devices()[:8])
    assert got == _jax_greedy(JEngine(jcfg, jp, mesh=jmesh), [5, 9, 2], 12)


def test_engine_ring_prefill_sp8_logits(monkeypatch):
    """A 40-token prompt (bucket 64, sp = 8 divides it) prefills through
    the ring: its logits within 1e-4 + 1e-4·max of sp = 1's and of the JAX
    engine's ring, and the cache it wrote serves the next decode step."""
    tcfg, jcfg, p, jp = _pair(2, seq_len=128)
    prompt = np.random.RandomState(0).randint(1, 128, 40).tolist()
    calls = []
    real = tsp.ring_attention
    import dllama_tpu_torch.models.transformer as tr
    monkeypatch.setattr(tr, "ring_attention", lambda *a, **k: calls.append(1) or real(*a, **k))
    e1 = Engine(tcfg, p, device="cpu")
    esp = Engine(tcfg, p, device="cpu", mesh=make_mesh(1, "cpu", sp=8))
    l1, _ = e1.prefill(prompt[:])
    lsp, _ = esp.prefill(prompt[:])
    assert len(calls) == tcfg.n_layers and esp.pos == len(prompt)
    tol = 1e-4 + 1e-4 * np.abs(l1).max()
    np.testing.assert_allclose(lsp, l1, rtol=0, atol=tol)
    jmesh = jmake_mesh(tp=1, sp=8, dp=1, devices=jax.devices()[:8])
    lj, _ = JEngine(jcfg, jp, mesh=jmesh).prefill(prompt[:])
    np.testing.assert_allclose(lsp, lj, rtol=0, atol=tol)
    d1, _ = e1.decode_one(int(l1[0].argmax()))
    dsp, _ = esp.decode_one(int(lsp[0].argmax()))
    np.testing.assert_allclose(dsp, d1, rtol=0, atol=tol)
    assert len(calls) == tcfg.n_layers  # a decode step takes the combine


def test_engine_sp_multi_turn_continuation():
    """A second turn's prefill (pos > 0, T > 1: the window written over the
    shards it falls in, then the one-round combine) equals one full
    prefill, and both the single-device engine's and the JAX engine's."""
    tcfg, jcfg, p, jp = _pair(4, hidden_dim=96)
    mesh = make_mesh(1, "cpu", sp=4)
    e = Engine(tcfg, p, device="cpu", mesh=mesh)
    e.prefill([4, 7, 1])
    l_cont, _ = e.prefill([9, 3])
    l_full, _ = Engine(tcfg, p, device="cpu", mesh=mesh).prefill([4, 7, 1, 9, 3])
    np.testing.assert_allclose(l_cont, l_full, atol=1e-4, rtol=1e-3)
    l_ref, _ = Engine(tcfg, p, device="cpu").prefill([4, 7, 1, 9, 3])
    np.testing.assert_allclose(l_full, l_ref, atol=1e-4, rtol=1e-3)
    jmesh = jmake_mesh(tp=1, sp=4, dp=1, devices=jax.devices()[:4])
    je = JEngine(jcfg, jp, mesh=jmesh)
    je.prefill([4, 7, 1])
    np.testing.assert_allclose(l_cont, je.prefill([9, 3])[0], atol=1e-4, rtol=1e-3)


def test_engine_sp_long_cache_blocked_decode():
    """seq 16384 over sp = 4: each shard's chunk (4096) crosses the blocked
    decode threshold, so decode walks each shard's live blocks; greedy
    tokens equal sp = 1's."""
    tcfg, _, p, _ = _pair(3, dim=32, hidden_dim=64, vocab_size=64, seq_len=16384)
    got = _greedy(Engine(tcfg, p, device="cpu", mesh=make_mesh(1, "cpu", sp=4)), [5, 9, 2], 8)
    assert got == _greedy(Engine(tcfg, p, device="cpu"), [5, 9, 2], 8)


def test_sp_cache_layout_and_snapshot(tmp_path):
    """Each sp rank holds seq_len/sp positions; a snapshot joins the shards
    into the global cache (the sp = 1 engine's bytes) and restores."""
    tcfg, _, p, _ = _pair(5)
    eng = Engine(tcfg, p, device="cpu", mesh=make_mesh(2, "cpu", sp=2))
    assert [tuple(c.k.shape) for c in eng.cache.ranks] == [(2, 1, 1, 32, 16)] * 4
    one = Engine(tcfg, p, device="cpu")
    for e in (eng, one):
        e.prefill([3, 1, 4, 1, 5])
    assert eng.kv_layout() == one.kv_layout()
    path = eng.snapshot(tmp_path / "sp.snap")
    fresh = Engine(tcfg, p, device="cpu", mesh=make_mesh(2, "cpu", sp=2))
    fresh.restore(path)
    for a, b in zip(fresh.cache.ranks, eng.cache.ranks):
        torch.testing.assert_close(a.k, b.k, rtol=0, atol=0)
    np.testing.assert_allclose(eng._global(eng.kv_planes()["k"]).numpy(),
                               one.cache.k.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("what,match", [
    ("seq", "seq_len 60 not divisible by sp=8"),
    ("q8", "quantized KV cache is not supported on sp meshes"),
    ("paged", "paged KV is not supported on sp meshes"),
    ("ragged", "ragged batches are not supported on sp meshes"),
    ("slot", "slot serving is not supported on sp meshes"),
    ("score", "score_batch is not supported on sp meshes"),
    ("pld", "speculative decode is not supported on sp meshes")])
def test_sp_refusals_carry_jax_messages(what, match):
    tcfg, _, p, _ = _pair(6)
    mesh = make_mesh(1, "cpu", sp=8 if what == "seq" else 2)
    kw = {"seq": dict(seq_len=60), "q8": dict(kv_dtype="q8"),
          "paged": dict(kv_pages=8, kv_page_size=4, batch=2),
          "ragged": dict(batch=2)}.get(what, {})
    with pytest.raises(ValueError, match=match):
        eng = Engine(tcfg, p, device="cpu", mesh=mesh, **kw)
        if what == "ragged":
            eng.prefill_ragged([[1, 2], [3]])
        elif what == "slot":
            one = np.ones(1, np.int32)
            eng.slot_step(np.ones((1, 1), np.int32), one * 0, one, temps_np=one * 0.0,
                          topps_np=one * 0.9)
        elif what == "score":
            eng.score_batch([[1, 2, 3]])
        elif what == "pld":
            eng.generate_pld([1, 2, 3], 8)


def test_server_sp2_without_slots_answers_what_sp1_answers(tmp_path):
    """The API server takes ``--sp`` without ``--batch-slots``: the batch-1
    engine runs the requests (the ring prefill, then the combine), and a
    greedy completion and a greedy chat equal the sp = 1 server's."""
    import json
    import urllib.request

    from dllama_tpu import quants
    from dllama_tpu_torch.server import api
    from fixtures import write_tiny_model, write_tiny_tokenizer

    m, t = tmp_path / "tiny.m", tmp_path / "tiny.t"
    write_tiny_model(m, ftype=quants.Q40)
    write_tiny_tokenizer(t)
    bodies = [("/v1/completions", {"prompt": "hello hi", "max_tokens": 12, "temperature": 0}),
              ("/v1/chat/completions", {"messages": [{"role": "user", "content": "hi"}],
                                        "max_tokens": 8, "temperature": 0})]
    answers = {}
    for sp in (1, 2):
        srv = api.start(["--model", str(m), "--tokenizer", str(t), "--device", "cpu",
                         "--buffer-float-type", "f32", "--host", "127.0.0.1", "--port", "0",
                         "--sp", str(sp)])
        try:
            assert srv.state.engine.sp == sp and srv.state.batch_engine is None
            base = f"http://127.0.0.1:{srv.server_address[1]}"
            out = []
            for path, body in bodies:
                req = urllib.request.Request(base + path, json.dumps(body).encode(),
                                             headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=120) as r:
                    ch = json.loads(r.read())["choices"][0]
                out.append(ch.get("text") or ch["message"]["content"])
            answers[sp] = out
        finally:
            api.stop(srv)
    assert answers[2] == answers[1] and all(answers[2])
