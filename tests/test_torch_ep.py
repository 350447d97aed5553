"""Expert parallelism on the CPU: MoE expert stacks cut over the mesh's ep
axis (every rank on the CPU, kernel 4's plain version for the sums), the
port's ``q40.ep_matmul`` against the JAX package's ``_sharded_matmul_ep``
in Pallas interpret mode, and the Engine at ep × tp against the JAX Engine
on the same mesh and against the port's ep = 1.

Tolerances: the matmul and packed experts at 1e-3 + 1e-3·max (the JAX
package's ``tests/test_moe_q40.py``); dense experts at 1e-4 abs / 1e-3
rel; greedy tokens equal.
"""

import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu import quants
from dllama_tpu.io import mfile
from dllama_tpu.ops import q40 as jq40
from dllama_tpu.parallel.mesh import make_mesh as jmake_mesh
from dllama_tpu.runtime.engine import Engine as JEngine
from dllama_tpu_torch.io import mfile as tmfile
from dllama_tpu_torch.models import config as tconfig, params as tparams
from dllama_tpu_torch.ops import q8 as tq8, q40 as tq40
from dllama_tpu_torch.parallel import sharding
from dllama_tpu_torch.parallel.mesh import make_mesh
from dllama_tpu_torch.runtime.engine import Engine
from fixtures import write_tiny_model, write_tiny_tokenizer
from test_torch_tp import _jax_greedy, _greedy, _model, _to_jax

# the JAX package's ep test model (tests/test_moe_q40.py)
MOE = dict(n_experts=4, n_active_experts=2, dim=256, hidden_dim=256, n_layers=2,
           n_heads=8, n_kv_heads=8, vocab_size=128, seq_len=32)
PROMPT = [1, 2, 3]


def _band(ref) -> float:
    return 1e-3 + 1e-3 * float(np.abs(np.asarray(ref)).max())


def _stack(seed, L=2, E=4, n=256, d=256, nan_from=None):
    rng = np.random.RandomState(seed)
    qt = tq40.quantize((rng.randn(L, E, n, d) * 0.1).astype(np.float32))
    if nan_from is not None:  # f16 NaN bits in every expert from ``nan_from`` on
        sc = qt.scales.clone()
        sc.view(torch.int16)[:, nan_from:] = 0x7E00
        qt = tq40.QTensor(qt.qpacked, sc, qt.logical_nd)
    return qt


def _port_ep(x: torch.Tensor, qt, flat: int, kind: str, ep: int, tp: int) -> list:
    """``ep_matmul`` over an ep × tp mesh's ranks; returns each rank's output."""
    mesh = make_mesh(tp, "cpu", ep=ep)
    ws, xs = [], []
    n = qt.logical_nd[0]
    for r in mesh.ranks:
        _, _, e, t = mesh.coords(r)
        w = sharding.shard_experts(qt, e, ep)
        ws.append(w if tp == 1 else sharding.shard(w, kind, t, tp))
        xs.append(x if kind == "row" or tp == 1 else x[:, t * n // tp:(t + 1) * n // tp])
    return tq40.ep_matmul(xs, ws, flat, kind, ep)


def _jax_ep(x: torch.Tensor, qt, flat: int, kind: str, ep: int, tp: int):
    mesh = jmake_mesh(tp=tp, ep=ep, devices=jax.devices()[:ep * tp])
    xj = jnp.asarray(x.numpy()).astype(jnp.bfloat16)
    return np.asarray(jq40._sharded_matmul_ep(
        xj, jnp.asarray(qt.qpacked.numpy()), jnp.asarray(qt.scales.numpy().view(np.uint16)),
        jnp.int32(flat), kind, mesh, interp=True))


@pytest.mark.parametrize("kind", ["row", "col"])
@pytest.mark.parametrize("ep,tp", [(2, 1), (4, 1), (2, 2), (4, 2)])
def test_ep_matmul_matches_jax(kind, ep, tp):
    """Row (up/gate) and col (down) products of experts owned by each shard
    in turn: equal to the JAX package's owner-only matmul and psum, every
    ep shard holding the same sum (a row rank its tp slice)."""
    qt = _stack(ep * 10 + tp)
    x = torch.from_numpy(np.random.RandomState(tp).randn(3, 256).astype(np.float32))
    for flat in (0, 3, 5, 6):  # layer 0 experts 0 and 3, layer 1 experts 1 and 2
        got = _port_ep(x, qt, flat, kind, ep, tp)
        ref = _jax_ep(x, qt, flat, kind, ep, tp)
        whole = got[0] if kind == "col" else torch.cat(got[:tp], dim=-1)
        np.testing.assert_allclose(whole.numpy(), ref, rtol=0, atol=_band(ref))
        for r, g in enumerate(got):
            same = got[r % tp] if kind == "row" else got[0]
            torch.testing.assert_close(g, same, rtol=1e-6, atol=1e-6)


def test_ep_non_owner_reads_no_tile():
    """Every expert but expert 0 carries NaN scales: a shard that read a
    clamped plane of its own would poison the sum with 0·NaN.  The owner
    alone runs (one plain matmul), the product is finite and right — the
    JAX package's ``test_ep_non_owner_shards_skip_expert_reads``."""
    qt = _stack(0, L=1, E=2, n=64, d=128, nan_from=1)
    x = torch.from_numpy(np.random.RandomState(0).randn(1, 64).astype(np.float32))
    tq40.reset_counters()
    out = _port_ep(x, qt, 0, "row", 2, 1)
    assert tq40.counters()["plain_calls"] == 1
    assert all(torch.isfinite(o).all() for o in out)
    ref = x.to(torch.bfloat16).float() @ tq40.dequantize(qt, layer=0)
    np.testing.assert_allclose(out[0].numpy(), ref.numpy(), rtol=0,
                               atol=1e-2 * float(ref.abs().max()))
    j = _jax_ep(x, qt, 0, "row", 2, 1)
    assert np.isfinite(j).all()
    np.testing.assert_allclose(out[1].numpy(), j, rtol=0, atol=_band(j))


@pytest.mark.parametrize("codec", ["dense", "q40"])
@pytest.mark.parametrize("ep,tp", [(4, 2), (2, 2), (2, 1)])
def test_engine_ep_matches_jax(codec, ep, tp):
    """Prefill (the all-experts route) and two decode steps (the selected
    experts) on an ep × tp mesh against the JAX Engine on the same mesh;
    greedy tokens equal to JAX's and to the port's ep = 1."""
    tcfg, jcfg, p = _model(MOE, codec, arch=mfile.ARCH_MIXTRAL, seed=4)
    jp = _to_jax(p)
    te = Engine(tcfg, p, device="cpu", mesh=make_mesh(tp, "cpu", ep=ep))
    je = JEngine(jcfg, jp, mesh=jmake_mesh(tp=tp, ep=ep, devices=jax.devices()[:ep * tp]))

    def close(a, b):
        if codec == "dense":
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-3)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=_band(b))

    tq40.reset_counters()
    close(te.prefill(PROMPT)[0], je.prefill(PROMPT)[0])
    for tok in (7, 2):
        close(te.decode_one(tok)[0], je.decode_one(tok)[0])
    assert tq40.counters()["allreduce_plain_calls"] > 0
    te.reset()
    je = JEngine(jcfg, jp, mesh=jmake_mesh(tp=tp, ep=ep, devices=jax.devices()[:ep * tp]))
    ours = _greedy(te, 10)
    assert ours == _greedy(Engine(tcfg, p, device="cpu"), 10)
    assert ours == _jax_greedy(je, 10)


@pytest.mark.parametrize("ep,tp", [(2, 1), (2, 2), (4, 1)])
def test_engine_ep_q80_experts_match_ep1(ep, tp):
    """Q80 experts take the owner-only route too (the JAX package runs them
    through XLA on a mesh): the port's ep = 1 logits and greedy tokens, and
    the JAX package's single-device ones."""
    tcfg, jcfg, p = _model(MOE, "q80", arch=mfile.ARCH_MIXTRAL, seed=5)
    one = Engine(tcfg, p, device="cpu")
    te = Engine(tcfg, p, device="cpu", mesh=make_mesh(tp, "cpu", ep=ep))
    assert isinstance(te.params.ranks[0]["up"], tq8.Q8Tensor)
    tq8.reset_counters()
    l1, lt = one.prefill(PROMPT)[0], te.prefill(PROMPT)[0]
    np.testing.assert_allclose(lt, l1, rtol=0, atol=_band(l1))
    jl = JEngine(jcfg, _to_jax(p), mesh=jmake_mesh(tp=1, devices=jax.devices()[:1])).prefill(
        PROMPT)[0]
    np.testing.assert_allclose(lt, jl, rtol=0, atol=_band(jl))
    d1, dt = one.decode_one(7)[0], te.decode_one(7)[0]
    np.testing.assert_allclose(dt, d1, rtol=0, atol=_band(d1))
    assert tq8.counters()["plain_calls"] > 0
    one.reset()
    te.reset()
    assert _greedy(te, 10) == _greedy(one, 10)


def test_ep_decode_runs_each_selected_expert_once():
    """A single-token forward at ep = 2 runs as many expert matmuls as at
    ep = 1 (3 a selected expert: the owner alone), the attention and head
    matmuls once (the expert shards share the stream), and sums with
    kernel 4 (the plain version here)."""
    tcfg, _, p = _model(MOE, "q40", arch=mfile.ARCH_MIXTRAL, seed=6)
    counts = {}
    for ep in (1, 2):
        eng = Engine(tcfg, p, device="cpu", mesh=make_mesh(1, "cpu", ep=ep))
        eng.prefill(PROMPT)
        tq40.reset_counters()
        eng.decode_one(7)
        counts[ep] = tq40.counters()
    assert counts[2]["plain_calls"] == counts[1]["plain_calls"] == \
        (2 + 3 * tcfg.n_active_experts) * tcfg.n_layers + 1
    # each selected expert: gate and up summed over ep, down over ep too
    assert counts[2]["allreduce_plain_calls"] == 3 * tcfg.n_active_experts * tcfg.n_layers
    assert counts[1]["allreduce_plain_calls"] == 0


def test_ep_placement_holds_each_expert_once():
    """ep = 4 on one device: a rank holds E/ep experts of each stack, the
    four shards together the model's expert bytes once; every other leaf
    is one tensor the ranks share; tp = 1 keeps wqkv fused."""
    tcfg, _, p = _model(MOE, "q40", arch=mfile.ARCH_MIXTRAL, seed=7)
    placed = sharding.place_params(p, tcfg, make_mesh(1, "cpu", ep=4))
    for k in sharding.EXPERT_KEYS:
        shards = [r[k] for r in placed.ranks]
        assert all(s.qpacked.shape[1] == 1 for s in shards)
        assert sum(s.qpacked.numel() for s in shards) == p[k].qpacked.numel()
        for e, s in enumerate(shards):
            assert torch.equal(s.qpacked, p[k].qpacked[:, e:e + 1])
    for k in placed.ranks[0]:
        if k not in sharding.EXPERT_KEYS:
            assert all(r[k] is placed.ranks[0][k] for r in placed.ranks), k
    assert "wqkv" in placed.ranks[0] and placed.kinds["wqkv"] is None


def test_load_placed_reads_only_own_experts(tmp_path, monkeypatch):
    """``load_placed`` over ep = 2 x tp = 2 equals ``place_params`` of the
    whole file bit for bit, and reads each rank's experts' bytes alone."""
    path = tmp_path / "mix.m"
    write_tiny_model(path, arch=mfile.ARCH_MIXTRAL, ftype=quants.Q40, n_experts=4)
    mesh = make_mesh(2, "cpu", ep=2)
    with tmfile.MFile(str(path)) as mf:
        cfg = tconfig.ModelConfig.from_spec(mf.spec)
        cfg = cfg.with_(hidden_dim=cfg.hidden_dim)
        _, whole = tparams.load_params(mf, cfg, fuse=False)
        reads = []
        real = mf.raw
        monkeypatch.setattr(mf, "raw", lambda name: reads.append(name) or real(name))
        got = tparams.load_placed(mf, cfg, mesh)
    want = sharding.place_params(whole, cfg, mesh)
    for a, b in zip(got.ranks, want.ranks):
        assert a.keys() == b.keys()
        for k in a:
            x, y = a[k], b[k]
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, y), k
            else:
                assert torch.equal(x.qpacked, y.qpacked) and torch.equal(x.scales, y.scales), k
    # each expert tensor is read by the two tp slices of its owning shard
    expert_reads = [n for n in reads if ".experts." in n]
    assert len(expert_reads) == 2 * len(set(expert_reads)) == 2 * 2 * 4 * 3


def test_ep_slot_path_paged_matches_ep1():
    """The slot step at ep = 2 over a paged pool (the server's path: a
    ragged prefill chunk, then decode steps): ep = 1's tokens and logits."""
    tcfg, _, p = _model(MOE, "q40", arch=mfile.ARCH_MIXTRAL, seed=9)
    b, t, pages = 2, 6, 8
    ptab = (1 + np.arange(b * pages, dtype=np.int32)).reshape(b, pages)
    toks = np.random.RandomState(3).randint(3, tcfg.vocab_size, (b, t)).astype(np.int32)
    n_valid = np.array([6, 2], np.int32)
    zeros = np.zeros(b, np.float32)
    runs = []
    for ep in (1, 2):
        eng = Engine(tcfg, p, device="cpu", batch=b, kv_pages=1 + b * pages, kv_page_size=4,
                     mesh=make_mesh(1, "cpu", ep=ep))
        ids = eng.slot_step(toks, np.zeros(b, np.int32), n_valid, temps_np=zeros,
                            topps_np=zeros + 0.9, page_tables_np=ptab, steps=3)
        runs.append((ids, eng.last_logits.numpy()))
    assert np.array_equal(runs[0][0], runs[1][0])
    np.testing.assert_allclose(runs[1][1], runs[0][1], rtol=0, atol=_band(runs[0][1]))


def test_ep_refusals():
    """The JAX Engine's: ep on a dense model, and experts ep does not divide."""
    tcfg, _, p = _model(dict(MOE, n_experts=0, n_active_experts=0), "dense")
    with pytest.raises(ValueError, match="MoE"):
        Engine(tcfg, p, device="cpu", mesh=make_mesh(1, "cpu", ep=2))
    tcfg, _, p = _model(MOE, "dense", arch=mfile.ARCH_MIXTRAL)
    with pytest.raises(ValueError, match="divisible"):
        Engine(tcfg, p, device="cpu", mesh=make_mesh(1, "cpu", ep=3))


def _post(base: str, body: dict) -> str:
    req = urllib.request.Request(base + "/v1/completions", json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())["choices"][0]["text"]


def test_server_ep2_answers_what_ep1_answers(tmp_path):
    """The API server at --ep 2 on a Mixtral file: greedy completions through
    2 slots over a paged pool, and a seeded sampled one on the batch-1
    mutex path, answer the ep = 1 server's text."""
    from dllama_tpu_torch.server import api
    m, t = tmp_path / "mix.m", tmp_path / "t.t"
    write_tiny_model(m, arch=mfile.ARCH_MIXTRAL, ftype=quants.Q40, n_experts=4)
    write_tiny_tokenizer(t)
    args = ["--model", str(m), "--tokenizer", str(t), "--device", "cpu", "--temperature", "0",
            "--buffer-float-type", "f32", "--batch-slots", "2", "--kv-pages", "40",
            "--kv-page-size", "4", "--host", "127.0.0.1", "--port", "0"]
    bodies = [{"prompt": p, "max_tokens": 8, "temperature": 0} for p in ("hello", "hi hello")]
    bodies.append({"prompt": "the", "max_tokens": 6, "temperature": 0.8, "seed": 3})
    answers = {}
    for ep in (1, 2):
        srv = api.start(args + ["--ep", str(ep)])
        try:
            base = f"http://127.0.0.1:{srv.server_address[1]}"
            out = [None] * len(bodies)
            threads = [threading.Thread(target=lambda i=i, b=b: out.__setitem__(
                i, _post(base, b))) for i, b in enumerate(bodies)]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            answers[ep] = out
            assert srv.state.engine.ep == ep == srv.state.batch_engine.ep
        finally:
            api.stop(srv)
    assert answers[1] == answers[2] and all(answers[2])
