"""Data parallelism on the CPU: the batch rows cut over the mesh's dp axis
(every rank on the CPU), the port's lockstep batch and single-prompt
streams against the JAX package's on its virtual CPU mesh at the same dp,
and against the port's dp = 1; the CLI's ``--dp``.

Greedy tokens must be equal: a data group runs its rows alone, with the
same weights and sums as one device.
"""

import os

import jax
import numpy as np
import pytest
import torch

from dllama_tpu import quants
from dllama_tpu.io import mfile
from dllama_tpu.parallel.mesh import make_mesh as jmake_mesh
from dllama_tpu.runtime.engine import Engine as JEngine
from dllama_tpu_torch.parallel.mesh import make_mesh
from dllama_tpu_torch.runtime.engine import Engine
from fixtures import run_cli, write_tiny_model, write_tiny_tokenizer
from test_torch_cli import _text, run_port
from test_torch_tp import KW, _model, _to_jax

PROMPTS = [[1, 5, 9, 2, 7], [4, 4], [8, 3, 6], [2, 11, 13, 17, 19, 23]]


def _single(tcfg, p, prompt, steps):
    return [t for t, _ in Engine(tcfg, p, device="cpu").generate_stream(
        prompt, steps, temperature=0.0, chunk=4)]


@pytest.mark.parametrize("codec", ["q40", "dense"])
@pytest.mark.parametrize("dp,tp", [(2, 1), (4, 1), (2, 2)])
def test_ragged_batch_over_dp_matches_single_streams_and_jax(codec, dp, tp):
    """Four ragged prompts over dp data groups (dp = 2 x tp = 2 included):
    each row equals its single stream and the JAX engine's batch on the
    same mesh; each rank's cache holds batch/dp rows."""
    tcfg, jcfg, p = _model(KW, codec)
    eng = Engine(tcfg, p, device="cpu", batch=4, mesh=make_mesh(tp, "cpu", dp=dp))
    assert {c.k.shape[1] for c in eng.cache.ranks} == {4 // dp}
    assert len(eng.cache.ranks) == dp * tp
    outs = eng.generate_batch(PROMPTS, 14, chunk=4)
    assert outs == [_single(tcfg, p, pr, 14) for pr in PROMPTS]
    je = JEngine(jcfg, _to_jax(p), batch=4,
                 mesh=jmake_mesh(tp=tp, dp=dp, devices=jax.devices()[:dp * tp]))
    assert outs == je.generate_batch(PROMPTS, 14, temperature=0.0, chunk=4)


def test_dp_rows_are_replicas_in_single_prompt_modes():
    """A single prompt on a dp = 2 engine runs on both groups' rows (the
    JAX package's replicas): the stream is dp = 1's, both rows' logits
    equal, and a MoE model routes each group on its own first rank."""
    tcfg, _, p = _model(KW, "q40")
    eng = Engine(tcfg, p, device="cpu", batch=2, mesh=make_mesh(1, "cpu", dp=2))
    got = [t for t, _ in eng.generate_stream([3, 14, 15], 16, temperature=0.0, chunk=4)]
    assert got == _single(tcfg, p, [3, 14, 15], 16)
    logits = eng.last_logits
    assert logits.shape[0] == 2 and torch.equal(logits[0], logits[1])
    mcfg, _, mp = _model(dict(KW, n_experts=4, n_active_experts=2, n_kv_heads=2), "q40",
                         arch=mfile.ARCH_MIXTRAL, seed=3)
    moe = Engine(mcfg, mp, device="cpu", batch=2, mesh=make_mesh(2, "cpu", dp=2))
    assert [t for t, _ in moe.generate_stream([3, 14, 15], 12, temperature=0.0)] == \
        _single(mcfg, mp, [3, 14, 15], 12)


def test_dp_with_sp_and_tp():
    """dp = 2 x sp = 2 x tp = 2 (eight ranks): a prompt's replicas take the
    ring prefill (16-token bucket) and the decode combine in each data
    group; the stream is the single device's and a second turn continues
    it."""
    tcfg, _, p = _model(KW, "q40")
    eng = Engine(tcfg, p, device="cpu", batch=2, mesh=make_mesh(2, "cpu", dp=2, sp=2))
    got = [t for t, _ in eng.generate_stream([1, 5, 9, 2, 7], 16, temperature=0.0, chunk=4)]
    one = Engine(tcfg, p, device="cpu")
    assert got == [t for t, _ in one.generate_stream([1, 5, 9, 2, 7], 16, temperature=0.0,
                                                      chunk=4)]
    turn = [t for t, _ in eng.generate_stream([8, 3], 8, temperature=0.0, seed=None)]
    assert turn == [t for t, _ in one.generate_stream([8, 3], 8, temperature=0.0, seed=None)]


def test_dp_cache_layout_and_snapshot(tmp_path):
    """A dp = 2 x tp = 2 engine's global cache layout is dp = 1's; a snapshot
    joins the groups' rows and restores them in place."""
    tcfg, _, p = _model(KW, "q40")
    eng = Engine(tcfg, p, device="cpu", batch=2, mesh=make_mesh(2, "cpu", dp=2))
    one = Engine(tcfg, p, device="cpu", batch=2)
    assert eng.kv_layout() == one.kv_layout()
    for e in (eng, one):
        e.prefill_ragged([[3, 1, 4], [1, 5]])
    path = eng.snapshot(tmp_path / "dp.snap")
    again = Engine(tcfg, p, device="cpu", batch=2, mesh=make_mesh(2, "cpu", dp=2))
    again.restore(path)
    for a, b in zip(again.cache.ranks, eng.cache.ranks):
        torch.testing.assert_close(a.k, b.k, rtol=0, atol=0)
    np.testing.assert_allclose(eng._global(eng.kv_planes()["v"]).numpy(),
                               one.cache.v.numpy(), atol=1e-5, rtol=1e-5)


def test_batch_must_shard_over_dp():
    tcfg, _, p = _model(KW, "q40")
    with pytest.raises(ValueError, match="does not shard over dp=2"):
        Engine(tcfg, p, device="cpu", batch=3, mesh=make_mesh(1, "cpu", dp=2))
    with pytest.raises(ValueError, match="not yet ported"):
        Engine(tcfg, p, device="cpu", batch=2, kv_pages=8, mesh=make_mesh(1, "cpu", dp=2))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_dp")
    m, t = d / "tiny.m", d / "tiny.t"
    write_tiny_model(m, ftype=quants.Q40)
    write_tiny_tokenizer(t)
    prompts = d / "p.txt"
    prompts.write_text("hello\nhi\nhello hi\nthe\n")
    return str(m), str(t), str(prompts)


def test_cli_batch_dp2_matches_jax(files):
    """``batch --dp 2`` over four prompts prints ``dp=2`` and the JAX CLI's
    streams byte for byte; three prompts do not shard and exit with the JAX
    CLI's message."""
    m, t, prompts = files
    args = ["batch", "--model", m, "--tokenizer", t, "--prompts-file", prompts,
            "--steps", "16", "--temperature", "0", "--buffer-float-type", "f32", "--dp", "2"]
    port = run_port(args + ["--device", "cpu"])
    assert port.returncode == 0, port.stderr[-2000:]
    assert "💡 mesh: dp=2" in port.stdout.splitlines()
    assert "dp=2" in port.stdout.splitlines()[-1]
    ref = run_cli(args + ["--workers", "tpu:1"], n_devices=2)
    assert ref.returncode == 0, ref.stderr[-2000:]
    streams = [ln for ln in _text(port.stdout) if not ln.startswith(("Batched", "Generated"))]
    assert streams == [ln for ln in _text(ref.stdout)
                       if not ln.startswith(("Batched", "Generated"))]
    assert sum(ln.startswith("▶ stream") for ln in streams) == 4
    three = os.path.join(os.path.dirname(prompts), "p3.txt")
    with open(three, "w") as f:
        f.write("hello\nhi\nthe\n")
    bad = run_port(args[:6] + [three] + args[7:] + ["--device", "cpu"])
    assert bad.returncode != 0 and "3 prompts do not shard over dp=2" in bad.stderr


def test_cli_refuses_pld_with_dp_or_sp(files):
    m, t, _ = files
    for axis in ("--dp", "--sp"):
        r = run_port(["generate", "--model", m, "--tokenizer", t, "--prompt", "hello",
                      "--temperature", "0", "--pld", "4", axis, "2", "--device", "cpu"])
        assert r.returncode != 0
        assert "--pld is single-stream; drop --dp/--sp (tp/ep meshes are fine)" in r.stderr


def test_server_refuses_dp_and_sp_with_slots(files):
    """The API server: ``--dp`` is not yet ported there (named); ``--sp``
    with ``--batch-slots`` exits with the JAX server's start-up message."""
    m, t, _ = files
    from dllama_tpu_torch.server import api
    base = ["--model", m, "--tokenizer", t, "--device", "cpu"]
    with pytest.raises(SystemExit, match="not yet ported.*--dp on the API server"):
        api.parse_args(base + ["--dp", "2"])
    with pytest.raises(SystemExit, match="--batch-slots is not supported with --sp"):
        api.build_state(api.parse_args(base + ["--sp", "2", "--batch-slots", "2"]))


def test_mesh_rank_layout_is_jax_reshape():
    """Rank ((d·sp + s)·ep + e)·tp + t, tp innermost: the JAX mesh's
    ``reshape(dp, sp, ep, tp)``; its groups by axis; its refusal of more
    ranks than cards ("needs N devices, have M")."""
    mesh = make_mesh(2, "cpu", dp=2, sp=2, ep=2)
    jm = jmake_mesh(tp=2, sp=2, dp=1, ep=2, devices=jax.devices()[:8])
    ids = np.vectorize(lambda dv: dv.id)(jm.devices)
    for r in range(8):
        d, s, e, t = mesh.coords(r)
        assert mesh.rank(d, s, e, t) == r
        if d == 0:
            assert ids[0, s, e, t] - ids.min() == r
    assert mesh.size == 16 and mesh.shape == {"dp": 2, "sp": 2, "ep": 2, "tp": 2}
    assert mesh.group_ranks(("sp",), 5) == [1, 5]
    assert mesh.group_ranks(("ep", "tp"), 5) == [4, 5, 6, 7]
    assert mesh.axes_line() == "dp=2 sp=2 ep=2 tp=2"
    assert make_mesh(1, "cpu").axes_line() == "tp=1"
    have = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"mesh 2x1x1x1 needs 2 devices, have {have}"):
        if have >= 2:
            raise ValueError(f"mesh 2x1x1x1 needs 2 devices, have {have}")
        make_mesh(1, "cuda", dp=2)
