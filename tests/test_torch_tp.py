"""Tensor parallelism end to end on the CPU: the port's model sliced over
tp ranks (every rank on the CPU, kernel 4's plain version summing the
partials) against the JAX package on its virtual CPU mesh at the same tp,
and against the port's own tp = 1.

Tolerances: f32 activations, packed weights — both packages multiply the
same bf16 operands and differ only in f32 summation order (the partial
sums add per rank, then across ranks), so logits agree within 1e-4 abs /
1e-3 rel as ``tests/test_parallel.py`` holds the JAX package's tp = 8
against its tp = 1.  Greedy tokens must be equal.  The tiny `.m` fixture
(hidden 96) leaves w2 replicated at tp = 2 (48 rows a rank is not whole
quantization blocks), so the engine-level cases use hidden 128, where
every column-sliced matmul runs through kernel 4's plain version.
"""

import json
import threading
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu import quants
from dllama_tpu.io import mfile
from dllama_tpu.models import config as jconfig
from dllama_tpu.ops import q8 as jq8, q40 as jq40
from dllama_tpu.parallel.mesh import make_mesh as jmake_mesh
from dllama_tpu.runtime.engine import Engine as JEngine
from dllama_tpu.sampling import Sampler
from dllama_tpu_torch.models import config as tconfig, params as tparams
from dllama_tpu_torch.ops import q8 as tq8, q40 as tq40
from dllama_tpu_torch.parallel.mesh import make_mesh
from dllama_tpu_torch.parallel.sharding import Placed
from dllama_tpu_torch.runtime.engine import Engine
from fixtures import run_cli, write_tiny_model, write_tiny_tokenizer
from test_torch_moe_cli import _text, run_port

KW = dict(dim=64, hidden_dim=128, n_layers=2, n_heads=4, n_kv_heads=4,
          vocab_size=96, seq_len=64)
MOE = dict(KW, n_experts=4, n_active_experts=2, n_kv_heads=2)
PROMPT = [3, 14, 15, 92, 6, 5, 35]
CODECS = {"q40": tq40, "q80": tq8}


def _to_jax(params) -> dict:
    out = {}
    for k, v in params.items():
        if isinstance(v, (tq40.QTensor, tq8.Q8Tensor)):
            cls = jq40.QTensor if isinstance(v, tq40.QTensor) else jq8.Q8Tensor
            out[k] = cls(jnp.asarray(v.qpacked.numpy()),
                         jnp.asarray(v.scales.numpy().view(np.uint16)), v.logical_nd)
        else:
            out[k] = jnp.asarray(v.numpy())
    return out


def _model(kw, codec, arch=mfile.ARCH_LLAMA, seed=21):
    tcfg = tconfig.tiny_config(arch=arch, **kw)
    jcfg = jconfig.tiny_config(arch=arch, **kw)
    p = tparams.init_params(tcfg, seed=seed)
    if codec != "dense":
        p = tparams.quantize_matmuls(p, tcfg, CODECS[codec])
    return tcfg, jcfg, p


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-4, rtol=1e-3)


def _greedy(engine, n=16):
    return [t for t, _ in engine.generate_stream(PROMPT, len(PROMPT) + n,
                                                 temperature=0.0, chunk=4)]


def _jax_greedy(engine, n=16):
    sampler = Sampler(engine.cfg.vocab_size, 0.0, 0.9, 1)
    return [t for t, _ in engine.generate(PROMPT, len(PROMPT) + n, sampler)]


def _tp_engine(cfg, p, tp, **kw):
    return Engine(cfg, p, device="cpu", mesh=make_mesh(tp, "cpu"), **kw)


@pytest.mark.parametrize("codec", ["q40", "q80", "dense"])
@pytest.mark.parametrize("tp", [2, 4])
def test_logits_and_greedy_match_jax_at_tp(codec, tp):
    """Prefill and one decode step against the JAX package at the same tp;
    greedy tokens equal to JAX's tp = N and to the port's tp = 1; kernel
    4's plain version sums wo's and w2's partials (both divide at hidden
    128 but for Q40/Q80 wo at tp = 4, half a block a rank: replicated)."""
    tcfg, jcfg, p = _model(KW, codec)
    jp = _to_jax(p)
    je = JEngine(jcfg, jp, mesh=jmake_mesh(tp=tp))
    tq40.reset_counters()
    te = _tp_engine(tcfg, p, tp)
    _close(te.prefill(PROMPT)[0], je.prefill(PROMPT)[0])
    _close(te.decode_one(7)[0], je.decode_one(7)[0])
    calls = tq40.counters()["allreduce_plain_calls"]
    per_layer = 1 if codec != "dense" and tp == 4 else 2
    assert calls == 2 * tcfg.n_layers * per_layer
    te.reset()
    ours = _greedy(te)
    assert ours == _greedy(Engine(tcfg, p, device="cpu"))
    assert ours == _jax_greedy(JEngine(jcfg, jp, mesh=jmake_mesh(tp=tp)))


@pytest.mark.parametrize("codec,arch", [("q40", mfile.ARCH_MIXTRAL),
                                        ("q80", mfile.ARCH_MIXTRAL),
                                        ("q40", mfile.ARCH_GROK1),
                                        ("dense", mfile.ARCH_MIXTRAL)])
def test_moe_matches_jax_at_tp2(codec, arch):
    """Mixtral/Grok-1 at tp = 2: the prompt takes the all-experts route,
    decode the selected experts; each expert's down partials are summed
    before its routing weight, as in the JAX package."""
    tcfg, jcfg, p = _model(MOE, codec, arch=arch, seed=8)
    jp = _to_jax(p)
    je = JEngine(jcfg, jp, mesh=jmake_mesh(tp=2))
    te = _tp_engine(tcfg, p, 2)
    tq40.reset_counters()
    _close(te.prefill(PROMPT)[0], je.prefill(PROMPT)[0])
    for tok in (7, 2):
        _close(te.decode_one(tok)[0], je.decode_one(tok)[0])
    assert tq40.counters()["allreduce_plain_calls"] > 0
    te.reset()
    assert _greedy(te, 10) == _greedy(Engine(tcfg, p, device="cpu"), 10)


@pytest.mark.parametrize("quant", [False, True])
def test_slot_path_paged_at_tp2_matches_tp1(quant):
    """forward_slots over per-rank paged pools (bf16 values, or int8 with
    scales), one shared page table: a ragged prefill chunk and 4 decode
    steps give tp = 1's logits."""
    tcfg, _, p = _model(KW, "q40")
    b, t, pages = 3, 8, 16
    ptab = (1 + np.arange(b * pages, dtype=np.int32)).reshape(b, pages)
    rng = np.random.RandomState(2)
    toks = rng.randint(3, tcfg.vocab_size, (b, t)).astype(np.int32)
    n_valid = np.array([8, 3, 5], np.int32)
    zeros = np.zeros(b, np.float32)
    logits = []
    for tp in (1, 2):
        eng = Engine(tcfg, p, device="cpu", batch=b, kv_pages=1 + b * pages,
                     kv_page_size=4, kv_dtype="q8" if quant else None,
                     mesh=make_mesh(tp, "cpu"))
        pos = np.zeros(b, np.int32)
        out = [eng.slot_step(toks, pos, n_valid, temps_np=zeros, topps_np=zeros + 0.9,
                             page_tables_np=ptab, steps=4)]
        pos = pos + n_valid + 3
        out.append(eng.slot_step(out[-1][-1][:, None], pos, np.ones(b, np.int32),
                                 temps_np=zeros, topps_np=zeros + 0.9,
                                 page_tables_np=ptab))
        logits.append((np.concatenate(out), eng.last_logits.numpy()))
        if tp == 2:
            assert eng.cache.ranks[0].k.shape[2] == tcfg.n_kv_heads // 2
    assert np.array_equal(logits[0][0], logits[1][0])
    _close(logits[1][1], logits[0][1])


def test_lockstep_batch_at_tp2_matches_tp1():
    tcfg, _, p = _model(KW, "q40")
    prompts = [[1, 5, 9, 2, 7], [4, 4], [8, 3, 6]]
    outs = [Engine(tcfg, p, device="cpu", batch=3, mesh=make_mesh(tp, "cpu"))
            .generate_batch(prompts, 14, chunk=4) for tp in (1, 2)]
    assert outs[0] == outs[1]


def test_engine_shares_placed_params_and_keeps_rows_on_a_mesh(monkeypatch, capsys):
    """A slot engine built from a TP engine's params shares them; the
    blocked layout, single-device in the JAX package, warns and stays
    row-major on a mesh."""
    tcfg, _, p = _model(KW, "q40")
    monkeypatch.setenv("DLLAMA_Q40_LAYOUT", "blocked")
    mesh = make_mesh(2, "cpu")
    a = Engine(tcfg, p, device="cpu", mesh=mesh)
    assert isinstance(a.params, Placed) and a.tp == 2
    assert "DLLAMA_Q40_LAYOUT=blocked is ignored on a tp=2 mesh" in capsys.readouterr().err
    assert all(isinstance(v, tq40.QTensor) for v in a.params.ranks[1].values()
               if not isinstance(v, torch.Tensor))
    b = Engine(tcfg, a.params, device="cpu", mesh=mesh, batch=2, kv_pages=8)
    assert b.params is a.params


# --- the entry points -----------------------------------------------------------

@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_tp")
    t = str(d / "tiny.t")
    write_tiny_tokenizer(t)
    paths = {}
    for name, arch, ftype, n_experts in (("q40", mfile.ARCH_LLAMA, quants.Q40, 0),
                                         ("q80", mfile.ARCH_LLAMA, quants.Q80, 0),
                                         ("mixtral", mfile.ARCH_MIXTRAL, quants.Q40, 4)):
        paths[name] = str(d / f"{name}.m")
        write_tiny_model(paths[name], arch=arch, ftype=ftype, n_experts=n_experts)
    return paths, t


@pytest.mark.parametrize("name", ["q40", "q80", "mixtral"])
def test_generate_tp2_byte_identical_to_jax(files, name):
    paths, t = files
    args = ["generate", "--model", paths[name], "--tokenizer", t, "--prompt", "hello",
            "--steps", "24", "--temperature", "0", "--buffer-float-type", "f32",
            "--workers", "tpu:2"]
    port = run_port(args + ["--device", "cpu"])
    assert port.returncode == 0, port.stderr[-2000:]
    ref = run_cli(args, n_devices=2)
    assert ref.returncode == 0, ref.stderr[-2000:]
    ours = [ln for ln in _text(port.stdout) if not ln.startswith("⚠️")]
    assert ours == [ln for ln in _text(ref.stdout) if not ln.startswith("⚠️")]
    assert "💡 mesh: tp=2" in port.stdout
    last = port.stdout.splitlines()[-1]
    assert " allreduce=0 allreduce_plain=" in last and " tp=2 " in last


def test_inference_tp2_tokens_match_jax(files):
    paths, t = files
    args = ["inference", "--model", paths["q40"], "--tokenizer", t, "--prompt", "hello",
            "--steps", "12", "--temperature", "0", "--buffer-float-type", "f32",
            "--workers", "tpu:2"]
    port = run_port(args + ["--device", "cpu"])
    assert port.returncode == 0, port.stderr[-2000:]
    ref = run_cli(args, n_devices=2)
    assert ref.returncode == 0, ref.stderr[-2000:]

    def pieces(out):  # the token after each G/I/T line's timings
        return [ln.split("|", 1)[1] for ln in out.splitlines() if ln.startswith("🔶")]

    assert pieces(port.stdout) == pieces(ref.stdout) and len(pieces(port.stdout)) == 14


def test_workers_past_the_kv_heads_are_refused(files):
    paths, t = files
    r = run_port(["generate", "--model", paths["q40"], "--tokenizer", t, "--prompt",
                  "hi", "--device", "cpu", "--workers", "tpu:3"])
    assert r.returncode != 0
    assert "exceeds nKvHeads=2" in r.stderr and "valid tp degrees for this model: [1, 2]" \
        in r.stderr


def _post(base: str, body: dict) -> str:
    req = urllib.request.Request(base + "/v1/completions", json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())["choices"][0]["text"]


def test_server_tp2_answers_what_tp1_answers(files):
    """The API server at --workers tpu:2: three concurrent greedy
    completions through 2 slots and per-rank paged pools answer the tp = 1
    server's text; /health counts kernel 4's plain calls."""
    from dllama_tpu_torch.server import api
    paths, t = files
    base_args = ["--model", paths["q40"], "--tokenizer", t, "--device", "cpu",
                 "--temperature", "0", "--buffer-float-type", "f32", "--batch-slots",
                 "2", "--kv-pages", "40", "--kv-page-size", "4", "--host",
                 "127.0.0.1", "--port", "0"]
    bodies = [{"prompt": p, "max_tokens": 10, "temperature": 0}
              for p in ("hello", "hi hello", "the")]
    answers = {}
    for tp in (1, 2):
        tq40.reset_counters()
        srv = api.start(base_args + ["--workers", f"tpu:{tp}"])
        try:
            base = f"http://127.0.0.1:{srv.server_address[1]}"
            out = [None] * len(bodies)
            threads = [threading.Thread(target=lambda i=i, b=b: out.__setitem__(
                i, _post(base, b))) for i, b in enumerate(bodies)]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            answers[tp] = out
            assert all(r["scheduler"] for r in list(srv.state.finished)[-3:])
            with urllib.request.urlopen(base + "/health", timeout=30) as r:
                health = json.loads(r.read())
            assert (health["launches"]["q40"]["allreduce_plain_calls"] > 0) == (tp == 2)
            if tp == 2:  # the slot engine shares the placed weights
                assert srv.state.batch_engine.params is srv.state.engine.params
        finally:
            api.stop(srv)
    assert answers[1] == answers[2] and all(answers[2])
