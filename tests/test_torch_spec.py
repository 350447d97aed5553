"""Speculative decoding of the port under the slot scheduler
(``runtime/spec.py``, ``Engine.slot_verify_async``,
``decode_loop.slot_verify_chunk``, the scheduler's verify steps) against
the JAX package's on the same weights and streams, on the CPU:

* each proposer proposes what JAX's proposes on the same streams (the
  prompt-lookup index; the draft model's sync-by-replay and its drafts);
* ``slot_verify_async``'s accepted counts equal JAX's, its predictions
  equal JAX's wherever the port's top-2 margin decides, and the graph
  body (``graphs.verify_step``, run eagerly) equals the eager step bit
  for bit; a no-proposal row rides as one decode step;
* the scheduler with ``spec`` ``pld`` and ``draft`` emits ``--spec off``'s
  greedy bytes and the JAX scheduler's with the same proposer, contiguous
  and paged; sampled requests ride beside it;
* every flush point drops pending drafts: retire, park (preemption),
  export (hand-off) and drain;
* the API server with ``--spec pld`` / ``--spec draft`` answers
  ``--spec off``'s text; ``--spec`` without ``--batch-slots`` and
  ``--spec draft`` without ``--draft-model`` are refused.
"""

import json
import urllib.request

import numpy as np
import pytest
import torch

from dllama_tpu.models import config as jconfig, params as jparams
from dllama_tpu.runtime import spec as jspec
from dllama_tpu.runtime.engine import Engine as JEngine
from dllama_tpu.runtime.scheduler import SlotScheduler as JScheduler
from dllama_tpu_torch.models import config as tconfig, params as tparams, transformer
from dllama_tpu_torch.runtime import graphs, spec as tspec
from dllama_tpu_torch.runtime.engine import Engine
from dllama_tpu_torch.runtime.scheduler import SlotScheduler, Ticket
from fixtures import write_tiny_model, write_tiny_tokenizer

SEQ = 64
PAGE = 4
PROMPTS = ([5, 9, 2, 5, 9], [7, 3, 11, 4, 6, 1, 8], [2, 4, 6, 2, 4], [9, 8, 7, 6])


@pytest.fixture(scope="module")
def weights():
    jcfg = jconfig.tiny_config(seq_len=SEQ)
    jp = jparams.init_params(jcfg, seed=4)
    tcfg = tconfig.tiny_config(seq_len=SEQ)
    return jcfg, jp, tcfg, tparams.from_jax_params({k: np.asarray(v) for k, v in jp.items()},
                                                   tcfg)


def _kw(paged, batch=4):
    return dict(kv_pages=batch * (SEQ // PAGE) + 1, kv_page_size=PAGE) if paged else {}


def _port(weights, batch=4, paged=False, graphs_body=False):
    eng = Engine(weights[2], weights[3], device="cpu", batch=batch, **_kw(paged, batch))
    if graphs_body:
        eng.graphs = graphs.DecodeGraphs(eng.device, capture=False)
    return eng


def _jax(weights, batch=4, paged=False):
    return JEngine(weights[0], weights[1], batch=batch, **_kw(paged, batch))


@pytest.fixture(scope="module")
def solo(weights):
    eng = Engine(weights[2], weights[3], device="cpu")
    refs = {}
    for p in PROMPTS:
        eng.reset()
        refs[tuple(p)] = [t for t, _ in eng.generate_stream(
            list(p), len(p) + 30, temperature=0.0, chunk=5)][len(p):]
    return refs


# -- proposers ----------------------------------------------------------

STREAMS = [("r1", [1, 2, 3, 1, 2], [[], [3, 1], [3, 1, 2, 3]]),
           ("r2", [7, 8], [[], [7], [7, 8, 9]]),
           ("r3", [4, 5, 4, 5, 4, 5], [[], [4], [4, 5, 4]])]


@pytest.mark.parametrize("ngram", [1, 2, 3])
def test_prompt_lookup_proposer_equals_jax(ngram):
    mine = tspec.PromptLookupProposer(ngram=ngram, vocab=64)
    ref = jspec.PromptLookupProposer(ngram=ngram, vocab=64)
    for step in range(3):
        for slot, (rid, prompt, emitted) in enumerate(STREAMS):
            mine.sync(slot, rid, prompt, emitted[step])
            ref.sync(slot, rid, prompt, emitted[step])
        for want in ({0: 3, 1: 4, 2: 2}, {0: 0, 3: 4}, {2: 5}):
            assert mine.propose(want) == ref.propose(want)
    mine.sync(0, "r9", [5, 6], [])
    ref.sync(0, "r9", [5, 6], [])
    mine.reset(2)
    ref.reset(2)
    assert mine.propose({0: 2, 2: 2}) == ref.propose({0: 2, 2: 2}) == {}


def test_draft_proposer_equals_jax(weights, solo):
    """The draft model's drafts (an identical draft engine reproduces the
    target's greedy continuation), its sync-by-replay credit and a
    catch-up longer than one pre-feed chunk, against JAX's."""
    mine = tspec.DraftModelProposer(_port(weights, 2))
    ref = jspec.DraftModelProposer(_jax(weights, 2))
    long = [int(x) for x in np.random.RandomState(3).randint(1, 200, 45)]
    for pr in (mine, ref):
        pr.sync(0, "r1", list(PROMPTS[0]), [])
        pr.sync(1, "r2", long, [])
    got, want = mine.propose({0: 4, 1: 3}), ref.propose({0: 4, 1: 3})
    assert got == want
    assert got[0] == solo[tuple(PROMPTS[0])][:4]
    # the verifier kept two drafts and diverged: both credit fed + 2
    for pr, props in ((mine, got), (ref, want)):
        pr.sync(0, "r1", list(PROMPTS[0]), props[0][:2] + [0])
    assert (mine._states[0].synced, mine._states[0].fed) == \
        (ref._states[0].synced, ref._states[0].fed)
    assert mine.propose({0: 4}) == ref.propose({0: 4})
    with pytest.raises(ValueError, match="contiguous"):
        tspec.DraftModelProposer(_port(weights, 2, paged=True))
    assert tspec.make_proposer("off", None) is None
    with pytest.raises(ValueError, match="--draft-model"):
        tspec.make_proposer("draft", _port(weights, 2))


def test_draft_catch_up_keeps_the_fed_tokens(weights):
    """Two rows whose catch-ups end in different pre-feed chunks (10 and
    100 tokens): the row that finishes first parks at its own frontier, so
    the tokens it fed keep their KV and an identical draft engine drafts
    the target's greedy continuation for both rows.  (The JAX package
    parks it at its synced ceiling, and the ride-along window's writes
    then overwrite the fed tokens: ROADMAP, deliberate differences.)"""
    rng = np.random.RandomState(8)
    prompts = [[int(x) for x in rng.randint(1, 120, n)] for n in (10, 100)]
    cfg = tconfig.tiny_config(seq_len=256)  # room for a 100-token catch-up
    eng = Engine(cfg, weights[3], device="cpu")
    refs = []
    for p in prompts:
        eng.reset()
        refs.append([t for t, _ in eng.generate_stream(p, len(p) + 4, temperature=0.0)][len(p):])
    mine = tspec.DraftModelProposer(Engine(cfg, weights[3], device="cpu", batch=2))
    for slot, p in enumerate(prompts):
        mine.sync(slot, f"r{slot}", p, [])
    got = mine.propose({0: 4, 1: 4})
    assert got == {0: refs[0], 1: refs[1]}


# -- the verify step ----------------------------------------------------

def _prefill(eng, prompts, paged):
    """Feed each row its prompt through slot steps (as the scheduler's
    mixed steps do); returns positions, the last sampled tokens, the page
    tables."""
    b = eng.batch
    pt = None
    if paged:
        per = SEQ // PAGE
        pt = np.array([[1 + r * per + j for j in range(per)] for r in range(b)], np.int32)
    t = max(len(p) for p in prompts)
    tokens = np.zeros((b, t), np.int32)
    nv = np.ones((b,), np.int32)
    for r, p in enumerate(prompts):
        tokens[r, :len(p)] = p
        nv[r] = len(p)
    zeros = np.zeros((b,), np.float32)
    out = eng.slot_step(tokens, np.zeros((b,), np.int32), nv, temps_np=zeros,
                        topps_np=zeros + 0.9, page_tables_np=pt)
    return nv.copy(), np.asarray(out)[0], pt


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_slot_verify_equals_jax_and_graph_body(weights, solo, paged):
    prompts = [list(p) for p in PROMPTS]
    ref_stream = [solo[tuple(p)] for p in PROMPTS]
    results = {}
    for name in ("port", "graph-body", "jax"):
        eng = _jax(weights, paged=paged) if name == "jax" else \
            _port(weights, paged=paged, graphs_body=name == "graph-body")
        pos, last, pt = _prefill(eng, prompts, paged)
        # row 0: the true continuation (all accepted); row 1: two right,
        # then wrong; row 2: wrong at once; row 3: no proposal
        t = 5
        tokens = np.zeros((4, t), np.int32)
        nv = np.array([5, 5, 5, 1], np.int32)
        tokens[:, 0] = last
        tokens[0, 1:] = ref_stream[0][1:5]
        tokens[1, 1:] = ref_stream[1][1:3] + [0, 0]
        tokens[2, 1:] = [(ref_stream[2][1] + 1) % 128, 1, 2, 3]
        zeros = np.zeros((4,), np.float32)
        h = eng.slot_verify_async(tokens, pos, nv, temps_np=zeros, topps_np=zeros + 0.9,
                                  page_tables_np=pt)
        preds, acc = h.wait()
        results[name] = (np.asarray(preds), np.asarray(acc), tokens, pos, pt, eng)
    (p_t, a_t, tokens, pos, pt, eng), (p_g, a_g, *_), (p_j, a_j, *_) = (
        results["port"], results["graph-body"], results["jax"])
    assert a_t.tolist() == a_j.tolist() == a_g.tolist() == [4, 2, 0, 0]
    assert np.array_equal(p_t, p_g)
    # every emitted token is the solo stream's
    for r in range(4):
        assert p_t[r, :a_t[r] + 1].tolist() == ref_stream[r][1:a_t[r] + 2]
    # predictions equal JAX's wherever the port's top-2 margin decides
    with torch.no_grad():
        logits, _ = transformer.forward_slots_all(
            eng.params, eng.cfg, torch.from_numpy(tokens), eng.cache,
            torch.from_numpy(pos.astype(np.int32)), torch.tensor([5, 5, 5, 1], dtype=torch.int32),
            page_table=torch.from_numpy(pt) if paged else None)
    top2 = torch.topk(logits, 2, dim=-1).values
    decisive = (top2[..., 0] - top2[..., 1] > 1e-3).numpy()
    assert decisive.mean() > 0.9
    assert np.array_equal(p_t[decisive], p_j[decisive])


def test_slot_verify_validation(weights):
    eng = _port(weights)
    z = np.zeros((4,), np.float32)
    ok = dict(temps_np=z, topps_np=z + 0.9)
    with pytest.raises(ValueError, match="T >= 2"):
        eng.slot_verify_async(np.zeros((4, 1), np.int32), np.zeros(4, np.int32),
                              np.ones(4, np.int32), **ok)
    with pytest.raises(ValueError, match="n_valid exceeds"):
        eng.slot_verify_async(np.zeros((4, 3), np.int32), np.zeros(4, np.int32),
                              np.full(4, 4, np.int32), **ok)
    with pytest.raises(ValueError, match="past seq_len"):
        eng.slot_verify_async(np.zeros((4, 3), np.int32), np.full(4, SEQ - 2, np.int32),
                              np.ones(4, np.int32), **ok)
    with pytest.raises(ValueError, match="page_tables_np"):
        _port(weights, paged=True).slot_verify_async(
            np.zeros((4, 3), np.int32), np.zeros(4, np.int32), np.ones(4, np.int32), **ok)


# -- the scheduler ------------------------------------------------------

def _serve(sched, prompts=PROMPTS, new=30, temps=None):
    ts = [sched.submit(list(p), new, temperature=(temps or {}).get(i, 0.0))
          for i, p in enumerate(prompts)]
    try:
        return [list(t.tokens()) for t in ts], dict(sched.stats)
    finally:
        sched.close()


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("mode", ["pld", "draft"])
def test_scheduler_spec_equals_off_and_jax(weights, solo, mode, paged):
    off, _ = _serve(SlotScheduler(_port(weights, paged=paged), prefill_chunk=4))
    assert off == [solo[tuple(p)][:30] for p in PROMPTS]
    draft = _port(weights) if mode == "draft" else None
    eng = _port(weights, paged=paged)
    got, stats = _serve(SlotScheduler(eng, prefill_chunk=4, spec_k=3,
                                      spec=tspec.make_proposer(mode, eng, draft)))
    assert got == off
    assert stats["verify_dispatches"] > 0 and eng.verify_forwards == stats["verify_dispatches"]
    assert 0 < stats["spec_accepted"] <= stats["spec_proposed"]
    jeng = _jax(weights, paged=paged)
    jdraft = _jax(weights) if mode == "draft" else None
    jsched = JScheduler(jeng, prefill_chunk=4, spec_k=3,
                        spec=jspec.make_proposer(mode, jeng, draft_engine=jdraft))
    ts = [jsched.submit(list(p), 30, temperature=0.0) for p in PROMPTS]
    want = [list(t.tokens()) for t in ts]
    jsched.close()
    assert got == want


def test_scheduler_spec_graph_body_and_sampled_rider(weights, solo):
    """The verify graph body (run eagerly) serves the same greedy bytes; a
    sampled request rides the verify steps (column 0 drawn with its own
    parameters) and finishes its budget."""
    eng = _port(weights, paged=True, graphs_body=True)
    got, stats = _serve(SlotScheduler(eng, prefill_chunk=4, spec_k=3,
                                      spec=tspec.make_proposer("pld", eng)),
                        temps={3: 0.8})
    for i in range(3):
        assert got[i] == solo[tuple(PROMPTS[i])][:30]
    assert len(got[3]) == 30 and stats["verify_dispatches"] > 0


def _bound(sched, slot, prompt):
    """Bind a live ticket to ``slot`` by hand (the loop is stopped), with
    a pending draft and proposer state for it."""
    t = Ticket(prompt, 8, 0.0, 0.9, (), None)
    s = sched.slots[slot]
    s.ticket, s.pos, s.fed, s.produced, s.last = t, len(prompt), len(prompt), 1, 3
    t.slot = slot
    if sched.pool is not None:
        s.pages = sched.pool.alloc(-(-(len(prompt) + 8) // PAGE))
        s.budget = len(s.pages)
        sched._page_tables[slot][:len(s.pages)] = s.pages
    sched.spec.sync(slot, t.rid, prompt, [3])
    sched._proposals[slot] = (t, [1, 2])
    return t


@pytest.mark.parametrize("point", ["retire", "park", "export", "drain"])
def test_every_flush_point_drops_drafts(weights, point):
    eng = _port(weights, paged=True)
    sched = SlotScheduler(eng, prefill_chunk=4, spec_k=3, spec=tspec.make_proposer("pld", eng))
    sched.close()  # the loop is stopped: the flush points run on this thread
    prompt = [1, 2, 3, 1, 2]
    t = _bound(sched, 0, prompt)
    _bound(sched, 1, [4, 5, 4, 5])
    assert set(sched._proposals) == {0, 1} and set(sched.spec._states) == {0, 1}
    with sched._cond:
        if point == "retire":
            sched._retire(0, "aborted")
        elif point == "park":
            sched._preempt_locked(0, "no_free_slot", 0.0)
            assert sched._parked and sched._parked[0].ticket is t
    if point == "export":
        records = sched.handoff_export_all()
        assert t.rid in records
    if point == "drain":
        sched.begin_drain(None)
    assert 0 not in sched._proposals and (point == "drain" or 0 not in sched.spec._states)
    if point in ("retire", "park"):
        assert 1 in sched._proposals  # the neighbour keeps its drafts
    # a stale draft is never consumed by a later occupant of the slot
    assert all(tk is sched.slots[i].ticket for i, (tk, _) in sched._proposals.items())


# -- the server ---------------------------------------------------------

@pytest.fixture(scope="module")
def model_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("spec")
    m, t, dm = str(d / "tiny.m"), str(d / "tiny.t"), str(d / "draft.m")
    write_tiny_model(m)
    write_tiny_model(dm, seed=5)  # another model with the target's vocab
    write_tiny_tokenizer(t)
    return m, t, dm


def _complete(base, prompt, n):
    req = urllib.request.Request(base + "/v1/completions", json.dumps(
        {"prompt": prompt, "max_tokens": n, "temperature": 0}).encode(),
        {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())["choices"][0]["text"]


@pytest.mark.parametrize("extra", [["--spec", "pld", "--spec-k", "3"],
                                   ["--spec", "draft", "--spec-k", "2"]],
                         ids=["pld", "draft"])
def test_server_spec_answers_off_text(model_files, extra):
    from dllama_tpu_torch.server import api
    m, t, dm = model_files
    args = ["--model", m, "--tokenizer", t, "--device", "cpu", "--port", "0", "--host",
            "127.0.0.1", "--batch-slots", "2", "--kv-pages", "40", "--kv-page-size", "4"]
    prompts = ["hello hello hello", "abc abc abc abc"]
    texts = {}
    for name, more in (("off", []), ("on", extra + (["--draft-model", dm]
                                                     if "draft" in extra else []))):
        srv = api.start(args + more)
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        try:
            texts[name] = [_complete(base, p, 48) for p in prompts]
            with urllib.request.urlopen(base + "/health", timeout=30) as r:
                health = json.loads(r.read())
        finally:
            api.stop(srv)
    assert texts["on"] == texts["off"]
    occ = health["scheduler"]
    assert occ["verify_dispatches"] > 0 and occ["spec_proposed"] > 0
    assert health["perf"]["flops_total"] > 0 and health["perf"]["peaks"]["source"] in (
        "measured", "env")


def test_server_spec_refusals(model_files):
    from dllama_tpu_torch.server import api
    m, t, _ = model_files
    base = ["--model", m, "--tokenizer", t, "--device", "cpu", "--port", "0"]
    with pytest.raises(SystemExit, match="--spec needs --batch-slots"):
        api.start(base + ["--spec", "pld"])
    with pytest.raises(SystemExit, match="--spec draft needs --draft-model"):
        api.start(base + ["--spec", "draft", "--batch-slots", "2"])
