"""The port's KV tiering (runtime.kvtier and the scheduler's optimistic
reservation, spill and page-in) against the JAX package's, on the tiny f32
model with the same weights (tests/test_kvtier.py's scenarios).

* HostPagePool: the same accounting and refusals as JAX's pool for one
  scripted sequence (a duplicate key or an over-budget put is refused and
  leaves the pool as it was; a budget <= 0 refuses everything);
  ``rank_victims`` gives JAX's order.
* Optimistic growth: a request admits on ``ceil((prompt + headroom)/page)``
  pages and grows page by page, never past its full-reservation budget.
* Spill and page-in: on a pool far below the full-reservation demand every
  greedy completion equals its solo run, overlap on and off, dense and
  int8 pools, and the host pool and the page pool end empty; with a host
  budget of 0 pressure preempts instead, with the same bytes; under full
  reservation nothing spills.
* The same decisions as JAX's scheduler: on the same weights, prompts and
  tiny pool (overlap off, submissions queued at once, bursts unclamped),
  dense and int8, the two give equal greedy tokens and equal counts of
  pages spilled, pages paged in and preemptions, with a host budget and
  without one; the solo runs equal JAX's batch-1 engine's.
* The families in both /metrics formats and the ``kv_pressure`` block.
"""

import time

import jax
import numpy as np
import pytest

from dllama_tpu.models import config as jconfig, params as jparams
from dllama_tpu.obs import metrics as jmetrics
from dllama_tpu.parallel.mesh import make_mesh as jmake_mesh
from dllama_tpu.runtime import kvtier as jkvtier
from dllama_tpu.runtime.engine import Engine as JEngine
from dllama_tpu.runtime.scheduler import SlotScheduler as JScheduler
from dllama_tpu_torch.models import config as tconfig, params as tparams
from dllama_tpu_torch.obs import metrics as obs_metrics
from dllama_tpu_torch.runtime import kvtier
from dllama_tpu_torch.runtime.engine import Engine
from dllama_tpu_torch.runtime.scheduler import SlotScheduler

SEQ = 64
PAGE = 4
PROMPTS = ([5, 9, 2], [7, 3, 11, 4, 6, 1, 8], [2, 4, 6])
MAX_NEW = 24


@pytest.fixture(scope="module")
def jweights():
    jcfg = jconfig.tiny_config(seq_len=SEQ)
    return jcfg, jparams.init_params(jcfg, seed=4)


@pytest.fixture(scope="module")
def weights(jweights):
    _, jp = jweights
    tcfg = tconfig.tiny_config(seq_len=SEQ)
    return tcfg, tparams.from_jax_params({k: np.asarray(v) for k, v in jp.items()}, tcfg)


@pytest.fixture(scope="module")
def solo_refs(weights):
    tcfg, tp = weights
    eng = Engine(tcfg, tp, device="cpu")
    refs = {}
    for p in PROMPTS:
        eng.reset()
        refs[tuple(p)] = [t for t, _ in eng.generate_stream(
            p, len(p) + MAX_NEW, temperature=0.0, chunk=5)][len(p):]
    return refs


def paged_engine(weights, kv_pages=None, **kw):
    tcfg, tp = weights
    return Engine(tcfg, tp, device="cpu", batch=2,
                  kv_pages=kv_pages or 2 * (SEQ // PAGE) + 1, kv_page_size=PAGE, **kw)


def run_sched(weights, kv_pages=None, kv_dtype=None, **kw):
    """Three greedy requests through a 2-slot scheduler; returns (token
    lists, final occupancy).  As in ``_decisions``, the three are queued
    at once under the scheduler's lock, ``max_wait_ms`` is out of reach and
    aging is off, so the rounds do not depend on how loaded the machine
    is: a test thread descheduled between two submissions would let the
    first request run alone and finish, and no pressure would build."""
    kw = {"max_wait_ms": 1e9, "preempt_age_ms": 0.0, **kw}
    sched = SlotScheduler(paged_engine(weights, kv_pages, kv_dtype=kv_dtype),
                          prefill_chunk=8, decode_burst=4, **kw)
    try:
        with sched._cond:
            tickets = [sched.submit(list(p), max_new=MAX_NEW, temperature=0.0)
                       for p in PROMPTS]
        outs = [list(t.tokens()) for t in tickets]
        sched.pool.check()
        return outs, sched.occupancy()
    finally:
        sched.close(timeout=60)


def _script(mod):
    """One scripted sequence of host-pool operations; returns what each
    step answered."""
    arrays = {"pages.k": np.arange(48, dtype=np.float32).reshape(2, 24),
              "pages.v": np.ones((2, 24), np.float32)}
    nbytes = mod.arrays_nbytes(arrays)
    pool = mod.HostPagePool(capacity_bytes=2 * nbytes)
    log = [nbytes, pool.would_fit(nbytes), pool.put(("k1", "r1"), arrays, {"pos": 9}),
           ("k1", "r1") in pool, len(pool), pool.bytes_used]
    got, meta = pool.get(("k1", "r1"))
    log += [meta, {n: a.tolist() for n, a in got.items()} == {
        n: a.tolist() for n, a in arrays.items()}]
    log += [pool.put(("k1", "r1"), arrays, {}), pool.put(("k2", "r2"), arrays, {}),
            pool.would_fit(nbytes), pool.put(("k3", "r3"), arrays, {}), len(pool)]
    popped, _ = pool.pop(("k1", "r1"))
    log += [popped["pages.k"].tolist() == arrays["pages.k"].tolist(),
            ("k1", "r1") in pool, pool.pop(("k1", "r1"))]
    pool.drop(("k2", "r2"))
    log += [pool.bytes_used, len(pool)]
    off = mod.HostPagePool(capacity_bytes=0)
    log += [off.would_fit(1), off.put(("k", "r"), arrays, {})]
    pool.put(("a", "r"), {"x": np.zeros(128, np.int8)}, {})
    pool.clear()
    log += [pool.bytes_used]
    return log


def test_host_pool_matches_jax():
    assert _script(kvtier) == _script(jkvtier)
    assert _script(kvtier)[1:6] == [True, True, True, 1, 384]


def test_host_pool_keeps_bf16_words():
    """A spilled bf16 page keeps its bf16 marking in the pool, so a
    record exported from a spilled slot names it ``bfloat16``."""
    from dllama_tpu_torch.runtime import snapshot as snapfmt
    pool = kvtier.HostPagePool(1 << 20)
    words = snapfmt.bf16_words(np.arange(8, dtype=np.uint16))
    pool.put(("s", "r"), {"pages.k": words})
    got, _ = pool.get(("s", "r"))
    assert isinstance(got["pages.k"], snapfmt.Bf16Words)
    assert snapfmt.dtype_name(got["pages.k"][:, None][:4]) == "bfloat16"


def test_rank_victims_matches_jax():
    rng = np.random.RandomState(3)
    for _ in range(20):
        cands = [(int(i), float(rng.randint(0, 5))) for i in rng.permutation(8)[:5]]
        assert kvtier.rank_victims(cands) == jkvtier.rank_victims(cands)
    assert kvtier.rank_victims([(3, 50.0), (0, 10.0), (2, 10.0), (1, 99.0)]) == [0, 2, 3, 1]
    assert kvtier.rank_victims([]) == []


def test_optimistic_growth_page_by_page(weights, solo_refs):
    """Admission binds prompt + headroom; the slot then grows a round at a
    time to cover the next dispatch's writes, never past its budget."""
    sched = SlotScheduler(paged_engine(weights), prefill_chunk=8, decode_burst=4,
                          kv_reserve="optimistic", spill_headroom=4)
    eng = sched.engine
    step = eng.slot_step_async
    seen = []

    def watch(*a, **k):
        s = sched.slots[0]
        if s.ticket is not None:
            seen.append((s.pos, len(s.pages)))
        time.sleep(0.01)
        return step(*a, **k)
    eng.slot_step_async = watch
    try:
        p = PROMPTS[1]
        out = list(sched.submit(p, MAX_NEW, temperature=0.0).tokens())
        assert out == solo_refs[tuple(p)]
    finally:
        sched.close()
    budget = -(-(len(p) + MAX_NEW) // PAGE)
    bound = -(-(len(p) + 4) // PAGE)
    assert seen[0] == (0, bound)
    for pos, n in seen:
        # a round grows to the next dispatch's reach (the prefill chunk, 8)
        assert -(-(pos + 1) // PAGE) <= n <= min(budget, max(bound, -(-(pos + 8) // PAGE)))
    assert max(n for _, n in seen) == budget
    assert len({n for _, n in seen}) > 2


@pytest.mark.parametrize("kv_dtype", [None, "q8"], ids=["dense", "int8"])
@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "no-overlap"])
def test_optimistic_spill_parity(weights, solo_refs, overlap, kv_dtype):
    """A 9-usable-page pool against ~22 pages of full-reservation demand:
    slots spill to the host pool and page back in, and every completion is
    the solo run's (on the int8 pool: the uninterrupted int8 run's)."""
    ref = [solo_refs[tuple(p)] for p in PROMPTS]
    if kv_dtype:
        ref, _ = run_sched(weights, kv_dtype=kv_dtype)
    spilled0 = obs_metrics.KV_PAGES_SPILLED.value
    paged0 = obs_metrics.KV_PAGES_PAGED_IN.value
    outs, occ = run_sched(weights, kv_pages=10, kv_dtype=kv_dtype, kv_reserve="optimistic",
                          spill_headroom=4, host_pool_mb=8, overlap=overlap)
    assert outs == ref
    assert occ["pages_spilled"] >= 1 and occ["pages_paged_in"] == occ["pages_spilled"]
    assert obs_metrics.KV_PAGES_SPILLED.value - spilled0 == occ["pages_spilled"]
    assert obs_metrics.KV_PAGES_PAGED_IN.value - paged0 == occ["pages_paged_in"]
    kvp = occ["kv_pressure"]
    assert kvp["reserve"] == "optimistic"
    assert kvp["codec"] == ("int8" if kv_dtype else "float32")
    assert kvp["host_pool_bytes"] == 0 and kvp["spilled_slots"] == 0, kvp
    assert occ["kv_pages_free"] == occ["kv_pages_total"], occ


def test_full_reservation_never_spills(weights, solo_refs):
    outs, occ = run_sched(weights, host_pool_mb=8)
    assert outs == [solo_refs[tuple(p)] for p in PROMPTS]
    assert occ["pages_spilled"] == 0 and occ["kv_pressure"]["reserve"] == "full"
    assert occ["kv_pressure"]["spillable"] == 0


def test_zero_budget_preempts_instead(weights, solo_refs):
    """``--kv-host-pool-mb 0`` disables spilling: pressure preempts and
    parks, and the parked requests still finish byte for byte."""
    outs, occ = run_sched(weights, kv_pages=10, kv_reserve="optimistic", spill_headroom=4,
                          host_pool_mb=0)
    assert outs == [solo_refs[tuple(p)] for p in PROMPTS]
    assert occ["pages_spilled"] == 0 and occ["preemptions"] >= 1
    assert occ["kv_pressure"]["host_pool_bytes"] == 0
    assert occ["kv_pages_free"] == occ["kv_pages_total"], occ


def _decisions(sched, spilled, paged_in, preempted):
    """The three PROMPTS queued at once (under the scheduler's lock, so the
    first round admits the same pair on both sides); returns the greedy
    tokens and the deltas of the three counters read through the given
    functions."""
    before = (spilled(), paged_in(), preempted())
    try:
        with sched._cond:
            tickets = [sched.submit(list(p), max_new=MAX_NEW, temperature=0.0)
                       for p in PROMPTS]
        outs = [list(t.tokens()) for t in tickets]
        sched.pool.check()
    finally:
        sched.close(timeout=60)
    after = (spilled(), paged_in(), preempted())
    return outs, tuple(a - b for a, b in zip(after, before))


@pytest.mark.parametrize("kv_dtype,host_pool_mb", [(None, 8), ("q8", 8), (None, 0)],
                         ids=["dense-spill", "int8-spill", "dense-no-host-pool"])
def test_tier_decisions_match_jax(weights, jweights, kv_dtype, host_pool_mb):
    """The port's optimistic reservation, growth, reclaim ladder and
    spill-or-preempt choice against the JAX scheduler's on the same
    script: equal greedy tokens, equal pages spilled and paged in, equal
    preemptions.  ``max_wait_ms`` is set out of reach so no burst is
    clamped by a step-time estimate, which differs between the two, and
    aging is off so a slow run cannot reorder admissions.
    (An int8 pool without a host pool is not compared: the JAX
    scheduler's unpark writes back ``pages.k``/``pages.v`` without their
    scale planes and fails there; the port writes all four.)"""
    kw = dict(prefill_chunk=8, decode_burst=4, max_wait_ms=1e9, preempt_age_ms=0.0,
              overlap=False, kv_reserve="optimistic", spill_headroom=4, host_pool_mb=host_pool_mb)
    port = _decisions(
        SlotScheduler(paged_engine(weights, 10, kv_dtype=kv_dtype), **kw),
        lambda: obs_metrics.KV_PAGES_SPILLED.value,
        lambda: obs_metrics.KV_PAGES_PAGED_IN.value,
        lambda: obs_metrics.SCHED_PREEMPTIONS.total)
    jcfg, jp = jweights
    jeng = JEngine(jcfg, jp, mesh=jmake_mesh(tp=1, devices=jax.devices()[:1]), batch=2,
                   kv_pages=10, kv_page_size=PAGE, kv_dtype=kv_dtype)
    ref = _decisions(
        JScheduler(jeng, **kw),
        lambda: jmetrics.KV_PAGES_SPILLED.value,
        lambda: jmetrics.KV_PAGES_PAGED_IN.value,
        lambda: jmetrics.SCHED_PREEMPTIONS.total)
    assert port == ref
    spilled, paged_in, preempted = port[1]
    if host_pool_mb:
        assert spilled >= 1 and paged_in == spilled
    else:
        assert spilled == 0 and preempted >= 1


def test_solo_refs_match_jax(jweights, solo_refs):
    """The oracle of the tests above is JAX's batch-1 greedy run too."""
    jcfg, jp = jweights
    eng = JEngine(jcfg, jp, mesh=jmake_mesh(tp=1, devices=jax.devices()[:1]), batch=1)
    for p in PROMPTS:
        eng.reset()
        got = [t for t, _ in eng.generate_stream(
            p, len(p) + MAX_NEW, temperature=0.0, chunk=5)][len(p):]
        assert got == solo_refs[tuple(p)], p


def test_tier_metrics_in_both_formats(weights):
    run_sched(weights, kv_pages=10, kv_reserve="optimistic", spill_headroom=4,
              host_pool_mb=8)
    snap = obs_metrics.snapshot_json()
    assert snap["kv_pages_spilled"] >= 1 and snap["kv_spill_bytes"] > 0
    assert snap["kv_host_pool_bytes"] == 0
    text = obs_metrics.render_prometheus()
    for name in ("dllama_kv_pages_spilled_total", "dllama_kv_pages_paged_in_total",
                 "dllama_kv_spill_bytes_total", "dllama_kv_host_pool_bytes",
                 'dllama_kv_page_codec{codec="float32"} 1'):
        assert name in text, name
