"""The port's slot scheduler and page bookkeeping (runtime.scheduler,
runtime.pagepool) against the JAX package's, on a tiny f32 model with the
same weights.

* PagePool/RadixTree: one scripted sequence of operations gives the same
  results in both packages.
* Greedy streams under ragged staggered traffic (4 slots, prefill chunk 8)
  are token-identical to the port's solo engine and to the JAX
  ``SlotScheduler`` with ``overlap=False``, dense and int8 pools (an int8
  stream is held to JAX's int8 stream and to the same prompt alone).
* Recycled pages leak no stale KV; prefix reuse gives the same tokens for
  fewer prefill tokens; an exhausted pool defers admission, then recovers.
"""

import threading
import time

import jax
import numpy as np
import pytest

from dllama_tpu.models import config as jconfig, params as jparams
from dllama_tpu.parallel.mesh import make_mesh
from dllama_tpu.runtime import pagepool as jpp
from dllama_tpu.runtime.engine import Engine as JEngine
from dllama_tpu.runtime.scheduler import SlotScheduler as JScheduler
from dllama_tpu_torch.models import config as tconfig, params as tparams
from dllama_tpu_torch.runtime import pagepool as tpp
from dllama_tpu_torch.runtime.engine import ContextOverflow, Engine
from dllama_tpu_torch.runtime.scheduler import SlotScheduler

PAGE = 8
SEQ = 64
PROMPTS = ([5, 9, 2], [7, 3, 11, 4, 6, 1, 8], [2, 4, 6], [9, 8, 7, 6])
MAX_NEW = 30


def _serve(sched, prompts, max_new=MAX_NEW, stagger=0.02) -> dict:
    """Submit ``prompts`` from threads, ``stagger`` s apart; returns
    {prompt: (tokens, ticket)}."""
    out = {}

    def run(p, delay):
        time.sleep(delay)
        t = sched.submit(list(p), max_new, temperature=0.0)
        out[tuple(p)] = (list(t.tokens()), t)

    ths = [threading.Thread(target=run, args=(p, stagger * i)) for i, p in enumerate(prompts)]
    for t in ths:
        t.start()
    for t in ths:
        t.join(120)
    assert len(out) == len(set(map(tuple, prompts)))
    return out


@pytest.fixture(scope="module")
def weights():
    jcfg = jconfig.tiny_config(seq_len=SEQ)
    jp = jparams.init_params(jcfg, seed=4)
    tcfg = tconfig.tiny_config(seq_len=SEQ)
    return jcfg, jp, tcfg, tparams.from_jax_params({k: np.asarray(v) for k, v in jp.items()}, tcfg)


def _port_engine(weights, batch=4, kv_pages=None, quant=False):
    _, _, tcfg, tp = weights
    return Engine(tcfg, tp, device="cpu", batch=batch,
                  kv_pages=kv_pages or batch * (SEQ // PAGE) + 1, kv_page_size=PAGE,
                  kv_dtype="q8" if quant else None)


@pytest.fixture(scope="module")
def solo(weights):
    """Greedy completions of each prompt alone on the port's contiguous
    batch-1 engine."""
    _, _, tcfg, tp = weights
    eng = Engine(tcfg, tp, device="cpu")
    refs = {}
    for p in PROMPTS:
        eng.reset()
        refs[tuple(p)] = [t for t, _ in eng.generate_stream(
            list(p), len(p) + MAX_NEW, temperature=0.0, chunk=5)][len(p):]
    return refs


@pytest.fixture(scope="module")
def jax_streams(weights):
    """The JAX scheduler's greedy streams (overlap off), dense and int8."""
    jcfg, jp, _, _ = weights
    out = {}
    for quant in (False, True):
        eng = JEngine(jcfg, jp, mesh=make_mesh(tp=1, devices=jax.devices()[:1]), batch=4,
                      kv_pages=4 * (SEQ // PAGE) + 1, kv_page_size=PAGE,
                      kv_dtype="q8" if quant else None)
        sched = JScheduler(eng, prefill_chunk=8, overlap=False)
        try:
            out[quant] = {p: toks for p, (toks, _) in _serve(sched, PROMPTS).items()}
        finally:
            sched.close()
    return out


def test_pagepool_and_radix_match_jax():
    results = []
    for mod in (jpp, tpp):
        pool = mod.PagePool(9, 2)
        tree = mod.RadixTree(pool)
        log = []
        a = pool.alloc(3)
        log.append((a, pool.available))
        log.append(tree.insert([1, 2, 3, 4, 5], a[:2]))
        pool.incref(a[:1])
        pool.decref(a)
        log.append((pool.available, pool.in_use, len(tree)))
        log.append(tree.match([1, 2, 3, 4, 9]))
        log.append(tree.match([1, 2, 7]))
        b = pool.alloc(2)
        log.append(tree.insert([1, 2, 8, 8], [a[0], b[0]]))
        pool.decref(b)
        with pytest.raises(mod.PagePoolExhausted):
            pool.alloc(pool.available + 1)
        log.append((pool.available, len(tree)))
        log.append(tree.evict(2))
        pool.decref(a[:1])
        log.append((pool.available, len(tree), tree.evict(5), pool.available))
        pool.check()
        results.append(log)
    assert results[0] == results[1]


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "kv_int8"])
def test_ragged_greedy_matches_solo_and_jax(weights, solo, jax_streams, quant):
    eng = _port_engine(weights, quant=quant)
    sched = SlotScheduler(eng, prefill_chunk=8, decode_burst=4)
    try:
        got = _serve(sched, PROMPTS)
        alone = {tuple(p): _serve(sched, [p])[tuple(p)][0] for p in PROMPTS} if quant else None
    finally:
        sched.close()
    for p in PROMPTS:
        toks, t = got[tuple(p)]
        assert t.finish == "length" and len(toks) == MAX_NEW
        assert toks == jax_streams[quant][tuple(p)], f"prompt {p}: port vs JAX"
        if quant:
            assert toks == alone[tuple(p)], f"prompt {p}: ragged traffic vs alone"
        else:
            assert toks == solo[tuple(p)], f"prompt {p}: slot vs solo engine"


def test_contiguous_slot_rows_match_solo(weights, solo):
    _, _, tcfg, tp = weights
    sched = SlotScheduler(Engine(tcfg, tp, device="cpu", batch=3), prefill_chunk=4)
    try:
        got = _serve(sched, PROMPTS, max_new=12)
    finally:
        sched.close()
    for p in PROMPTS:
        assert got[tuple(p)][0] == solo[tuple(p)][:12]


def test_recycled_pages_leak_no_stale_kv(weights, solo):
    """Two waves of twice as many requests as slots: every page goes
    free → bound → free → bound, and every stream stays its solo stream."""
    sched = SlotScheduler(_port_engine(weights), prefill_chunk=8, decode_burst=4)
    try:
        for wave in range(2):
            prompts = [list(p) for p in PROMPTS] + [p + [wave + 1] for p in PROMPTS]
            got = _serve(sched, prompts, max_new=10, stagger=0.0)
            for p in PROMPTS:
                assert got[tuple(p)][0] == solo[tuple(p)][:10]
        with sched._cond:
            sched.pool.check()
            assert sum(len(s.pages) for s in sched.slots) == 0
    finally:
        sched.close()


def test_prefix_reuse_same_tokens_fewer_prefill_tokens(weights):
    rng = np.random.RandomState(11)
    system = [int(x) for x in rng.randint(1, 128, 4 * PAGE)]
    prompt = system + [3, 1]
    runs = {}
    for reuse in (True, False):
        sched = SlotScheduler(_port_engine(weights, batch=2), prefill_chunk=4,
                              prefix_reuse=reuse)
        try:
            runs[reuse] = [_serve(sched, [prompt], max_new=8)[tuple(prompt)] for _ in range(2)]
            stats = dict(sched.stats)
        finally:
            sched.close()
        if reuse:
            assert stats["prefix_hits"] == 1
            assert stats["prefix_tokens_reused"] == 4 * PAGE
    (o1, t1), (o2, t2) = runs[True]
    assert o1 == o2 and len(o1) == 8
    assert t1.prefilled == len(prompt) and t2.prefilled == len(prompt) - 4 * PAGE
    assert [o for o, _ in runs[False]] == [o1, o1]
    assert all(t.prefilled == len(prompt) for _, t in runs[False])


def test_pool_exhaustion_defers_then_recovers(weights):
    """6 usable pages of 8 tokens; each request reserves min(3 + 40, 64) =
    43 tokens = 6 pages, so one is resident at a time; a request that could
    never fit fails at submit."""
    sched = SlotScheduler(_port_engine(weights, batch=2, kv_pages=7), prefill_chunk=4,
                          prefix_reuse=False)
    try:
        with pytest.raises(ContextOverflow):
            sched.submit(list(range(1, 60)), 40)
        outs = []

        def run():
            t = sched.submit(list(PROMPTS[0]), 40, temperature=0.0)
            outs.append((list(t.tokens()), t.finish))

        ths = [threading.Thread(target=run) for _ in range(2)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(120)
        assert len(outs) == 2 and outs[0] == outs[1]
        assert outs[0][1] == "length" and len(outs[0][0]) == 40
        assert sched.stats["kv_pool_exhausted"] >= 1
        with sched._cond:
            assert sched.pool.available == sched.pool.capacity
            sched.pool.check()
    finally:
        sched.close()
