"""The port's overlapped dispatch pipeline (runtime.scheduler
``SlotScheduler(overlap=True)``, the default) on the CPU, with the parity
cases of tests/test_overlap.py and no timing assertion:

* greedy output is byte-identical with the pipeline on and off under
  staggered ragged traffic, and equal to each prompt's solo stream;
* an EOS mid-pipeline stops its row as the synchronous path does;
* a cancel mid-decode leaves a prefix of the solo stream;
* ``flush()`` lands and discards the in-flight pipelined dispatch;
* the streams equal the JAX package's ``SlotScheduler(overlap=True)`` on
  the same weights and requests.

A dispatch's landing is slowed (a sleep before the wait) where a case
needs the pipeline to stay full while the host acts.
"""

import threading
import time

import jax
import numpy as np
import pytest

from dllama_tpu.models import config as jconfig, params as jparams
from dllama_tpu.parallel.mesh import make_mesh
from dllama_tpu.runtime.engine import Engine as JEngine
from dllama_tpu.runtime.scheduler import SlotScheduler as JScheduler
from dllama_tpu_torch.models import config as tconfig, params as tparams
from dllama_tpu_torch.runtime.engine import Engine
from dllama_tpu_torch.runtime.scheduler import SlotScheduler

SEQ = 64
PAGE = 4
PROMPTS = ([5, 9, 2], [7, 3, 11, 4, 6, 1, 8], [2, 4, 6], [9, 8, 7, 6])


@pytest.fixture(scope="module")
def weights():
    jcfg = jconfig.tiny_config(seq_len=SEQ)
    jp = jparams.init_params(jcfg, seed=4)
    tcfg = tconfig.tiny_config(seq_len=SEQ)
    return jcfg, jp, tcfg, tparams.from_jax_params({k: np.asarray(v) for k, v in jp.items()},
                                                   tcfg)


def _engine(weights, batch=4, paged=False):
    _, _, tcfg, tp = weights
    kw = dict(kv_pages=batch * (SEQ // PAGE) + 1, kv_page_size=PAGE) if paged else {}
    return Engine(tcfg, tp, device="cpu", batch=batch, **kw)


@pytest.fixture(scope="module")
def solo(weights):
    """Greedy solo completions per prompt: the parity oracle."""
    _, _, tcfg, tp = weights
    eng = Engine(tcfg, tp, device="cpu")
    refs = {}
    for p in PROMPTS + ([7, 3, 11, 4, 6, 1, 8, 13],):
        eng.reset()
        refs[tuple(p)] = [t for t, _ in eng.generate_stream(
            list(p), len(p) + 30, temperature=0.0, chunk=5)][len(p):]
    return refs


class _Slow:
    """A dispatch handle whose landing waits ``delay`` seconds first, so
    the pipeline stays full while the host acts."""

    def __init__(self, handle, delay):
        self.h, self.delay, self.last_dev = handle, delay, handle.last_dev

    def wait(self):
        time.sleep(self.delay)
        return self.h.wait()


def _slow(eng, delay=0.02):
    real = eng.slot_step_async
    eng.slot_step_async = lambda *a, **k: _Slow(real(*a, **k), delay)
    return eng


def _traffic(sched, solo, eos_prompt=None, eos_at=3) -> dict:
    """Staggered ragged greedy traffic; returns {prompt: (tokens, finish)}.
    ``eos_prompt`` adds a request whose EOS id is picked from its own solo
    stream (a stop mid-burst)."""
    results = {}

    def run(p, delay, max_new, eos_ids):
        time.sleep(delay)
        t = sched.submit(list(p), max_new, eos_ids=eos_ids)
        results[tuple(p)] = (list(t.tokens()), t.finish)

    jobs = [(p, d, 12, ()) for p, d in zip(PROMPTS, (0.0, 0.03, 0.2, 0.4))]
    if eos_prompt is not None:
        p = list(eos_prompt) + [13]
        jobs.append((p, 0.1, 25, (solo[tuple(p)][eos_at],)))
    threads = [threading.Thread(target=run, args=j) for j in jobs]
    for th in threads:
        th.start()
    for th in threads:
        th.join(120)
    assert len(results) == len(jobs)
    return results


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_overlap_on_off_greedy_byte_parity(weights, solo, paged):
    """Greedy output is the same with the pipeline on and off, and each
    stream is its prompt's solo stream; the on path overlapped."""
    outs = {}
    for overlap in (False, True):
        sched = SlotScheduler(_slow(_engine(weights, paged=paged), 0.005), prefill_chunk=4,
                              decode_burst=6, overlap=overlap)
        try:
            outs[overlap] = _traffic(sched, solo)
            sched.flush()
            assert sched._inflight_n == 0
            if overlap:
                assert sched.stats["overlapped"] > 0, sched.stats
            else:
                assert sched.stats["overlapped"] == sched.stats["discarded"] == 0
        finally:
            sched.close()
    assert outs[True] == outs[False]
    for p in PROMPTS:
        assert outs[True][tuple(p)] == (solo[tuple(p)][:12], "length")


def test_overlap_eos_stop_parity(weights, solo):
    """A row that hits its EOS mid-pipeline retires row-wise; its own
    truncation and its neighbors' streams match the synchronous path."""
    outs = {}
    for overlap in (False, True):
        sched = SlotScheduler(_slow(_engine(weights), 0.005), prefill_chunk=4,
                              decode_burst=6, overlap=overlap)
        try:
            outs[overlap] = _traffic(sched, solo, eos_prompt=PROMPTS[1])
        finally:
            sched.close()
    assert outs[True] == outs[False]
    key = tuple(list(PROMPTS[1]) + [13])
    got, finish = outs[True][key]
    assert finish == "stop" and got == solo[key][:3]


def test_overlap_cancel_partial_prefix(weights, solo):
    """A cancel with the pipeline live: the partial output is a prefix of
    the solo stream (no token of a discarded dispatch leaks) and nothing
    stays in flight."""
    sched = SlotScheduler(_slow(_engine(weights)), prefill_chunk=4, decode_burst=4,
                          overlap=True)
    try:
        t = sched.submit(list(PROMPTS[0]), 50)
        got = []
        for tok in t.tokens():
            got.append(tok)
            if len(got) >= 3:
                t.cancel("aborted")
        assert t.finish == "aborted"
        assert got == solo[tuple(PROMPTS[0])][:len(got)] and 3 <= len(got) < 50
        sched.flush()
        assert sched._inflight_n == 0
    finally:
        sched.close()


def test_flush_discards_inflight_dispatch(weights, solo):
    """``flush()`` against a saturated pipeline lands and discards the
    pipelined dispatch (the ``discarded`` count moves, zero in flight after
    each flush), and the stream is still its solo stream."""
    sched = SlotScheduler(_slow(_engine(weights, batch=2), 0.03), prefill_chunk=4,
                          decode_burst=2, overlap=True)
    try:
        t = sched.submit(list(PROMPTS[1]), 30)
        it = t.tokens()
        got = [next(it) for _ in range(3)]
        for _ in range(5):
            sched.flush()
            assert sched._inflight_n == 0
            time.sleep(0.05)
        got += list(it)
        assert t.finish == "length"
        assert got == solo[tuple(PROMPTS[1])][:30]
        assert sched.stats["discarded"] > 0, sched.stats
        assert sched.stats["overlapped"] >= sched.stats["discarded"]
    finally:
        sched.close()


def test_streams_match_jax_overlapped_scheduler(weights):
    """The same staggered requests through the JAX package's
    ``SlotScheduler(overlap=True)`` and the port's: the same greedy
    streams and finishes, on a paged pool."""
    jcfg, jp, _, _ = weights
    jeng = JEngine(jcfg, jp, mesh=make_mesh(tp=1, devices=jax.devices()[:1]), batch=4,
                   kv_pages=4 * (SEQ // PAGE) + 1, kv_page_size=PAGE)
    outs = []
    for sched in (JScheduler(jeng, prefill_chunk=4, decode_burst=6, overlap=True),
                  SlotScheduler(_engine(weights, paged=True), prefill_chunk=4,
                                decode_burst=6)):
        try:
            outs.append(_traffic(sched, {}))
        finally:
            sched.close()
    assert outs[0] == outs[1]
