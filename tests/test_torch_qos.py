"""The port's QoS (priority classes, aging, preemption with parking,
SLO shedding: runtime.scheduler and server.api) against the JAX package's,
on the tiny f32 model with the same weights (tests/test_qos.py's
scenarios).

* Admission: with contention a later ``interactive`` request admits before
  an earlier ``batch`` one; aging (``preempt_age_ms``) lets a waiting
  batch request outrank a fresh interactive one.
* Preemption: an interactive request finding every slot busy preempts a
  batch slot, which is exported, parked (in RAM, or in ``spill_dir``) and
  resumed to exactly its solo run's tokens, overlap on and off, from a
  spilled slot too; nothing leaks.  ``preempt_cap=0`` and a full parked
  area retire the victim ``preempted``; ``preempt=False`` preempts
  nothing.
* The same ticket script gives the JAX scheduler's admission order and
  victim.
* The server: the body field and the ``X-Dllama-Priority`` header, 400 for
  an unknown body class, shedding in the JAX order (``should_shed``), the
  flight record's class, and the metric families in both formats.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from dllama_tpu import quants
from dllama_tpu.models import config as jconfig, params as jparams
from dllama_tpu.obs import flight as jflight
from dllama_tpu.parallel.mesh import make_mesh as jmake_mesh
from dllama_tpu.runtime.engine import Engine as JEngine
from dllama_tpu.runtime.faults import FAULTS
from dllama_tpu.runtime.scheduler import SlotScheduler as JScheduler
from dllama_tpu.server.api import priority_level as jpriority_level
from dllama_tpu_torch.models import config as tconfig, params as tparams
from dllama_tpu_torch.obs import flight as tflight, metrics as obs_metrics
from dllama_tpu_torch.runtime.engine import Engine
from dllama_tpu_torch.runtime.scheduler import (PRIORITY_LEVELS, PRIORITY_NAMES,
                                                SlotScheduler)
from dllama_tpu_torch.server.api import ApiState, priority_level
from fixtures import write_tiny_model, write_tiny_tokenizer

SEQ = 64
PAGE = 4
P1 = [5, 9, 2]
P2 = [7, 3, 11, 4, 6, 1, 8]
P3 = [2, 4, 6]
BATCH, STD, INTER = (PRIORITY_LEVELS[k] for k in ("batch", "standard", "interactive"))


@pytest.fixture(scope="module")
def weights():
    jcfg = jconfig.tiny_config(seq_len=SEQ)
    jp = jparams.init_params(jcfg, seed=4)
    tcfg = tconfig.tiny_config(seq_len=SEQ)
    return jcfg, jp, tcfg, tparams.from_jax_params(
        {k: np.asarray(v) for k, v in jp.items()}, tcfg)


def engine(weights, batch=1, paged=False, **kw):
    _, _, tcfg, tp = weights
    if paged:
        kw.setdefault("kv_pages", batch * (SEQ // PAGE) + 1)
        kw["kv_page_size"] = PAGE
    return Engine(tcfg, tp, device="cpu", batch=batch, **kw)


def slowed(sched, s=0.05):
    """Each dispatch sleeps ``s`` first, so requests stay on the card."""
    eng = sched.engine
    step = eng.slot_step_async

    def slow(*a, **k):
        time.sleep(s)
        return step(*a, **k)
    eng.slot_step_async = slow
    return sched


@pytest.fixture(scope="module")
def solo_refs(weights):
    _, _, tcfg, tp = weights
    eng = Engine(tcfg, tp, device="cpu")
    refs = {}
    for p in (P1, P2, P3):
        eng.reset()
        refs[tuple(p)] = [t for t, _ in eng.generate_stream(
            p, len(p) + 30, temperature=0.0, chunk=5)][len(p):]
    return refs


def wait_active(sched, n, timeout=60):
    deadline = time.monotonic() + timeout
    while sched.occupancy()["active"] < n:
        assert time.monotonic() < deadline, "slots never filled"
        time.sleep(0.01)


def test_priority_level_parsing():
    for v in ("interactive", "Standard", " BATCH ", "turbo", None, 3):
        assert priority_level(v) == jpriority_level(v)
    assert priority_level(" BATCH ") == BATCH and priority_level("turbo") is None
    assert PRIORITY_NAMES[BATCH] == "batch"


def test_shed_order_unit():
    """interactive never sheds; batch on a burning fast window; standard
    only on a violating verdict — the JAX order."""
    class Shim:
        def __init__(self, verdict):
            self.slo = type("S", (), {"evaluate": staticmethod(lambda v=verdict: v)})()

    burning = {"status": "ok", "windows": ["30s", "5m"],
               "objectives": {"ttft_p95": {"burn": {"30s": 1.4, "5m": 0.2}}}}
    violating = {"status": "violating", "windows": ["30s", "5m"],
                 "objectives": {"ttft_p95": {"burn": {"30s": 2.0, "5m": 1.1}}}}
    calm = {"status": "ok", "windows": ["30s", "5m"],
            "objectives": {"ttft_p95": {"burn": {"30s": 0.1, "5m": 0.0}}}}
    from dllama_tpu.server.api import ApiState as JApiState
    for verdict in (calm, burning, violating):
        for lvl in PRIORITY_LEVELS.values():
            assert ApiState.should_shed(Shim(verdict), lvl) == \
                JApiState.should_shed(Shim(verdict), lvl)
    assert ApiState.should_shed(Shim(burning), BATCH)
    assert not ApiState.should_shed(Shim(burning), STD)
    assert ApiState.should_shed(Shim(violating), STD)
    assert not ApiState.should_shed(Shim(violating), INTER)


def test_qos_metrics_in_both_formats():
    obs_metrics.SCHED_PREEMPTIONS.inc("no_free_slot")
    obs_metrics.SCHED_PREEMPT_PARKED.set(2)
    obs_metrics.ADMISSIONS_SHED.inc("batch")
    snap = obs_metrics.snapshot_json()
    assert snap["sched_preemptions"]["no_free_slot"] >= 1
    assert snap["sched_preempt_parked"] == 2
    assert snap["admissions_shed"]["batch"] >= 1
    text = obs_metrics.render_prometheus()
    assert 'dllama_sched_preemptions_total{reason="no_free_slot"}' in text
    assert "dllama_sched_preempt_parked 2" in text
    assert 'dllama_admissions_shed_total{class="batch"}' in text
    obs_metrics.SCHED_PREEMPT_PARKED.set(0)


def _race(sched, first, later, gap):
    """``first`` = (key, prompt, priority) submitted behind a slot-holder,
    ``later`` ``gap`` s after; returns {key: (finish time, tokens)}."""
    done = {}

    def run(key, prompt, prio):
        t = sched.submit(prompt, 8, priority=prio)
        toks = list(t.tokens())
        done[key] = (time.monotonic(), toks)

    hold = sched.submit(P2, 12)
    a = threading.Thread(target=run, args=first)
    a.start()
    time.sleep(gap)
    b = threading.Thread(target=run, args=later)
    b.start()
    list(hold.tokens())
    a.join(120)
    b.join(120)
    return done


def test_priority_ordered_admission(weights, solo_refs):
    sched = slowed(SlotScheduler(engine(weights), prefill_chunk=4, decode_burst=4,
                                 preempt=False, preempt_age_ms=0.0), 0.02)
    try:
        done = _race(sched, ("batch", P1, BATCH), ("inter", P3, INTER), 0.15)
        assert done["inter"][0] < done["batch"][0]
        assert done["inter"][1] == solo_refs[tuple(P3)][:8]
        assert done["batch"][1] == solo_refs[tuple(P1)][:8]
    finally:
        sched.close()


def test_aging_bounds_starvation(weights, solo_refs):
    sched = slowed(SlotScheduler(engine(weights), prefill_chunk=4, decode_burst=4,
                                 preempt=False, preempt_age_ms=60.0), 0.02)
    try:
        done = _race(sched, ("batch", P1, BATCH), ("inter", P3, INTER), 0.3)
        assert done["batch"][0] < done["inter"][0]
        assert done["batch"][1] == solo_refs[tuple(P1)][:8]
    finally:
        sched.close()


def _preempt_run(sched, solo_refs, n_inter=6):
    """Two batch requests fill the slots, then an interactive one arrives;
    returns {key: (tokens, finish, preempt_count)}."""
    done = {}

    def run(key, prompt, n, prio):
        t = sched.submit(prompt, n, priority=prio)
        done[key] = (list(t.tokens()), t.finish, t.preempt_count)

    bs = [threading.Thread(target=run, args=(k, p, 30, BATCH))
          for k, p in (("b1", P1), ("b2", P2))]
    for b in bs:
        b.start()
    wait_active(sched, 2)
    time.sleep(0.3)
    it = threading.Thread(target=run, args=("it", P3, n_inter, INTER))
    it.start()
    it.join(120)
    del sched.engine.slot_step_async  # full speed again
    for b in bs:
        b.join(240)
    return done


def _audit(sched):
    occ = sched.occupancy()
    assert occ["active"] == 0 and occ["parked"] == 0, occ
    assert occ["kv_pages_free"] == occ["kv_pages_total"], occ
    assert occ["kv_pressure"]["host_pool_bytes"] == 0 and not occ["kv_pressure"]["spilled_slots"]
    sched.pool.check()


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "no-overlap"])
def test_preempt_park_resume_byte_parity(weights, solo_refs, overlap):
    """The interactive request preempts a batch slot (export, park, pages
    freed) and serves; the victim resumes to its solo tokens."""
    sched = slowed(SlotScheduler(engine(weights, 2, paged=True), prefill_chunk=4,
                                 decode_burst=4, overlap=overlap, preempt_age_ms=0.0,
                                 prefix_reuse=False))
    base = sum((obs_metrics.snapshot_json().get("sched_preemptions") or {}).values())
    try:
        done = _preempt_run(sched, solo_refs)
        assert done["it"][:2] == (solo_refs[tuple(P3)][:6], "length")
        pre = obs_metrics.snapshot_json().get("sched_preemptions") or {}
        assert sum(pre.values()) - base >= 1 and sched.stats["preemptions"] >= 1
        assert any(done[k][2] >= 1 for k in ("b1", "b2"))
        for k, p in (("b1", P1), ("b2", P2)):
            assert done[k][:2] == (solo_refs[tuple(p)][:30], "length"), k
        assert sched.stats["resumed"] >= 1
        _audit(sched)
    finally:
        sched.close()


def test_preempt_spilled_slot_resume_byte_parity(weights, solo_refs):
    """On an over-committed optimistic pool a batch slot may sit spilled in
    host RAM when the interactive request preempts it: its record comes
    from the host copy and it still resumes to its solo tokens."""
    sched = slowed(SlotScheduler(
        engine(weights, 2, paged=True, kv_pages=11), prefill_chunk=4, decode_burst=4,
        preempt_age_ms=0.0, prefix_reuse=False, kv_reserve="optimistic",
        spill_headroom=4, host_pool_mb=8))
    spilled0 = obs_metrics.KV_PAGES_SPILLED.value
    try:
        done = _preempt_run(sched, solo_refs)
        assert obs_metrics.KV_PAGES_SPILLED.value - spilled0 >= 1
        assert done["it"][0] == solo_refs[tuple(P3)][:6]
        for k, p in (("b1", P1), ("b2", P2)):
            assert done[k][:2] == (solo_refs[tuple(p)][:30], "length"), k
        _audit(sched)
    finally:
        sched.close()


@pytest.mark.parametrize("kw", [{"preempt_cap": 0}, {"parked_max": 0}],
                         ids=["cap-0", "parked-area-full"])
def test_preempt_without_parking_retires_preempted(weights, kw):
    # prefix_reuse off: the page audit is exact (the radix tree would keep
    # the victim's prompt page)
    sched = slowed(SlotScheduler(engine(weights, 1, paged=True), prefill_chunk=4,
                                 decode_burst=2, preempt_age_ms=0.0, prefix_reuse=False,
                                 **kw))
    try:
        victim = sched.submit(P2, 30, priority=BATCH)
        got = []
        t = threading.Thread(target=lambda: got.extend(victim.tokens()))
        t.start()
        wait_active(sched, 1)
        time.sleep(0.2)
        inter = sched.submit(P3, 4, priority=INTER)
        assert len(list(inter.tokens())) == 4 and inter.finish == "length"
        t.join(120)
        assert victim.finish == "preempted" and len(got) < 30
        occ = sched.occupancy()
        assert occ["parked"] == 0 and occ["kv_pages_free"] == occ["kv_pages_total"]
    finally:
        sched.close()


def test_no_preempt_never_preempts(weights, solo_refs):
    sched = slowed(SlotScheduler(engine(weights, 1, paged=True), prefill_chunk=4,
                                 decode_burst=2, preempt=False, preempt_age_ms=0.0))
    try:
        victim = sched.submit(P2, 20, priority=BATCH)
        it = victim.tokens()
        next(it)
        inter = sched.submit(P3, 4, priority=INTER)
        rest = list(it)
        assert victim.finish == "length" and len(rest) == 19
        assert list(inter.tokens()) == solo_refs[tuple(P3)][:4]
        assert sched.stats["preemptions"] == 0 and victim.preempt_count == 0
    finally:
        sched.close()


def test_preempt_spill_dir_roundtrip(weights, solo_refs, tmp_path):
    """The parked record goes through ``spill_dir`` and the resume is
    still byte for byte; the file is removed after."""
    sched = slowed(SlotScheduler(engine(weights, 1, paged=True), prefill_chunk=4,
                                 decode_burst=2, preempt_age_ms=0.0,
                                 spill_dir=str(tmp_path)))
    try:
        victim = sched.submit(P2, 30, priority=BATCH)
        got = []
        t = threading.Thread(target=lambda: got.extend(victim.tokens()))
        t.start()
        wait_active(sched, 1)
        time.sleep(0.2)
        inter = sched.submit(P3, 4, priority=INTER)
        spilled = []
        while inter.finish is None:
            spilled += [str(p) for p in tmp_path.glob("*.dlreq")]
            time.sleep(0.005)
        list(inter.tokens())
        t.join(240)
        assert spilled and victim.finish == "length"
        assert got == solo_refs[tuple(P2)][:30]
        assert not list(tmp_path.glob("*.dlreq"))
    finally:
        sched.close()


# -- the same decisions as the JAX scheduler -------------------------------

SCRIPT = [("a", P1, BATCH), ("b", P2, STD), ("c", P3, INTER), ("d", [4, 4, 1], BATCH),
          ("e", [9, 1], INTER), ("f", [3, 3, 3, 3], STD)]


def _admission_order(sched, flight):
    """Queue SCRIPT while the scheduler is parked, release it; the order
    of the flight records' admission times (one slot, no preemption)."""
    with sched.exclusive():
        tickets = [(k, sched.submit(p, 3, temperature=0.0, priority=lvl))
                   for k, p, lvl in SCRIPT]
    for _, t in tickets:
        list(t.tokens())
    return [k for k, t in sorted(tickets, key=lambda kt: flight.get(kt[1].rid)["admitted_at"])]


def _victim(sched, slow):
    """Fill two slots with batch requests of different budgets (the longer
    remaining one is the victim), add an interactive one; returns which
    batch request was preempted."""
    with slow():
        ts = {"short": sched.submit(P1, 12, priority=BATCH),
              "long": sched.submit(P2, 30, priority=BATCH)}
        its = {k: t.tokens() for k, t in ts.items()}
        for it in its.values():
            next(it)
        inter = sched.submit(P3, 3, priority=INTER)
        list(inter.tokens())
    for it in its.values():
        list(it)
    return sorted(k for k, t in ts.items() if t.preempt_count)


def test_decisions_match_jax(weights):
    jcfg, jp, _, _ = weights
    jmesh = jmake_mesh(tp=1, devices=jax.devices()[:1])
    orders, victims = [], []
    # the port
    s = SlotScheduler(engine(weights), prefill_chunk=4, preempt=False, preempt_age_ms=0.0)
    try:
        orders.append(_admission_order(s, tflight))
    finally:
        s.close()
    s = SlotScheduler(engine(weights, 2, paged=True), prefill_chunk=4, decode_burst=2,
                      preempt_age_ms=0.0, prefix_reuse=False)

    class _Slow:
        def __enter__(self):
            slowed(s)

        def __exit__(self, *a):
            del s.engine.slot_step_async
    try:
        victims.append(_victim(s, _Slow))
    finally:
        s.close()
    # the JAX package
    j = JScheduler(JEngine(jcfg, jp, mesh=jmesh, batch=1), prefill_chunk=4, preempt=False,
                   preempt_age_ms=0.0, overlap=False)
    try:
        orders.append(_admission_order(j, jflight))
    finally:
        j.close()
    j = JScheduler(JEngine(jcfg, jp, mesh=jmesh, batch=2, kv_pages=2 * (SEQ // PAGE) + 1,
                           kv_page_size=PAGE),
                   prefill_chunk=4, decode_burst=2, preempt_age_ms=0.0, prefix_reuse=False,
                   overlap=False)

    class _JSlow:
        def __enter__(self):
            FAULTS.install("engine.device_step=delay:0.05x1000")

        def __exit__(self, *a):
            FAULTS.clear()
    try:
        victims.append(_victim(j, _JSlow))
    finally:
        FAULTS.clear()
        j.close()
    assert orders[0] == orders[1] == ["c", "e", "b", "f", "a", "d"]
    assert victims[0] == victims[1] == ["long"]


# -- the server ------------------------------------------------------------

class FakeSlo:
    """evaluate() returns the verdict the test loaded."""

    def __init__(self):
        self.verdict = {"status": "ok", "windows": ["30s", "5m"], "objectives": {}}

    def evaluate(self):
        return self.verdict

    def burn(self, fast, slow=0.0):
        self.verdict = {"status": "violating" if slow >= 1.0 else "ok",
                        "windows": ["30s", "5m"],
                        "objectives": {"ttft_p95": {"burn": {"30s": fast, "5m": slow}}}}


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    from dllama_tpu_torch.server import api
    d = tmp_path_factory.mktemp("torch_qos")
    m, t = str(d / "tiny.m"), str(d / "tiny.t")
    write_tiny_model(m, ftype=quants.Q40)
    write_tiny_tokenizer(t)
    srv = api.start(["--model", m, "--tokenizer", t, "--device", "cpu", "--host",
                     "127.0.0.1", "--port", "0", "--temperature", "0", "--batch-slots", "2",
                     "--kv-pages", "40", "--kv-page-size", "4", "--buffer-float-type", "f32"])
    yield srv.state, f"http://127.0.0.1:{srv.server_address[1]}"
    api.stop(srv)


def post(base, path, body, headers=None):
    req = urllib.request.Request(base + path, json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json",
                                          **(headers or {})})
    return urllib.request.urlopen(req, timeout=120)


def test_priority_field_and_header_reach_the_scheduler(server):
    state, base = server
    levels = []
    submit = state.scheduler.submit

    def spy(*a, **k):
        levels.append(k["priority"])
        return submit(*a, **k)
    state.scheduler.submit = spy
    try:
        body = {"prompt": "hello", "max_tokens": 2}
        for extra, hdr in (({"priority": "batch"}, None), ({}, "interactive"),
                           ({"priority": "interactive"}, "batch"), ({}, "turbo"), ({}, None)):
            with post(base, "/v1/completions", dict(body, **extra),
                      {"X-Dllama-Priority": hdr} if hdr else None) as r:
                assert r.status == 200
        with post(base, "/v1/chat/completions",
                  {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 2,
                   "priority": "batch"}) as r:
            assert r.status == 200
    finally:
        state.scheduler.submit = submit
    assert levels == [BATCH, INTER, INTER, STD, STD, BATCH]


def test_unknown_priority_body_is_400(server):
    _, base = server
    with pytest.raises(urllib.error.HTTPError) as ei:
        post(base, "/v1/completions", {"prompt": "x", "max_tokens": 2, "priority": "turbo"})
    assert ei.value.code == 400
    assert "unknown priority class" in ei.value.read().decode()


def test_shed_order_live(server):
    state, base = server
    slo = FakeSlo()
    state.slo = slo
    body = {"prompt": "hello", "max_tokens": 2}
    try:
        with post(base, "/v1/completions", dict(body, priority="batch")) as r:
            assert r.status == 200
        slo.burn(fast=1.5)
        for extra, hdr in (({"priority": "batch"}, None), ({}, "batch")):
            with pytest.raises(urllib.error.HTTPError) as ei:
                post(base, "/v1/completions", dict(body, **extra),
                     {"X-Dllama-Priority": hdr} if hdr else None)
            assert ei.value.code == 429 and int(ei.value.headers["Retry-After"]) >= 1
        with post(base, "/v1/completions", dict(body, priority="standard")) as r:
            assert r.status == 200
        slo.burn(fast=2.0, slow=1.2)
        with pytest.raises(urllib.error.HTTPError) as ei:
            post(base, "/v1/completions", dict(body, priority="standard"))
        assert ei.value.code == 429
        with post(base, "/v1/completions", dict(body, priority="interactive")) as r:
            assert r.status == 200
        shed = obs_metrics.snapshot_json()["admissions_shed"]
        assert shed["batch"] >= 2 and shed["standard"] >= 1 and "interactive" not in shed
    finally:
        state.slo = None


def test_flight_record_and_health_carry_qos(server):
    _, base = server
    req = urllib.request.Request(base + "/v1/completions",
                                 json.dumps({"prompt": "hello", "max_tokens": 2,
                                             "priority": "interactive"}).encode(),
                                 headers={"X-Request-Id": "qos-flight-1"})
    with urllib.request.urlopen(req, timeout=60) as r:
        assert r.headers["X-Request-Id"] == "qos-flight-1"
    with urllib.request.urlopen(base + "/debug/requests/qos-flight-1", timeout=30) as r:
        assert json.loads(r.read())["priority"] == "interactive"
    with urllib.request.urlopen(base + "/debug/requests?n=5", timeout=30) as r:
        rows = json.loads(r.read())["requests"]
    mine = [x for x in rows if x["request_id"] == "qos-flight-1"]
    assert mine and mine[0]["priority"] == "interactive" and "preempt_count" in mine[0]
    with urllib.request.urlopen(base + "/health", timeout=30) as r:
        health = json.loads(r.read())
    qos = health["capacity"]["qos"]
    assert qos["preempt"] is True and qos["parked"] == 0
    assert health["scheduler"]["parked"] == 0
