"""The port's fault injection (dllama_tpu_torch.runtime.faults) against the
JAX package's: the same grammar, the same firing windows, and every fault
point firing at its counterpart site with the JAX package's effect, on the
tiny f32 model with the same weights or the tiny Q40 fixture files.

* Grammar: ``parse_spec`` gives equal fields on good specs and the same
  error class on bad ones.
* Firing: over N hits, each registry performs the same actions (``@skip``,
  ``xtimes``, several faults on one point).
* Sites: ``server.emit_delta=disconnect@1`` ends a stream after as many
  deltas as the JAX server's; ``server.read_body=raise:TimeoutError`` gets
  the same status; ``engine.numeric=nan`` raises ``NumericFault`` (and the
  server answers 500, then serves the next request, as JAX's does);
  ``engine.device_step=delay`` under ``step_timeout`` raises
  ``StepTimeout`` (and the server turns degraded: ``/health`` 503);
  ``engine.device_step=nan`` poisons the logits; ``spec.propose=corrupt``
  accepts JAX's count of drafts (none) and serves speculation-off's greedy
  tokens; ``kv.spill=raise`` abandons each spill and makes the tier
  decisions JAX's scheduler makes without a host pool (the JAX scheduler's
  own loop dies on the raise, against its documented fallback);
  ``sched.host_fanout=delay`` leaves the greedy tokens unchanged.
  ``io.read_tensor`` is held in tests/test_torch_integrity.py and
  ``pod.respawn`` in tests/test_torch_pod.py.
"""

import json
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from dllama_tpu import quants
from dllama_tpu.models import config as jconfig, params as jparams
from dllama_tpu.obs import metrics as jmetrics
from dllama_tpu.parallel.mesh import make_mesh as jmake_mesh
from dllama_tpu.runtime import faults as jfaults, spec as jspec
from dllama_tpu.runtime.engine import Engine as JEngine, NumericFault as JNumericFault
from dllama_tpu.runtime.engine import StepTimeout as JStepTimeout
from dllama_tpu.runtime.scheduler import SlotScheduler as JScheduler
from dllama_tpu_torch.models import config as tconfig, params as tparams
from dllama_tpu_torch.obs import metrics as obs_metrics
from dllama_tpu_torch.runtime import faults, spec as tspec
from dllama_tpu_torch.runtime.engine import Engine, NumericFault, StepTimeout
from dllama_tpu_torch.runtime.scheduler import SlotScheduler
from fixtures import write_tiny_model, write_tiny_tokenizer

SEQ = 64
PAGE = 4
PROMPTS = ([5, 9, 2], [7, 3, 11, 4, 6, 1, 8], [2, 4, 6])
MAX_NEW = 24


@pytest.fixture(autouse=True)
def _clean_registries():
    faults.FAULTS.clear()
    jfaults.FAULTS.clear()
    yield
    faults.FAULTS.clear()
    jfaults.FAULTS.clear()


@pytest.fixture(scope="module")
def weights():
    jcfg = jconfig.tiny_config(seq_len=SEQ)
    jp = jparams.init_params(jcfg, seed=4)
    tcfg = tconfig.tiny_config(seq_len=SEQ)
    return jcfg, jp, tcfg, tparams.from_jax_params(
        {k: np.asarray(v) for k, v in jp.items()}, tcfg)


def _fields(f):
    return (f.point, f.action, f.arg, f.skip, f.times)


@pytest.mark.parametrize("spec", [
    "engine.device_step=delay:0.5@2x3",
    "server.emit_delta=disconnect@1",
    "server.read_body=raise:TimeoutError",
    "server.read_body=raise:ConnectionError:peer gone",
    "io.read_tensor=corrupt, spec.propose=corrupt x2",
    "engine.numeric=nan@4",
    "kv.spill=raise,sched.host_fanout=delay:0.01x5",
    "pod.respawn=raise:RuntimeError",
    "a.b=nan,,c=delay:1",
    "",
    "engine.device_step",
    "x=explode",
    "x=raise:KeyError",
    "x=delay:1@",
    "=nan",
])
def test_parse_spec_matches_jax(spec):
    """Equal fields on a good spec, the same error class on a bad one."""
    def parse(mod):
        try:
            return [_fields(f) for f in mod.parse_spec(spec)]
        except Exception as e:  # noqa: BLE001 — the class is the result
            return type(e)
    assert parse(faults) == parse(jfaults)


@pytest.mark.parametrize("spec", [
    "p=nan@2x3", "p=corrupt", "p=raise:ValueError@1x2",
    "p=disconnect@3", "p=nan@1x1,p=corrupt@2", "p=nanx1", "p=delay:0@1x2,q=nan",
])
def test_firing_sequence_matches_jax(spec):
    """The same performed actions, hit for hit: the returned transforms
    and the exceptions raised."""
    def run(mod):
        reg = mod.FaultRegistry()
        reg.install(spec)
        seq = []
        for _ in range(8):
            try:
                seq.append(reg.fire("p"))
            except Exception as e:  # noqa: BLE001
                seq.append(type(e).__name__)
        return seq, [(f.hits, f.fired) for f in reg.snapshot()]
    assert run(faults) == run(jfaults)


def test_install_env_and_injected_scope():
    reg = faults.FaultRegistry()
    assert not reg.install_env({})
    assert reg.install_env({"DLLAMA_FAULTS": "a=nan@1"}) and reg.active()
    with faults.injected("b=raise:ValueError") as r:
        with pytest.raises(ValueError):
            r.fire("b")
    assert not faults.FAULTS.active()


# -- the engine's blocking edge and logits guard ---------------------------

def test_device_step_delay_times_out_like_jax(weights):
    """``engine.device_step=delay`` outliving ``step_timeout``: both raise
    StepTimeout naming the position, on the batch-1 forward's sync."""
    jcfg, jp, tcfg, tp = weights
    eng = Engine(tcfg, tp, device="cpu", step_timeout=0.2)
    jeng = JEngine(jcfg, jp, mesh=jmake_mesh(tp=1, devices=jax.devices()[:1]), step_timeout=0.2)
    with faults.injected("engine.device_step=delay:1.5"):
        with pytest.raises(StepTimeout, match="pos=0"):
            eng.prefill([5, 9, 2])
    with jfaults.injected("engine.device_step=delay:1.5"):
        with pytest.raises(JStepTimeout, match="pos=0"):
            jeng.prefill([5, 9, 2])
    # unarmed, the same call lands under the watchdog
    eng.reset()
    assert eng._sync(lambda: 7, "probe")[1] == 7
    assert eng.prefill([5, 9, 2])[0].shape == (1, tcfg.vocab_size)


def test_device_step_nan_and_numeric_guard_like_jax(weights):
    """``engine.device_step=nan`` poisons the fetched logits; under
    ``numeric_checks`` both engines raise NumericFault at the same step
    and position, and ``engine.numeric=nan`` does the same."""
    jcfg, jp, tcfg, tp = weights
    eng = Engine(tcfg, tp, device="cpu", numeric_checks=True)
    jeng = JEngine(jcfg, jp, mesh=jmake_mesh(tp=1, devices=jax.devices()[:1]),
                   numeric_checks=True)
    for point in ("engine.device_step", "engine.numeric"):
        for e, mod, exc in ((eng, faults, NumericFault), (jeng, jfaults, JNumericFault)):
            e.reset()
            with mod.injected(f"{point}=nan"):
                with pytest.raises(exc) as ei:
                    e.prefill([5, 9, 2, 4])
            assert (ei.value.step, ei.value.pos) == ("prefill", 0), point
    # unarmed, the guard passes finite logits
    eng.reset()
    logits, _ = eng.prefill([5, 9, 2, 4])
    assert np.isfinite(logits).all()
    # without numeric_checks the poison reaches the logits unchecked
    plain = Engine(tcfg, tp, device="cpu", numeric_checks=False)
    with faults.injected("engine.device_step=nan"):
        logits, _ = plain.prefill([5, 9, 2, 4])
    assert np.isnan(logits).all()


# -- the scheduler's points -----------------------------------------------

def _paged(weights, kv_pages, batch=2):
    return Engine(weights[2], weights[3], device="cpu", batch=batch, kv_pages=kv_pages,
                  kv_page_size=PAGE)


def _decisions(sched, spilled, paged_in, preempted):
    """tests/test_torch_kvtier.py's harness: the PROMPTS queued at once;
    returns the greedy tokens and the deltas of the three counters."""
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


TIER_KW = dict(prefill_chunk=8, decode_burst=4, max_wait_ms=1e9, preempt_age_ms=0.0,
               overlap=False, kv_reserve="optimistic", spill_headroom=4)


def test_kv_spill_raise_falls_back_to_preemption(weights):
    """Every spill raises: the port abandons it and preempts instead, so
    its tokens and counts equal JAX's scheduler with no host pool (its
    spill-less fallback).  The JAX scheduler under the same fault loses
    its loop (ROADMAP queue 3)."""
    counters = (lambda: obs_metrics.KV_PAGES_SPILLED.value,
                lambda: obs_metrics.KV_PAGES_PAGED_IN.value,
                lambda: obs_metrics.SCHED_PREEMPTIONS.total)
    with faults.injected("kv.spill=raise") as reg:
        port = _decisions(SlotScheduler(_paged(weights, 10), host_pool_mb=8, **TIER_KW),
                          *counters)
        (f,) = reg.snapshot()
    assert f.fired >= 1, "no spill was attempted"
    jcfg, jp = weights[:2]
    jeng = JEngine(jcfg, jp, mesh=jmake_mesh(tp=1, devices=jax.devices()[:1]), batch=2,
                   kv_pages=10, kv_page_size=PAGE)
    ref = _decisions(JScheduler(jeng, host_pool_mb=0, **TIER_KW),
                     lambda: jmetrics.KV_PAGES_SPILLED.value,
                     lambda: jmetrics.KV_PAGES_PAGED_IN.value,
                     lambda: jmetrics.SCHED_PREEMPTIONS.total)
    assert port == ref
    assert port[1][0] == 0 and port[1][2] >= 1


def test_host_fanout_delay_keeps_greedy_tokens(weights):
    """``sched.host_fanout=delay`` widens the host gap after each land;
    the greedy tokens stay the undisturbed run's, overlap on."""
    def run():
        sched = SlotScheduler(_paged(weights, 2 * (SEQ // PAGE) + 1), prefill_chunk=8,
                              overlap=True)
        try:
            ts = [sched.submit(list(p), max_new=MAX_NEW, temperature=0.0) for p in PROMPTS]
            return [list(t.tokens()) for t in ts]
        finally:
            sched.close(timeout=60)
    want = run()
    with faults.injected("sched.host_fanout=delay:0.004") as reg:
        got = run()
        (f,) = reg.snapshot()
    assert got == want and f.fired >= 3


SPEC_PROMPTS = ([5, 9, 2, 5, 9], [7, 3, 11, 4, 6, 1, 8], [2, 4, 6, 2, 4], [9, 8, 7, 6])


def test_spec_propose_corrupt_is_a_reject_storm_like_jax(weights):
    """``spec.propose=corrupt``: adversarial drafts every round; the port
    accepts as many as JAX's scheduler (none) and serves speculation
    off's greedy tokens."""
    jcfg, jp, tcfg, tp = weights

    def serve(sched):
        ts = [sched.submit(list(p), 30, temperature=0.0) for p in SPEC_PROMPTS]
        try:
            return [list(t.tokens()) for t in ts], dict(sched.stats)
        finally:
            sched.close()

    off, _ = serve(SlotScheduler(Engine(tcfg, tp, device="cpu", batch=4), prefill_chunk=4))
    eng = Engine(tcfg, tp, device="cpu", batch=4)
    with faults.injected("spec.propose=corrupt"):
        got, stats = serve(SlotScheduler(eng, prefill_chunk=4, spec_k=3,
                                         spec=tspec.make_proposer("pld", eng)))
    assert got == off
    assert stats["spec_proposed"] > 0 and stats["verify_dispatches"] > 0
    jeng = JEngine(jcfg, jp, batch=4)
    with jfaults.injected("spec.propose=corrupt"):
        jsched = JScheduler(jeng, prefill_chunk=4, spec_k=3,
                            spec=jspec.make_proposer("pld", jeng))
        ts = [jsched.submit(list(p), 30, temperature=0.0) for p in SPEC_PROMPTS]
        want = [list(t.tokens()) for t in ts]
        jaccepted = sum(t.spec_accepted for t in ts)
        jsched.close()
    assert got == want
    assert stats["spec_accepted"] == jaccepted == 0


# -- the server's points, against the JAX server --------------------------

SERVE = ["--temperature", "0", "--buffer-float-type", "f32", "--batch-slots", "2",
         "--kv-pages", "40", "--kv-page-size", "4", "--host", "127.0.0.1", "--port", "0"]


def _jax_server(m, t, numeric_checks=False):
    """The JAX server built in-process as its main() builds it (one CPU
    device)."""
    from dllama_tpu.cli import build_parser, load_stack
    from dllama_tpu.server import api as japi
    args = build_parser().parse_args(["inference", "--model", m, "--tokenizer", t,
                                      "--workers", "tpu:1", *SERVE])
    engine, tok = load_stack(args)
    engine.numeric_checks = numeric_checks
    batch = JEngine(engine.cfg, engine.params, mesh=engine.mesh, batch=2,
                    kv_dtype=engine.cache.k.dtype, kv_pages=40, kv_page_size=4)
    sched = JScheduler(batch, overlap=True)
    state = japi.ApiState(engine, tok, default_temperature=0.0, batch_engine=batch,
                          scheduler=sched)
    return japi.serve(state, host="127.0.0.1", port=0, block=False), sched


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    from dllama_tpu_torch.server import api
    d = tmp_path_factory.mktemp("torch_faults")
    m, t = str(d / "tiny.m"), str(d / "tiny.t")
    write_tiny_model(m, ftype=quants.Q40)
    write_tiny_tokenizer(t)
    port = api.start(["--model", m, "--tokenizer", t, "--device", "cpu", "--numeric-checks",
                      *SERVE])
    ref, ref_sched = _jax_server(m, t, numeric_checks=True)
    yield (f"http://127.0.0.1:{port.server_address[1]}",
           f"http://127.0.0.1:{ref.server_address[1]}", port.state)
    api.stop(port)
    ref.shutdown()
    ref.server_close()
    ref_sched.close()


def post(base, path, body, timeout=120):
    req = urllib.request.Request(base + path, json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _deltas(raw: str) -> int:
    return sum(1 for ln in raw.splitlines() if ln.startswith("data: {"))


@pytest.mark.parametrize("path,body", [
    ("/v1/completions", {"prompt": "hello", "max_tokens": 12, "stream": True}),
    ("/v1/chat/completions", {"messages": [{"role": "user", "content": "hi"}],
                              "max_tokens": 12, "stream": True, "seed": 3,
                              "temperature": 0.7}),
], ids=["completions-sched", "chat-mutex"])
def test_emit_delta_disconnect_matches_jax(servers, path, body):
    """``server.emit_delta=disconnect@1``: the first delta goes out, the
    second write is a dead client; both servers stop there (no
    ``[DONE]``) and keep serving."""
    port, ref, _ = servers
    got = {}
    for name, base, mod in (("port", port, faults), ("jax", ref, jfaults)):
        with mod.injected("server.emit_delta=disconnect@1") as reg:
            status, raw = post(base, path, body)
            (f,) = reg.snapshot()
        assert status == 200 and f.fired == 1, (name, raw)
        assert "[DONE]" not in raw
        got[name] = _deltas(raw)
        assert post(base, "/v1/completions", {"prompt": "hi", "max_tokens": 3})[0] == 200
    assert got["port"] == got["jax"] == 1


def test_read_body_timeout_matches_jax(servers):
    port, ref, state = servers
    before = state.metrics.read_timeouts_408
    codes = []
    for base, mod in ((port, faults), (ref, jfaults)):
        with mod.injected("server.read_body=raise:TimeoutError"):
            codes.append(post(base, "/v1/completions", {"prompt": "hi", "max_tokens": 2})[0])
    assert codes == [408, 408]
    assert state.metrics.read_timeouts_408 == before + 1


def test_numeric_fault_answers_500_then_serves_like_jax(servers):
    """``--numeric-checks`` with ``engine.numeric=nan``: the poisoned
    request (a seeded sampled chat: the batch-1 mutex path, whose logits
    the host fetches) gets a 500, the engine resets, and the next request
    is served — on both servers, with the same statuses."""
    port, ref, state = servers
    body = {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 4,
            "seed": 5, "temperature": 0.7}
    before = obs_metrics.NUMERIC_FAULTS.value
    for base, mod in ((port, faults), (ref, jfaults)):
        with mod.injected("engine.numeric=nan"):
            status, raw = post(base, "/v1/chat/completions", body)
        assert status == 500 and "non-finite logits" in raw, raw
        again = post(base, "/v1/chat/completions", body)
        assert again[0] == 200 and json.loads(again[1])["choices"][0]["message"]["content"]
    assert obs_metrics.NUMERIC_FAULTS.value == before + 1
    assert state.engine.numeric_checks and state.naive_cache.items


def test_step_timeout_marks_the_server_degraded(tmp_path):
    """A device step outliving ``--step-timeout``: the request gets a
    500 and ``/health`` answers 503 ``degraded`` from then on (the
    signal a router ejects on and a supervisor replaces the process
    for)."""
    from dllama_tpu_torch.server import api
    m, t = str(tmp_path / "tiny.m"), str(tmp_path / "tiny.t")
    write_tiny_model(m, ftype=quants.Q40)
    write_tiny_tokenizer(t)
    srv = api.start(["--model", m, "--tokenizer", t, "--device", "cpu", "--step-timeout",
                     "0.3", *SERVE])
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        assert post(base, "/v1/completions", {"prompt": "hi", "max_tokens": 3})[0] == 200
        with urllib.request.urlopen(base + "/health", timeout=10) as r:
            assert json.loads(r.read())["degraded"] is False
        with faults.injected("engine.device_step=delay:1.0x1"):
            status, raw = post(base, "/v1/completions", {"prompt": "hello", "max_tokens": 8})
        assert status == 500 and "did not become ready" in raw, raw
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + "/health", timeout=10)
        assert ei.value.code == 503
        h = json.loads(ei.value.read())
        assert h["status"] == "degraded" and h["degrade_reasons"] == {"step_timeout": 1}
    finally:
        api.stop(srv)
