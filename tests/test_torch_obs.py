"""The port's observability package (``dllama_tpu_torch/obs``, trimmed
copies of ``dllama_tpu/obs``) against the JAX package's: the registry's
families, the Prometheus exposition, structured logs with the request
id, the trace, event and flight rings, the SLO grammar, and the
dispatch ledger read from the kernels' launch counters.  Everything here
is host-side and exact: no tolerance applies.
"""

import io
import json
import re
import threading

import pytest

from dllama_tpu.obs import events as jevents, flight as jflight, log as jlog, \
    metrics as jmetrics, slo as jslo, trace as jtrace
from dllama_tpu_torch.obs import dispatch as tdispatch, events as tevents, \
    flight as tflight, log as tlog, metrics as tmetrics, slo as tslo, trace as ttrace
from dllama_tpu_torch.ops import q8 as tq8, q40 as tq40

_SAMPLE = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{([a-zA-Z_]+="[^"]*",?)*\})? '
                     r'(-?[0-9.]+(e[-+]?[0-9]+)?|\+Inf)$')


def test_families_are_a_subset_of_the_jax_registry():
    """Every family the port registers exists in the JAX registry under the
    same JSON key and Prometheus name, with the same type, help, labels
    and bucket bounds."""
    theirs = {m.json_key: m for m in jmetrics.REGISTRY.metrics()}
    ours = tmetrics.REGISTRY.metrics()
    assert len(ours) >= 40
    for m in ours:
        j = theirs[m.json_key]
        assert (type(m).__name__, m.name, m.kind, m.help) == \
            (type(j).__name__, j.name, j.kind, j.help), m.json_key
        assert getattr(m, "labels", None) == getattr(j, "labels", None)
        assert getattr(m, "uppers", None) == getattr(j, "uppers", None)
    assert tmetrics.SCHEMA_VERSION == jmetrics.SCHEMA_VERSION


def test_prometheus_text_parses_and_matches_jax_rendering():
    """Text 0.0.4: HELP and TYPE lines, then samples; a fresh registry with
    the same observations renders the same text in both packages."""
    texts = []
    for mod in (tmetrics, jmetrics):
        reg = mod.Registry()
        c = reg.counter("requests_served", "Requests completed successfully.")
        h = reg.histogram("ttft_seconds", mod.TTFT_BUCKETS, "TTFT.")
        lc = reg.labeled_counter("matmul_dispatch", ("codec", "path"), "Dispatches.")
        g = reg.labeled_gauge("hbm_bytes_in_use", "device", "HBM.", fn=lambda: {"0": 5.0})
        c.inc(3)
        for v in (0.004, 0.3, 7.0, 100.0):
            h.observe(v)
        lc.inc("q40", "mma", n=7)
        assert g.values() == {"0": 5.0}
        texts.append(re.sub(r"dllama_uptime_seconds \S+", "", reg.render_prometheus()))
        snap = reg.snapshot_json()
        assert snap["ttft_seconds"]["count"] == 4 and snap["requests_served"] == 3
    assert texts[0] == texts[1]
    full = tmetrics.render_prometheus()
    for ln in full.splitlines():
        assert ln.startswith(("# HELP ", "# TYPE ")) or _SAMPLE.match(ln), ln
    assert "# TYPE dllama_ttft_seconds histogram" in full


def test_json_logs_carry_the_request_id():
    """A record logged on a thread whose contextvar holds a request id
    carries it, in the JAX package's JSON shape."""
    lines = []
    for mod, name in ((tlog, "server.api"), (jlog, "server.api")):
        buf = io.StringIO()
        mod.configure("json", "info", stream=buf, force=True)

        def work(mod=mod, name=name):
            mod.set_request_id("rid-42")
            mod.get_logger(name).info("finish", extra={"path": "/v1/completions"})

        th = threading.Thread(target=work)
        th.start()
        th.join(10)
        assert not th.is_alive()
        rec = json.loads(buf.getvalue().splitlines()[-1])
        assert rec["request_id"] == "rid-42" and rec["path"] == "/v1/completions"
        lines.append({k: v for k, v in rec.items() if k not in ("ts", "logger")})
    assert lines[0] == lines[1]
    assert tlog.get_logger("x").name == "dllama_tpu_torch.x"
    tlog.configure("human", "info", force=True)


def _drive_trace(mod):
    tr = mod.Tracer(capacity=8)
    tr.record("request", 1.0, 1.5, rid="a", path="/v1/completions")
    tr.record("sched_step", 1.1, 1.2, rid=None, active=2)
    tr.record("emit", 1.3, 1.31, rid="b")
    tr.resize(2)
    return tr


def test_trace_ring_exports_as_jax():
    ours, theirs = _drive_trace(ttrace), _drive_trace(jtrace)
    assert ours.trace_json(1) == theirs.trace_json(1)
    assert ours.trace_json() == theirs.trace_json()
    a, b = ours.raw(since=1), theirs.raw(since=1)
    assert [s["seq"] for s in a["spans"]] == [s["seq"] for s in b["spans"]] == [2, 3]
    assert a["next_seq"] == b["next_seq"] == 3 and a["capacity"] == b["capacity"] == 2
    assert [{k: s[k] for k in ("name", "ts", "dur", "rid", "args")} for s in a["spans"]] == \
        [{k: s[k] for k in ("name", "ts", "dur", "rid", "args")} for s in b["spans"]]


def test_event_journal_exports_as_jax(tmp_path):
    snaps = []
    for mod, name in ((tevents, "t"), (jevents, "j")):
        jr = mod.EventJournal(capacity=3)
        path = tmp_path / f"{name}.jsonl"
        jr.set_log_path(str(path))
        for i in range(4):
            jr.emit("resume", rid=f"r{i}", slot=i, trace=None)
        jr.set_log_path(None)
        snap = jr.snapshot(since=2)
        for e in snap["events"]:
            e.pop("ts")
        snaps.append(snap)
        assert len(path.read_text().splitlines()) == 4
    assert snaps[0] == snaps[1]
    assert snaps[0]["next_seq"] == 4 and snaps[0]["oldest_seq"] == 2


def _drive_flight(mod):
    fr = mod.FlightRecorder(capacity=2)
    fr.submit("a", path="/v1/completions")
    fr.submit("a", n_prompt=5, path="ignored")
    fr.admit("a", slot=1, queued_ms=2.5)
    fr.phase("a", "prefill_chunk", tokens=5, ms=1.25, pos=0, emitted=1)
    fr.first_token("a", 0.5)
    fr.inter_token("a", 0.25)
    fr.inter_token("a", 0.75)
    fr.retire("a", "stop", produced=3)
    fr.retire("a", "served")  # the first specific reason wins
    fr.submit("b")
    fr.submit("c")  # evicts a
    return fr


def test_flight_ring_exports_as_jax():
    ours, theirs = _drive_flight(tflight), _drive_flight(jflight)
    # clocks, and JAX's degrade fields (the port has no degrade path)
    clock = ("submitted_at", "admitted_at", "ended_at", "duration_ms", "degraded",
             "degrade_events")
    assert ours.get("b") is not None and "degraded" not in ours.get("b")

    def strip(rec):
        return None if rec is None else {k: v for k, v in rec.items() if k not in clock}

    assert ours.get("a") is None is theirs.get("a")
    assert strip(ours.get("b")) == strip(theirs.get("b"))
    assert [strip(r) for r in ours.recent(5)] == [strip(r) for r in theirs.recent(5)]
    one, two = tflight.FlightRecorder(capacity=4), jflight.FlightRecorder(capacity=4)
    for fr in (one, two):
        fr.submit("x", path="/v1/chat/completions")
        fr.phase("x", "decode_burst", steps=4, tokens=4, wall_ms=8.0, step_ms=2.0)
        fr.first_token("x", 0.1)
        fr.inter_token("x", 0.2)
        fr.retire("x", "length", produced=4)
    assert strip(one.get("x")) == strip(two.get("x"))
    assert "degraded" not in one.get("x") and "degrade_events" not in one.get("x")
    tl = tflight.SlotTimeline(capacity=2)
    jl = jflight.SlotTimeline(capacity=2)
    for t in (tl, jl):
        for i in range(3):
            t.record_step(ts=float(i), wall_ms=1.5, device_ms=1.0, host_gap_ms=0.25,
                          steps=2, slots=[{"slot": 0, "phase": "decode", "tokens": 2}])
    assert [{k: v for k, v in e.items() if k != "t"} for e in tl.snapshot()] == \
        [{k: v for k, v in e.items() if k != "t"} for e in jl.snapshot()]


@pytest.mark.parametrize("spec", [
    "ttft_p95=1500ms,itl_p99=120ms,error_rate=0.5%",
    "queue_wait_p50=0.2s,duration_p90=30,step_p99=25ms",
    "error_rate=0.01",
])
def test_slo_parses_the_same_objectives(spec):
    def view(objs):
        return [(o.key, o.kind, o.allowed, o.target_display, o.threshold, o.boundary,
                 None if o.hist is None else o.hist.json_key) for o in objs]

    assert view(tslo.parse_slo(spec)) == view(jslo.parse_slo(spec))
    assert tslo.parse_windows("30s,5m,1h") == jslo.parse_windows("30s,5m,1h")
    eng = tslo.SloEngine.from_spec(spec, "3s,12s")
    res = eng.evaluate(now=100.0)
    assert res["status"] in ("ok", "at_risk", "violating")
    assert set(res["objectives"]) == {o.key for o in eng.objectives}
    assert eng.summary_line().startswith("slo: ")


@pytest.mark.parametrize("spec", ["", "ttft=1s", "bogus_p95=1s", "ttft_p95=-1ms",
                                  "error_rate=200%", "ttft_p95=1s,ttft_p95=2s"])
def test_slo_refuses_what_jax_refuses(spec):
    with pytest.raises(ValueError) as ours:
        tslo.parse_slo(spec)
    with pytest.raises(ValueError) as theirs:
        jslo.parse_slo(spec)
    assert str(ours.value) == str(theirs.value)


def test_dispatch_ledger_reads_the_launch_counters():
    """matmul_dispatch{codec, path} follows the kernels' counters, by body,
    and only grows across a counter reset."""
    tq40.reset_counters()
    tq8.reset_counters()
    tdispatch.sync()
    base = dict(tmetrics.MATMUL_DISPATCH.json_value())
    tq40.launches_by_shape.update({(64, 128): 5, ("mma", 64, 128): 2,
                                   ("blocked", 64, 32): 1, ("blocked-mma", 64, 32): 4})
    tq40.plain_calls = 3
    tq8.launches_by_shape.update({("mma", 64, 128): 6})
    tdispatch.sync()
    got = tmetrics.MATMUL_DISPATCH.json_value()
    want = {"q40/gemv": 5, "q40/mma": 2, "q40/blocked-gemv": 1, "q40/blocked-mma": 4,
            "q40/plain": 3, "q8/mma": 6}
    for k, v in want.items():
        assert got[k] - base.get(k, 0) == v, k
    tq40.reset_counters()
    tq40.launches_by_shape[(64, 128)] = 2  # after a reset: counted anew
    tdispatch.sync()
    assert tmetrics.MATMUL_DISPATCH.json_value()["q40/gemv"] - base.get("q40/gemv", 0) == 7
    tq40.reset_counters()
    tq8.reset_counters()
    tdispatch.sync()
    assert tdispatch.launches() == {}
