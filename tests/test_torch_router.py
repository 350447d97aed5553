"""The port's fleet router (dllama_tpu_torch.router: registry, fleet,
service) against the JAX package's, and in front of two in-thread port API
servers on the tiny Q40 fixture (``device="cpu"``, f32, paged pool,
``--handoff``).

* Registry: scores, picks, eligibility, probe/eject/readmit hysteresis and
  RTT degradation equal JAX's on the same canned ``/health`` bodies.
* Federation: ``parse_prometheus``, ``merge_prometheus`` and ``fleet_perf``
  equal JAX's on the same inputs.
* End to end: concurrent dispatch lands on both replicas; greedy text
  through the router equals a direct replica's byte for byte (JSON and
  SSE, completions and chat); a backend that fails before any bytes is
  retried on the other; a stream cut mid-way resumes on the peer with equal
  bytes (tier 2, and tier 1 from a checkpoint) while a sampled one ends
  ``replica_lost``; a draining replica hands its request off and the
  client sees one completion; the stall watchdog cuts a wedged stream; the
  trace id rides the hops; the elastic routes answer 404.
"""

import http.client
import http.server
import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from dllama_tpu import quants
from dllama_tpu.router import fleet as jfleet, registry as jregistry
from dllama_tpu_torch.obs import metrics as obs_metrics
from dllama_tpu_torch.router import fleet, registry, service
from dllama_tpu_torch.runtime import faults
from fixtures import write_tiny_model, write_tiny_tokenizer


def _health(free_slots=2, queue_depth=0, free_kv_pages=50, handoff=True, degraded=False,
            slo="ok", status="ok", effective_free=None, in_flight=0):
    cap = {"free_slots": free_slots, "queue_depth": queue_depth,
           "free_kv_pages": free_kv_pages, "handoff": handoff}
    if effective_free is not None:
        cap["kv_pressure"] = {"effective_free": effective_free}
    return {"status": status, "degraded": degraded, "slo": {"status": slo},
            "capacity": cap}


HEALTHS = [
    _health(), _health(free_slots=0, queue_depth=3), _health(free_slots=5, free_kv_pages=0),
    _health(free_slots=1, effective_free=120), _health(degraded=True, free_slots=8),
    _health(slo="violating", free_slots=8), _health(status="draining", free_slots=9),
    _health(handoff=False, free_slots=3), {"status": "ok"}, {},
]


@pytest.mark.parametrize("i", range(len(HEALTHS)))
@pytest.mark.parametrize("in_flight", [0, 3])
@pytest.mark.parametrize("interactive", [False, True])
def test_score_equals_jax(i, in_flight, interactive):
    scores = []
    for mod in (registry, jregistry):
        b = mod.Backend("127.0.0.1:1")
        b.last_health = HEALTHS[i]
        b.in_flight = in_flight
        scores.append(mod.Registry._score(b, interactive))
    assert scores[0] == scores[1]


@pytest.mark.parametrize("priority", [None, "interactive", "batch"])
def test_pick_and_eligibility_equal_jax(priority):
    """One fleet of every canned health (one ejected, one never probed):
    the same pick order, hand-off peers and snapshot."""
    def fleet_of(mod):
        reg = mod.Registry([f"127.0.0.1:{p}" for p in range(1, len(HEALTHS) + 3)])
        for b, h in zip(reg.backends, HEALTHS):
            b.last_health = h
        reg.backends[len(HEALTHS)].last_health = _health(free_slots=9)
        reg.backends[len(HEALTHS)].ejected = True
        order, tried = [], []
        while (b := reg.pick(exclude=tried, priority=priority)) is not None:
            tried.append(b)
            order.append(b.addr)
        snap = reg.snapshot()
        for row in snap["backends"]:
            row.pop("probe_s")
        return order, [b.addr for b in reg.handoff_peers()], snap
    assert fleet_of(registry) == fleet_of(jregistry)


@pytest.mark.parametrize("floor,last", [(None, None), (0.002, 0.004), (0.002, 0.3),
                                        (0.0001, 0.004), (0.004, 0.045), (0.01, 0.2)])
def test_rtt_degradation_equals_jax(floor, last):
    got = []
    for mod in (registry, jregistry):
        b = mod.Backend("127.0.0.1:1")
        b.last_health = _health(free_slots=8)
        b.rtt_floor, b.last_probe_s = floor, last
        got.append((b.rtt_degraded(), mod.Registry._score(b)))
    assert got[0] == got[1]


class _FakeReplica:
    """In-thread HTTP server answering /health with a settable body, or
    503 when sick."""

    def __init__(self):
        self.payload = _health()
        self.sick = False
        outer = self

        class H(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
                body = json.dumps(outer.payload).encode()
                self.send_response(503 if outer.sick else 200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):  # noqa: N802 — a backend that dies before any bytes
                self.close_connection = True
                self.connection.close()

            def log_message(self, *a):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.addr = f"127.0.0.1:{self.server.server_address[1]}"
        threading.Thread(target=self.server.serve_forever, daemon=True).start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def test_probe_hysteresis_equals_jax():
    """One probe script (healthy, sick, sick, sick, healthy ×3, a forced
    ejection, healthy ×2) through both registries: the same streaks,
    ejections and re-admissions after every step."""
    replica = _FakeReplica()
    script = [False, True, True, True, False, False, False, "force", False, False]
    try:
        runs = []
        for mod in (registry, jregistry):
            reg = mod.Registry([replica.addr], eject_after=2, readmit_after=2,
                               probe_timeout=2.0)
            b = reg.backends[0]
            trace = []
            for step in script:
                if step == "force":
                    reg.force_eject(b, "test")
                    ok = None
                else:
                    replica.sick = step
                    ok = reg.probe(b)
                trace.append((ok, b.ejected, b.ok_streak, b.fail_streak,
                              reg.pick() is b))
            runs.append(trace)
        assert runs[0] == runs[1]
        assert [t[1] for t in runs[0]] == [False, False, True, True, True, False, False,
                                           True, True, False]
    finally:
        replica.close()


REPLICA_TEXT = """\
# HELP dllama_requests_served_total Requests completed successfully.
# TYPE dllama_requests_served_total counter
dllama_requests_served_total 7
# HELP dllama_ttft_seconds TTFT.
# TYPE dllama_ttft_seconds histogram
dllama_ttft_seconds_bucket{le="0.1"} 3
dllama_ttft_seconds_bucket{le="+Inf"} 7
dllama_ttft_seconds_sum 1.5
dllama_ttft_seconds_count 7
dllama_matmul_dispatch_total{codec="q40",path="gemv"} 12
"""

ROUTER_TEXT = """\
# HELP dllama_fleet_replica_up Reachability.
# TYPE dllama_fleet_replica_up gauge
dllama_fleet_replica_up{replica="127.0.0.1:9"} 1
dllama_requests_served_total 1
lonely_metric 3
"""


def test_federation_helpers_equal_jax():
    pairs = [("router", ROUTER_TEXT), ("127.0.0.1:9", REPLICA_TEXT),
             ('we"ird\\addr', REPLICA_TEXT)]
    assert fleet.parse_prometheus(REPLICA_TEXT) == jfleet.parse_prometheus(REPLICA_TEXT)
    assert fleet.merge_prometheus(pairs) == jfleet.merge_prometheus(pairs)
    replicas = {
        "a": {"metrics": {"mfu": 0.2, "mbu": 0.5,
                          "class_chip_ms": {"standard": 12.5, "batch": 3.0}}},
        "b": {"metrics": {"mfu": 0.0, "mbu": 0.7, "class_chip_ms": {"interactive": 1.0}}},
        "c": {"metrics": {}}, "d": {},
    }
    assert fleet.fleet_perf(replicas) == jfleet.fleet_perf(replicas)
    assert fleet.fleet_perf({}) == jfleet.fleet_perf({})


# -- end to end, in front of the port's servers ----------------------------

SERVE = ["--temperature", "0", "--buffer-float-type", "f32", "--batch-slots", "2",
         "--kv-pages", "40", "--kv-page-size", "4", "--host", "127.0.0.1", "--port", "0",
         "--handoff"]


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_router")
    m, t = str(d / "tiny.m"), str(d / "tiny.t")
    write_tiny_model(m, ftype=quants.Q40)
    write_tiny_tokenizer(t)
    return m, t


def _start_replicas(model, n=2):
    from dllama_tpu_torch.server import api
    m, t = model
    return [api.start(["--model", m, "--tokenizer", t, "--device", "cpu", *SERVE])
            for _ in range(n)]


def _addr(server):
    return f"127.0.0.1:{server.server_address[1]}"


def _router(addrs, **kw):
    reg = registry.Registry(addrs, probe_interval=0.2, eject_after=2, readmit_after=1,
                            probe_timeout=2.0)
    state = service.RouterState(reg, upstream_timeout=60.0, **kw)
    httpd = service.serve(state, host="127.0.0.1", port=0, block=False)
    return state, httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def fleet_of_two(model):
    from dllama_tpu_torch.server import api
    servers = _start_replicas(model)
    state, httpd, base = _router([_addr(s) for s in servers])
    yield servers, state, base
    service.stop(httpd)
    for s in servers:
        api.stop(s)


def post(base, path, body, headers=None, timeout=120):
    req = urllib.request.Request(base + path, json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json",
                                          **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read().decode(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(), dict(e.headers)


def text_of(body: dict, raw: str) -> tuple[str, str | None]:
    """The completion's text and its finish reason, JSON or SSE."""
    if body.get("stream"):
        text, finish = "", None
        for ln in raw.splitlines():
            if not ln.startswith("data: {"):
                continue
            c = json.loads(ln[6:])["choices"][0]
            text += c.get("text") or (c.get("delta") or {}).get("content") or ""
            finish = c.get("finish_reason") or finish
        assert raw.rstrip().endswith("data: [DONE]"), raw[-200:]
        return text, finish
    c = json.loads(raw)["choices"][0]
    return c.get("text", (c.get("message") or {}).get("content")), c["finish_reason"]


CHAT = [{"role": "system", "content": "Be terse."}, {"role": "user", "content": "2+2?"}]


@pytest.mark.parametrize("path,body", [
    ("/v1/completions", {"prompt": "hello", "max_tokens": 16}),
    ("/v1/completions", {"prompt": "hello hi", "max_tokens": 16, "stream": True}),
    ("/v1/chat/completions", {"messages": CHAT, "max_tokens": 10}),
    ("/v1/chat/completions", {"messages": CHAT, "max_tokens": 10, "stream": True}),
], ids=["completions", "completions-sse", "chat", "chat-sse"])
def test_greedy_bytes_equal_a_direct_replica(fleet_of_two, path, body):
    servers, _, base = fleet_of_two
    body = dict(body, temperature=0)
    via, direct = post(base, path, body), post(f"http://{_addr(servers[1])}", path, body)
    assert via[0] == direct[0] == 200, (via, direct)
    assert text_of(body, via[1]) == text_of(body, direct[1])
    assert text_of(body, via[1])[0]


def test_concurrent_dispatch_is_balanced(fleet_of_two):
    servers, _, base = fleet_of_two
    addrs = [_addr(s) for s in servers]
    before = [obs_metrics.ROUTER_DISPATCH.get(a) for a in addrs]
    results = []
    body = {"prompt": "hello", "max_tokens": 8, "temperature": 0}

    def one():
        results.append(post(base, "/v1/completions", body))

    with faults.injected("engine.device_step=delay:0.02"):
        threads = [threading.Thread(target=one) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    assert len(results) == 8 and all(r[0] == 200 for r in results)
    assert len({text_of(body, r[1]) for r in results}) == 1
    got = [obs_metrics.ROUTER_DISPATCH.get(a) - b for a, b in zip(addrs, before)]
    assert sum(got) == 8 and min(got) >= 2, got


def test_trace_id_rides_the_hops_and_elastic_routes_404(fleet_of_two):
    _, _, base = fleet_of_two
    status, _, headers = post(base, "/v1/completions",
                              {"prompt": "hi", "max_tokens": 3, "temperature": 0},
                              headers={"X-Dllama-Trace": "trace-abc.1"})
    assert status == 200 and headers.get("X-Dllama-Trace") == "trace-abc.1"
    spans = json.loads(urllib.request.urlopen(base + "/debug/trace?scope=fleet",
                                              timeout=30).read())
    assert any((e.get("args") or {}).get("trace_id") == "trace-abc.1"
               for e in spans["traceEvents"])
    for path in ("/admin/scale?n=3", "/admin/reshape?tp=2"):
        status, raw, _ = post(base, path, {})
        assert status == 404 and "elastic" in raw


def test_failure_before_bytes_is_retried(model, fleet_of_two):
    """A backend that scores best but drops the POST before answering:
    the router retries on a real replica, and the client sees nothing of
    it."""
    servers, _, _ = fleet_of_two
    fake = _FakeReplica()
    fake.payload = _health(free_slots=50)
    state, httpd, base = _router([fake.addr, _addr(servers[0])])
    try:
        before = obs_metrics.ROUTER_RETRIES.value
        body = {"prompt": "hello", "max_tokens": 8, "temperature": 0}
        status, raw, _ = post(base, "/v1/completions", body)
        assert status == 200
        assert text_of(body, raw) == text_of(body, post(f"http://{_addr(servers[0])}",
                                                        "/v1/completions", body)[1])
        assert obs_metrics.ROUTER_RETRIES.value == before + 1
    finally:
        service.stop(httpd)
        fake.close()


class _CutProxy:
    """A replica's stand-in that relays every request to a real server and
    scores best; armed, it cuts a streamed answer after ``after`` events
    (the socket closes mid-stream, no finish) and answers 503 from then
    on: a replica that died with bytes sent."""

    def __init__(self, target: str, after: int = 3):
        self.target = target
        self.after = after
        self.armed = True
        self.dead = False
        outer = self

        class H(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _upstream(self, method, body=None):
                host, port = outer.target.split(":")
                conn = http.client.HTTPConnection(host, int(port), timeout=60)
                hdrs = {k: v for k, v in self.headers.items()
                        if k.lower() not in ("host", "content-length")}
                conn.request(method, self.path, body, headers=hdrs)
                return conn, conn.getresponse()

            def _dead(self):
                self.send_response(503)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def do_GET(self):  # noqa: N802
                if outer.dead:
                    return self._dead()
                conn, resp = self._upstream("GET")
                data = resp.read()
                if self.path.startswith("/health") and resp.status == 200:
                    h = json.loads(data)
                    h["capacity"]["free_slots"] += 10
                    data = json.dumps(h).encode()
                self.send_response(resp.status)
                self.send_header("Content-Type", resp.getheader("Content-Type") or "")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                conn.close()

            def do_POST(self):  # noqa: N802
                if outer.dead:
                    return self._dead()
                body = self.rfile.read(int(self.headers.get("Content-Length") or 0))
                conn, resp = self._upstream("POST", body)
                self.send_response(resp.status)
                for k in ("Content-Type", "X-Request-Id", "X-Dllama-Trace"):
                    if resp.getheader(k):
                        self.send_header(k, resp.getheader(k))
                if resp.getheader("Content-Type", "").startswith("text/event-stream"):
                    self.send_header("Connection", "close")
                    self.end_headers()
                    events = 0
                    while line := resp.readline():
                        self.wfile.write(line)
                        self.wfile.flush()
                        events += line.startswith(b"data: {")
                        if outer.armed and events >= outer.after:
                            outer.dead = True
                            break
                    self.close_connection = True
                else:
                    data = resp.read()
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                conn.close()

            def log_message(self, *a):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.addr = f"127.0.0.1:{self.server.server_address[1]}"
        threading.Thread(target=self.server.serve_forever, daemon=True).start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


@pytest.mark.parametrize("tier", ["rerun", "checkpoint"])
def test_mid_stream_loss_resumes_greedy_and_loses_sampled(fleet_of_two, tier):
    """A replica dies with three deltas sent: the greedy stream resumes on
    the peer with the undisturbed bytes (tier 2 re-runs and verifies the
    prefix; with checkpoints, tier 1 imports the latest record); a sampled
    stream ends ``replica_lost``."""
    servers, _, _ = fleet_of_two
    peer = f"http://{_addr(servers[1])}"
    proxy = _CutProxy(_addr(servers[0]))
    kw = {"checkpoint_interval": 0.05} if tier == "checkpoint" else {}
    state, httpd, base = _router([proxy.addr, _addr(servers[1])], **kw)
    try:
        body = {"prompt": "hello", "max_tokens": 24, "temperature": 0, "stream": True}
        want = text_of(body, post(peer, "/v1/completions", body)[1])
        resumes = obs_metrics.ROUTER_RESUMES.get(tier)
        # slow decode so a checkpoint lands before the cut
        with faults.injected("engine.device_step=delay:0.03"):
            status, raw, _ = post(base, "/v1/completions", body)
        assert status == 200 and proxy.dead
        assert text_of(body, raw) == want
        assert obs_metrics.ROUTER_RESUMES.get(tier) == resumes + 1
        # the sampled stream: no resume, the truncation is flagged
        proxy.dead = False
        lost = obs_metrics.ROUTER_REPLICA_LOST.value
        deadline = time.monotonic() + 10
        while state.registry.backends[0].ejected and time.monotonic() < deadline:
            time.sleep(0.05)  # re-admitted after its next healthy probe
        sampled = dict(body, temperature=0.8)
        status, raw, _ = post(base, "/v1/completions", sampled)
        assert status == 200 and proxy.dead
        assert text_of(sampled, raw)[1] == "replica_lost"
        assert obs_metrics.ROUTER_REPLICA_LOST.value == lost + 1
    finally:
        service.stop(httpd)
        proxy.close()


def test_drain_hands_the_request_off(model):
    """SIGTERM's drain on the replica serving a greedy stream: it exports
    the request (DLREQ01), the router imports it on the peer and splices
    the continuation; the client sees one completion equal to the
    undisturbed run, and ``router_handoffs`` moves."""
    from dllama_tpu_torch.server import api
    servers = _start_replicas(model)
    state, httpd, base = _router([_addr(s) for s in servers])
    try:
        body = {"prompt": "hello hi", "max_tokens": 40, "temperature": 0, "stream": True}
        want = text_of(body, post(f"http://{_addr(servers[1])}", "/v1/completions", body)[1])
        handoffs = obs_metrics.ROUTER_HANDOFFS.value
        out = {}
        with faults.injected("engine.device_step=delay:0.03"):
            t = threading.Thread(target=lambda: out.update(
                r=post(base, "/v1/completions", body)))
            t.start()
            victim = None
            deadline = time.monotonic() + 30
            while victim is None and time.monotonic() < deadline:
                for s in servers:
                    occ = s.state.scheduler.occupancy()
                    if occ["active"] and s.state.scheduler.slots[0].ticket is not None \
                            and s.state.scheduler.slots[0].ticket.emitted:
                        victim = s
                time.sleep(0.01)
            assert victim is not None, "the stream never started"
            victim.state.begin_drain()
            t.join(120)
        status, raw, _ = out["r"]
        assert status == 200
        assert text_of(body, raw) == want
        assert obs_metrics.ROUTER_HANDOFFS.value == handoffs + 1
        assert raw.count("data: [DONE]") == 1
    finally:
        service.stop(httpd)
        for s in servers:
            api.stop(s)


class _StallingReplica:
    """Answers /health, streams one SSE chunk, then goes silent with the
    socket open (tests/test_router.py's wedged replica)."""

    def __init__(self, hold_s: float = 8.0):
        class H(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                body = json.dumps(_health()).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):  # noqa: N802
                self.rfile.read(int(self.headers.get("Content-Length") or 0))
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.end_headers()
                evt = {"id": "cmpl-stall", "model": "tiny", "created": 0,
                       "choices": [{"index": 0, "text": "Hello", "finish_reason": None}]}
                self.wfile.write(b"data: " + json.dumps(evt).encode() + b"\n\n")
                self.wfile.flush()
                time.sleep(hold_s)

            def log_message(self, *a):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), H)
        self.addr = f"127.0.0.1:{self.server.server_address[1]}"
        threading.Thread(target=self.server.serve_forever, daemon=True).start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def test_stall_watchdog_cuts_a_wedged_stream():
    replica = _StallingReplica()
    state, httpd, base = _router([replica.addr], stall_timeout=1.0, resume_window=0.0)
    try:
        stalls = obs_metrics.ROUTER_STALLS.value
        body = {"prompt": "hi", "max_tokens": 8, "stream": True, "temperature": 0}
        t0 = time.monotonic()
        status, raw, _ = post(base, "/v1/completions", body, timeout=30)
        assert status == 200 and time.monotonic() - t0 < 6.0
        assert text_of(body, raw) == ("Hello", "replica_lost")
        assert obs_metrics.ROUTER_STALLS.value == stalls + 1
        assert state.registry.backends[0].ejected
    finally:
        service.stop(httpd)
        replica.close()
