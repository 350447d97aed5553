"""The port's hand-off routes and snapshots through its API server
(server.api ``/admin/export/<rid>``, ``/admin/checkpoint/<rid>``, ``POST
/admin/import``, ``--handoff``, ``--handoff-ttl``, ``--snapshot-dir``), in
process on the CPU with the tiny Q40 fixture, greedy:

* a streamed completion on server A, drained after its first chunks, is
  fetched once from A (a second fetch is 404) and imported into B with
  ``emitted_chars``: the joined text equals the undisturbed run's, byte for
  byte; ``/admin/checkpoint`` copies a live request without stopping it;
  a record of another geometry answers 409, a corrupt one 400, and the
  routes answer 404 without ``--handoff``; an unclaimed record expires
  after ``--handoff-ttl``;
* drain → snapshot → warm boot: the booted server reuses the cached prompt
  prefix and answers the cold server's text; a corrupt snapshot
  cold-starts;
* servers over one loaded stack (``api.start(stack=)``, as several servers
  of one process share a model): each builds its engines through the
  CLI's loader over the stack's weights, with caches of its own sized by
  its own flags, and answers the file-loaded server's text;
* the hand-off and snapshot families in both /metrics formats.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import pytest

from dllama_tpu import quants
from dllama_tpu_torch import cli
from dllama_tpu_torch.obs import metrics as obs_metrics
from dllama_tpu_torch.runtime import snapshot as snapfmt
from dllama_tpu_torch.server import api
from fixtures import write_tiny_model, write_tiny_tokenizer

BASE = ["--device", "cpu", "--host", "127.0.0.1", "--port", "0", "--temperature", "0",
        "--buffer-float-type", "f32", "--batch-slots", "2", "--kv-pages", "40",
        "--kv-page-size", "4"]
PROMPT = {"prompt": "hello there, how are you", "max_tokens": 24, "stream": True}
CHAT = {"messages": [{"role": "system", "content": "You are terse and kind."},
                     {"role": "user", "content": "hello"}], "max_tokens": 12}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_admin")
    m, t = str(d / "tiny.m"), str(d / "tiny.t")
    write_tiny_model(m, ftype=quants.Q40)
    write_tiny_tokenizer(t)
    return ["--model", m, "--tokenizer", t]


@pytest.fixture
def servers(files):
    started = []

    def start(*extra):
        srv = api.start([*files, *BASE, *extra])
        started.append(srv)
        return srv, f"http://127.0.0.1:{srv.server_address[1]}"

    yield start
    for srv in started:
        api.stop(srv)


def request(base, path, body=None, data=None, headers=None):
    """(status, headers, raw bytes)."""
    if body is not None:
        data = json.dumps(body).encode()
    req = urllib.request.Request(base + path, data, headers={
        "Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def sse(raw: bytes) -> tuple[str, list]:
    """The joined text and the finish reasons of an SSE answer."""
    text, fins = "", []
    for line in raw.decode().splitlines():
        if line.startswith("data: {"):
            obj = json.loads(line[6:])
            for ch in obj.get("choices", []):
                text += ch.get("text") or ""
                if ch.get("finish_reason"):
                    fins.append(ch["finish_reason"])
    return text, fins


def slow(srv, s=0.05):
    eng = srv.state.scheduler.engine
    step = eng.slot_step_async

    def f(*a, **k):
        time.sleep(s)
        return step(*a, **k)
    eng.slot_step_async = f


def stream_then_drain(srv, base, rid, chunks=1):
    """Stream PROMPT on ``srv`` under X-Request-Id ``rid``; after ``chunks``
    text chunks (the first: the prefill's token, before the first decode
    burst lands), drain ``srv`` (with --handoff: export).  Returns the text
    the client got and its finish reasons."""
    req = urllib.request.Request(base + "/v1/completions", json.dumps(PROMPT).encode(),
                                 headers={"Content-Type": "application/json",
                                          "X-Request-Id": rid})
    text, fins, n = "", [], 0
    with urllib.request.urlopen(req, timeout=120) as r:
        for line in r:
            line = line.decode().strip()
            if not line.startswith("data: {"):
                continue
            ch = json.loads(line[6:])["choices"][0]
            text += ch["text"]
            n += bool(ch["text"])
            if ch["finish_reason"]:
                fins.append(ch["finish_reason"])
            if n == chunks and not srv.state.draining:
                threading.Thread(target=srv.state.begin_drain).start()
    return text, fins


def test_drain_export_import_joins_byte_for_byte(servers):
    """Drain A mid-stream, fetch the record once, import it into B past
    the characters the client already has: the joined text is the
    undisturbed run's."""
    a, base_a = servers("--handoff")
    b, base_b = servers("--handoff")
    code, _, raw = request(base_b, "/v1/completions", PROMPT)
    assert code == 200
    want, _ = sse(raw)
    slow(a, 0.3)
    got, fins = stream_then_drain(a, base_a, "handoff-req-1")
    assert fins == ["handoff"] and want.startswith(got) and got != want
    code, hdr, rec = request(base_a, "/admin/export/handoff-req-1")
    assert code == 200 and hdr["Content-Type"] == "application/octet-stream"
    assert request(base_a, "/admin/export/handoff-req-1")[0] == 404
    prefilled = b.state.scheduler.stats["prefill_tokens"]
    code, _, raw = request(base_b, f"/admin/import?emitted_chars={len(got)}", data=rec,
                           headers={"Content-Type": "application/octet-stream"})
    assert code == 200
    rest, fins = sse(raw)
    assert got + rest == want and fins == ["length"]
    usage = [json.loads(x[6:]) for x in raw.decode().splitlines()
             if x.startswith("data: {") and "handoff.usage" in x]
    assert usage[0]["usage"]["completion_tokens"] == 24
    assert b.state.scheduler.stats["imported"] == 1
    # the import resumed the clocks: nothing was prefilled again
    assert b.state.scheduler.stats["prefill_tokens"] == prefilled


def test_checkpoint_copies_a_live_request(servers):
    a, base_a = servers("--handoff")
    b, base_b = servers("--handoff")
    slow(a, 0.1)
    box = {}

    def run():
        box["ans"] = request(base_a, "/v1/completions", dict(PROMPT, stream=False),
                             headers={"X-Request-Id": "ckpt-1"})
    th = threading.Thread(target=run)
    th.start()
    deadline = time.monotonic() + 60
    done = 0
    while not 0 < done < 24:  # a copy of the request mid-decode
        assert time.monotonic() < deadline and th.is_alive()
        code, _, rec = request(base_a, "/admin/checkpoint/ckpt-1")
        if code == 200:
            done = len(snapfmt.loads_request(rec)[0]["extra"]["completion"])
        time.sleep(0.02)
    assert request(base_a, "/admin/checkpoint/nobody")[0] == 404
    th.join(120)
    full = json.loads(box["ans"][2])["choices"][0]
    assert full["finish_reason"] == "length"
    code, _, raw = request(base_b, "/admin/import?emitted_chars=0", data=rec)
    assert code == 200 and sse(raw)[0] == full["text"]


def test_import_refusals_and_disabled_routes(servers):
    a, base_a = servers("--handoff")
    q, base_q = servers("--handoff", "--kv-quant", "int8")
    plain, base_p = servers()
    slow(q, 0.3)
    stream_then_drain(q, base_q, "int8-req")
    code, _, rec = request(base_q, "/admin/export/int8-req")
    assert code == 200
    rejects0 = obs_metrics.HANDOFF_IMPORT_REJECTS.value
    code, _, raw = request(base_a, "/admin/import", data=rec)
    assert code == 409 and b"geometry" in raw
    bad = bytearray(rec)
    bad[40] ^= 0xFF
    assert request(base_a, "/admin/import", data=bytes(bad))[0] == 400
    assert request(base_a, "/admin/import", data=b"")[0] == 400
    assert obs_metrics.HANDOFF_IMPORT_REJECTS.value - rejects0 == 2
    for path, data in (("/admin/import", rec), ("/admin/checkpoint/x", None)):
        code, _, raw = request(base_p, path, data=data)
        assert code == 404 and b"--handoff" in raw
    assert request(base_p, "/admin/export/x")[0] == 404


def test_unclaimed_record_expires(servers):
    a, base_a = servers("--handoff", "--handoff-ttl", "0.05")
    slow(a, 0.3)
    expired0 = obs_metrics.HANDOFF_EXPIRED.value
    stream_then_drain(a, base_a, "ttl-req")
    time.sleep(0.2)
    assert request(base_a, "/admin/export/ttl-req")[0] == 404
    assert obs_metrics.HANDOFF_EXPIRED.value - expired0 == 1


def test_drain_snapshot_warm_boot(files, tmp_path):
    """A drained server saves its state; the next boot restores the pool
    and radix tree: the same chat reuses the cached prompt pages and
    answers the cold server's text byte for byte.  The files are one-shot,
    and a corrupt one cold-starts."""
    snap = ["--snapshot-dir", str(tmp_path / "snaps")]
    cold = api.start([*files, *BASE, *snap])
    try:
        base = f"http://127.0.0.1:{cold.server_address[1]}"
        code, _, raw = request(base, "/v1/chat/completions", CHAT)
        assert code == 200
        want = json.loads(raw)["choices"][0]["message"]["content"]
        assert cold.state.scheduler.occupancy()["prefix_nodes"] > 0
        cold.state.begin_drain()
    finally:
        api.stop(cold)
    files_ = sorted(os.listdir(tmp_path / "snaps"))
    assert files_ == ["engine.snap", "scheduler.snap"]
    restores0 = obs_metrics.SNAPSHOT_RESTORES.value
    warm = api.start([*files, *BASE, *snap])
    try:
        assert obs_metrics.SNAPSHOT_RESTORES.value - restores0 == 2
        assert os.listdir(tmp_path / "snaps") == []
        sched = warm.state.scheduler
        assert sched.occupancy()["prefix_nodes"] > 0
        base = f"http://127.0.0.1:{warm.server_address[1]}"
        code, _, raw = request(base, "/v1/chat/completions", CHAT)
        assert code == 200
        assert json.loads(raw)["choices"][0]["message"]["content"] == want
        assert sched.stats["prefix_tokens_reused"] > 0
        warm.state.begin_drain()
    finally:
        api.stop(warm)
    with open(tmp_path / "snaps" / "scheduler.snap", "r+b") as f:
        f.seek(30)
        byte = f.read(1)
        f.seek(30)
        f.write(bytes([byte[0] ^ 0xFF]))
    again = api.start([*files, *BASE, *snap])
    try:
        assert again.state.scheduler.occupancy()["prefix_nodes"] == 0
        assert not os.path.exists(tmp_path / "snaps" / "engine.snap")
    finally:
        api.stop(again)


def test_servers_over_one_loaded_stack(files, servers):
    _, base = servers()
    want, _ = sse(request(base, "/v1/completions", PROMPT)[2])
    stack = cli.load_stack(api.parse_args([*files, *BASE]))
    started = [api.start([*files, *BASE, *extra], stack=stack)
               for extra in ((), ("--max-seq-len", "64"))]
    try:
        for srv, seq in zip(started, (stack[0].seq_len, 64)):
            eng = srv.state.engine
            assert eng is not stack[0] and eng.cache is not stack[0].cache
            assert (eng.params["embedding"].data_ptr()
                    == stack[0].params["embedding"].data_ptr())
            assert eng.seq_len == seq and srv.state.batch_engine.seq_len == seq
            assert srv.state.tokenizer is stack[1]
            got, fins = sse(request(f"http://127.0.0.1:{srv.server_address[1]}",
                                    "/v1/completions", PROMPT)[2])
            assert got == want and fins == ["length"]
    finally:
        for srv in started:
            api.stop(srv)


def test_metric_families_in_both_formats(servers):
    _, base = servers("--handoff")
    code, _, raw = request(base, "/metrics")
    snap = json.loads(raw)
    for key in ("handoff_exports", "handoff_imports", "handoff_import_rejects",
                "handoff_expired", "snapshot_restores", "kv_pages_spilled",
                "kv_pages_paged_in", "kv_spill_bytes", "kv_host_pool_bytes",
                "sched_preempt_parked"):
        assert key in snap, key
    code, hdr, raw = request(base, "/metrics?format=prometheus")
    text = raw.decode()
    for name in ("dllama_handoff_exports_total", "dllama_handoff_imports_total",
                 "dllama_handoff_import_rejects_total", "dllama_handoff_expired_total",
                 "dllama_snapshot_restores_total", "dllama_kv_host_pool_bytes"):
        assert f"# TYPE {name.removesuffix('_total')}" in text or name in text, name
    code, _, raw = request(base, "/health")
    cap = json.loads(raw)["capacity"]
    assert cap["handoff"] is True and cap["kv_pressure"]["reserve"] == "full"
