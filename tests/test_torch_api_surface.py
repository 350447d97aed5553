"""The rest of the OpenAI surface on the port's API server — list prompts,
``n > 1``, ``logprobs`` and ``echo`` (the lockstep batch and
``Engine.score_batch``), ``GET /metrics`` in both formats and the
``/debug`` routes — against the JAX package's server, both in-process on
the CPU on the same tiny Q40 fixture with ``--batch-slots 4`` over
contiguous slot rows, f32 activations.

Greedy texts and logprob tokens must be equal; log-probs within
``LP_TOL`` = 1e-3 nats (tests/test_torch_score.py's bar); a top
alternative's string is compared where its margin to its neighbours
exceeds twice that.  The 400s carry the JAX server's error text.
"""

import json
import re
import urllib.error
import urllib.request

import pytest

from dllama_tpu import quants
from fixtures import write_tiny_model, write_tiny_tokenizer

LP_TOL = 1e-3
SERVE = ["--temperature", "0", "--buffer-float-type", "f32", "--batch-slots", "4",
         "--host", "127.0.0.1", "--port", "0"]
CHAT = [{"role": "system", "content": "Be terse."}, {"role": "user", "content": "2+2?"}]


def _jax_server(m: str, t: str):
    """The JAX package's server with a contiguous 4-slot engine, built as
    its main() builds it."""
    from dllama_tpu.cli import build_parser, load_stack
    from dllama_tpu.runtime.engine import Engine
    from dllama_tpu.runtime.scheduler import SlotScheduler
    from dllama_tpu.server import api as japi
    args = build_parser().parse_args(["inference", "--model", m, "--tokenizer", t,
                                      "--workers", "tpu:1", *SERVE])
    engine, tok = load_stack(args)
    batch = Engine(engine.cfg, engine.params, mesh=engine.mesh, batch=4,
                   kv_dtype=engine.cache.k.dtype)
    sched = SlotScheduler(batch, overlap=True)
    state = japi.ApiState(engine, tok, default_temperature=0.0, batch_engine=batch,
                          scheduler=sched)
    return japi.serve(state, host="127.0.0.1", port=0, block=False), sched


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    from dllama_tpu_torch.server import api
    d = tmp_path_factory.mktemp("torch_surface")
    m, t = str(d / "tiny.m"), str(d / "tiny.t")
    write_tiny_model(m, ftype=quants.Q40)
    write_tiny_tokenizer(t)
    port = api.start(["--model", m, "--tokenizer", t, "--device", "cpu", *SERVE])
    ref, ref_sched = _jax_server(m, t)
    yield (f"http://127.0.0.1:{port.server_address[1]}",
           f"http://127.0.0.1:{ref.server_address[1]}")
    api.stop(port)
    ref.shutdown()
    ref.server_close()
    ref_sched.close()


def post(base: str, path: str, body: dict, headers: dict | None = None):
    req = urllib.request.Request(base + path, json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json",
                                          **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def get(base: str, path: str, headers: dict | None = None):
    req = urllib.request.Request(base + path, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers.get("Content-Type"), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read().decode()


def both(servers, path, body):
    got, want = (post(base, path, body) for base in servers)
    assert got[0] == want[0] == 200, (got, want)
    return json.loads(got[1]), json.loads(want[1])


def streamed(raw: str) -> dict[int, str]:
    """An SSE body's text, joined per choice index."""
    assert raw.rstrip().endswith("data: [DONE]")
    out: dict[int, str] = {}
    for ln in raw.splitlines():
        if ln.startswith("data: {"):
            c = json.loads(ln[6:])["choices"][0]
            out[c["index"]] = out.get(c["index"], "") + (c.get("text") or "")
    return out


def test_greedy_list_prompt(servers):
    got, want = both(servers, "/v1/completions",
                     {"prompt": ["hello", "hi there", "abc"], "max_tokens": 10})
    assert [c["text"] for c in got["choices"]] == [c["text"] for c in want["choices"]]
    assert [c["index"] for c in got["choices"]] == [0, 1, 2]
    assert [c["finish_reason"] for c in got["choices"]] == \
        [c["finish_reason"] for c in want["choices"]]
    assert got["usage"] == want["usage"]
    assert any(c["text"] for c in got["choices"])


def test_greedy_completions_n(servers):
    got, want = both(servers, "/v1/completions", {"prompt": "hello", "n": 2, "max_tokens": 8})
    assert [c["text"] for c in got["choices"]] == [c["text"] for c in want["choices"]]
    assert len(got["choices"]) == 2 and got["usage"] == want["usage"]


def test_greedy_chat_n(servers):
    got, want = both(servers, "/v1/chat/completions",
                     {"messages": CHAT, "n": 2, "max_tokens": 8})
    texts = [c["message"]["content"] for c in got["choices"]]
    assert texts == [c["message"]["content"] for c in want["choices"]]
    assert len(texts) == 2 and texts[0] == texts[1]
    assert got["usage"] == want["usage"]


def _ranked_equal(a: dict, b: dict) -> None:
    """Two top_logprobs dicts: values within LP_TOL rank for rank, and the
    strings equal where the margin decides."""
    va, vb = sorted(a.items(), key=lambda kv: -kv[1]), sorted(b.items(), key=lambda kv: -kv[1])
    assert len(va) == len(vb)
    for i, ((sa, la), (sb, lb)) in enumerate(zip(va, vb)):
        assert abs(la - lb) <= LP_TOL
        # the last entry's margin to the next alternative is unknown
        above = i == 0 or vb[i - 1][1] - lb > 2 * LP_TOL
        if above and i < len(vb) - 1 and lb - vb[i + 1][1] > 2 * LP_TOL:
            assert sa == sb


@pytest.mark.parametrize("echo", [True, False])
def test_logprobs(servers, echo):
    body = {"prompt": ["hello", "hi"], "max_tokens": 6, "logprobs": 3, "echo": echo}
    got, want = both(servers, "/v1/completions", body)
    for g, w in zip(got["choices"], want["choices"]):
        assert g["text"] == w["text"]
        lg, lw = g["logprobs"], w["logprobs"]
        assert lg["tokens"] == lw["tokens"] and "".join(lg["tokens"]) == g["text"]
        assert lg["text_offset"] == lw["text_offset"]
        for a, b in zip(lg["token_logprobs"], lw["token_logprobs"]):
            assert (a is None) == (b is None)
            if b is not None:
                assert abs(a - b) <= LP_TOL and a <= 0
        for a, b in zip(lg["top_logprobs"], lw["top_logprobs"]):
            assert (a is None) == (b is None)
            if b is not None:
                assert len(a) >= 1
                _ranked_equal(a, b)


def test_logprobs_zero_has_no_alternatives(servers):
    got, want = both(servers, "/v1/completions",
                     {"prompt": "hello", "max_tokens": 4, "logprobs": 0})
    g, w = got["choices"][0]["logprobs"], want["choices"][0]["logprobs"]
    assert g["top_logprobs"] is None is w["top_logprobs"]
    assert g["tokens"] == w["tokens"]


def test_streamed_list_prompt(servers):
    body = {"prompt": ["hello", "hi there"], "max_tokens": 10, "stream": True}
    got, want = (post(base, "/v1/completions", body) for base in servers)
    assert got[0] == want[0] == 200
    assert streamed(got[1]) == streamed(want[1])
    plain = json.loads(post(servers[0], "/v1/completions",
                            dict(body, stream=False))[1])["choices"]
    assert streamed(got[1]) == {c["index"]: c["text"] for c in plain}


@pytest.mark.parametrize("path,body", [
    ("/v1/completions", {"prompt": ["a", "b", "c", "d", "e"], "max_tokens": 4}),
    ("/v1/completions", {"prompt": "hello", "n": 5, "max_tokens": 4}),
    ("/v1/completions", {"prompt": ["a", "b"], "logprobs": 1, "stream": True}),
    ("/v1/chat/completions", {"messages": CHAT, "n": 5}),
    ("/v1/chat/completions", {"messages": CHAT, "n": 2, "stream": True}),
    ("/v1/completions", {"prompt": ["a", "b"], "n": "x"}),
], ids=["too-many-prompts", "n-past-slots", "stream-logprobs", "chat-n-past-slots",
        "chat-n-stream", "bad-n"])
def test_refusals_match_jax(servers, path, body):
    got, want = (post(base, path, body) for base in servers)
    assert got[0] == want[0] == 400, (got, want)
    gerr, werr = json.loads(got[1])["error"], json.loads(want[1])["error"]
    assert str(gerr) == str(werr)


def test_metrics_both_formats(servers):
    port, ref = servers
    for base in servers:
        assert post(base, "/v1/completions", {"prompt": "hello", "max_tokens": 4})[0] == 200
    code, ctype, raw = get(port, "/metrics")
    assert code == 200 and ctype.startswith("application/json")
    ours = json.loads(raw)
    theirs = json.loads(get(ref, "/metrics")[2])
    assert set(ours) <= set(theirs)
    assert ours["requests_served"] >= 1 and ours["schema_version"] == theirs["schema_version"]
    assert set(ours["ttft_seconds"]) == set(theirs["ttft_seconds"])
    for q in ("?format=prometheus", ""):
        code, ctype, text = get(port, "/metrics" + q,
                                headers={} if q else {"Accept": "text/plain"})
        assert code == 200 and ctype.startswith("text/plain; version=0.0.4")
        sample = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? [-+0-9.eInf]+$')
        for ln in text.splitlines():
            assert ln.startswith("# HELP ") or ln.startswith("# TYPE ") or sample.match(ln), ln
        assert re.search(r"^dllama_requests_served_total \d+$", text, re.M)
        assert re.search(r'^dllama_matmul_dispatch_total\{codec="q40",path="plain"\} \d+$',
                         text, re.M)


def test_debug_routes(servers):
    port, ref = servers
    rid = "surface-rid-1"
    for base in servers:
        code, _ = post(base, "/v1/completions", {"prompt": ["hello", "hi"], "max_tokens": 4},
                       headers={"X-Request-Id": rid})
        assert code == 200
    ours = json.loads(get(port, f"/debug/requests/{rid}")[2])
    theirs = json.loads(get(ref, f"/debug/requests/{rid}")[2])
    # the port retires a lockstep record before its reply, with the
    # produced tokens and each choice's finish reason (the JAX server
    # closes it after the reply, in its handler's fallback, without them)
    assert set(ours) <= set(theirs) | {"produced", "finish_reasons"}
    assert ours["finish_reasons"] == ["length", "length"] and ours["produced"] == 8
    assert ours["request_id"] == rid and ours["finish"] == theirs["finish"] == "served"
    assert ours["path"] == theirs["path"] == "/v1/completions"
    assert get(port, "/debug/requests/no-such-id")[0] == get(ref, "/debug/requests/no-such-id")[0]
    for path in ("/debug/requests", "/debug/timeline", "/debug/trace", "/debug/trace?since=0",
                 "/debug/events", "/debug/events?since=0"):
        (c1, _, a), (c2, _, b) = get(port, path), get(ref, path)
        assert c1 == c2 == 200, path
        assert set(json.loads(a)) == set(json.loads(b)), path
    recent = json.loads(get(port, "/debug/requests?n=50")[2])["requests"]
    assert any(r["request_id"] == rid for r in recent)
    trace = json.loads(get(port, "/debug/trace?last=50")[2])["traceEvents"]
    assert any(e.get("args", {}).get("request_id") == rid and e["name"] == "request"
               for e in trace)
