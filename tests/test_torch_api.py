"""The port's API server (dllama_tpu_torch.server.api) in-process on the
CPU, against the JAX package's server on the same tiny Q40 fixture: both
on 127.0.0.1 with --batch-slots 2 --kv-pages 40 --kv-page-size 4, f32
activations, greedy.  Greedy text must be the same byte for byte, JSON and
SSE, completions and chat (both ride the slot scheduler and its paged
pool)."""

import json
import urllib.error
import urllib.request

import pytest

from dllama_tpu import quants
from fixtures import write_tiny_model, write_tiny_tokenizer

SERVE = ["--temperature", "0", "--buffer-float-type", "f32", "--batch-slots", "2",
         "--kv-pages", "40", "--kv-page-size", "4", "--host", "127.0.0.1", "--port", "0"]


def _jax_server(m: str, t: str):
    """The JAX package's server, built in-process as its main() builds it
    (the scheduler's overlapped pipeline on, the default of both)."""
    from dllama_tpu.cli import build_parser, load_stack
    from dllama_tpu.runtime.engine import Engine
    from dllama_tpu.runtime.scheduler import SlotScheduler
    from dllama_tpu.server import api as japi
    # one device: the tests' virtual CPU mesh has eight
    args = build_parser().parse_args(["inference", "--model", m, "--tokenizer", t,
                                      "--workers", "tpu:1", *SERVE])
    engine, tok = load_stack(args)
    batch = Engine(engine.cfg, engine.params, mesh=engine.mesh, batch=2,
                   kv_dtype=engine.cache.k.dtype, kv_pages=40, kv_page_size=4)
    sched = SlotScheduler(batch, overlap=True)
    state = japi.ApiState(engine, tok, default_temperature=0.0, batch_engine=batch,
                          scheduler=sched)
    return japi.serve(state, host="127.0.0.1", port=0, block=False), sched


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    from dllama_tpu_torch.server import api
    d = tmp_path_factory.mktemp("torch_api")
    m, t = str(d / "tiny.m"), str(d / "tiny.t")
    write_tiny_model(m, ftype=quants.Q40)
    write_tiny_tokenizer(t)
    port = api.start(["--model", m, "--tokenizer", t, "--device", "cpu", *SERVE])
    ref, ref_sched = _jax_server(m, t)
    yield (f"http://127.0.0.1:{port.server_address[1]}",
           f"http://127.0.0.1:{ref.server_address[1]}", port.state)
    api.stop(port)
    ref.shutdown()
    ref.server_close()
    ref_sched.close()


def post(base: str, path: str, body: dict):
    req = urllib.request.Request(base + path, json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def text_of(path: str, body: dict, raw: str) -> str:
    if body.get("stream"):
        chunks = [json.loads(ln[6:]) for ln in raw.splitlines()
                  if ln.startswith("data: {")]
        assert raw.rstrip().endswith("data: [DONE]")
        return "".join(c["choices"][0].get("text") or
                       c["choices"][0].get("delta", {}).get("content") or "" for c in chunks)
    ch = json.loads(raw)["choices"][0]
    return ch["text"] if path == "/v1/completions" else ch["message"]["content"]


CHAT = [{"role": "system", "content": "Be terse."}, {"role": "user", "content": "2+2?"}]


@pytest.mark.parametrize("path,body", [
    ("/v1/completions", {"prompt": "hello", "max_tokens": 12}),
    ("/v1/completions", {"prompt": "hello hi", "max_tokens": 12, "stream": True}),
    ("/v1/chat/completions", {"messages": CHAT, "max_tokens": 10}),
    ("/v1/chat/completions", {"messages": CHAT, "max_tokens": 10, "stream": True}),
], ids=["completions", "completions-sse", "chat", "chat-sse"])
def test_greedy_text_matches_jax_server(servers, path, body):
    port, ref, state = servers
    body = dict(body, temperature=0)
    got, want = post(port, path, body), post(ref, path, body)
    assert got[0] == want[0] == 200, (got, want)
    assert text_of(path, body, got[1]) == text_of(path, body, want[1])
    assert text_of(path, body, got[1])
    assert state.finished[-1]["scheduler"] is True


def test_health_and_models(servers):
    port, _, _ = servers
    with urllib.request.urlopen(port + "/v1/models", timeout=10) as r:
        models = json.loads(r.read())
    assert models["object"] == "list" and models["data"][0]["object"] == "model"
    with urllib.request.urlopen(port + "/health", timeout=10) as r:
        health = json.loads(r.read())
    assert health["status"] == "ok" and health["backend"] == "cpu"
    assert health["batch_slots"] == 2 and health["scheduler"]["kv_pages_total"] == 39
    assert set(health["launches"]) == {"q40", "q8", "paged_attention"}


def test_debug_launches_adds_the_matmuls_by_shape(servers):
    """``/debug/launches`` is ``/health``'s launch block with each matmul's
    launches by shape as ``[*key, n]`` (none on the CPU: every call there
    is plain); the probed ``/health`` carries no shape table."""
    port, _, _ = servers
    with urllib.request.urlopen(port + "/health", timeout=10) as r:
        health = json.loads(r.read())["launches"]
    with urllib.request.urlopen(port + "/debug/launches", timeout=10) as r:
        debug = json.loads(r.read())
    for codec in ("q40", "q8"):
        assert "by_shape" not in health[codec]
        assert debug[codec].pop("by_shape") == []
        assert debug[codec]["kernel_launches"] == 0
    assert debug == health


@pytest.mark.parametrize("path,body", [
    ("/v1/chat/completions", {"messages": CHAT, "max_tokens": 6}),
    ("/v1/completions", {"prompt": "hello", "max_tokens": 6, "stream": True}),
], ids=["chat", "completions-sse"])
def test_seeded_sampling_takes_the_mutex_path(servers, path, body):
    """A seeded sampled request runs on the batch-1 engine and repeats."""
    port, _, state = servers
    body = dict(body, temperature=0.8, seed=7)
    a, b = post(port, path, body), post(port, path, body)
    assert a[0] == b[0] == 200
    assert text_of(path, body, a[1]) == text_of(path, body, b[1])
    assert state.finished[-1]["scheduler"] is False
    assert state.finished[-1]["completion_tokens"] == 6


# the lockstep batch's features: on this paged server they answer the JAX
# server's 400 (the paged pool has no lockstep mode)
LOCKSTEP = ("n > 1", "logprobs", "echo", "a list prompt")
# ported since: they answer as the JAX server does (an unknown priority
# class is 400; /admin/import without --handoff is 404)
AS_JAX = ("priority", "/admin/import")
# ported since: POST /debug/profile answers 200 with the top ops and the
# split (tests/test_torch_profiling.py holds the rest)
ANSWERS = ("/debug/profile",)


@pytest.mark.parametrize("method,path,body,named", [
    ("POST", "/v1/completions", {"prompt": "hi", "n": 2}, "n > 1"),
    ("POST", "/v1/completions", {"prompt": "hi", "logprobs": 1}, "logprobs"),
    ("POST", "/v1/completions", {"prompt": "hi", "echo": True}, "echo"),
    ("POST", "/v1/completions", {"prompt": ["a", "b"]}, "a list prompt"),
    ("POST", "/v1/chat/completions", {"messages": CHAT, "priority": "turbo"}, "priority"),
    ("POST", "/debug/profile", {}, "/debug/profile"),
    ("POST", "/admin/import", {}, "/admin/import"),
])
def test_unported_features_answer_400(servers, method, path, body, named):
    """What the port does not carry answers 400 naming itself; the lockstep
    batch's features answer the JAX server's 400 on a paged server; the
    priority field and /admin/import answer what the JAX server answers;
    POST /debug/profile answers."""
    port, ref, _ = servers
    if method == "GET":
        try:
            urllib.request.urlopen(port + path, timeout=10)
            code, raw = 200, ""
        except urllib.error.HTTPError as e:
            code, raw = e.code, e.read().decode()
    else:
        code, raw = post(port, path, body)
    if named in ANSWERS:
        assert code == 200, raw
        body = json.loads(raw)
        assert body["ops"] and body["compute_ms"] > 0 and "not yet ported" not in raw
        return
    if named in AS_JAX:
        want = post(ref, path, body)
        assert code == want[0] and code in (400, 404)
        assert json.loads(raw)["error"] == json.loads(want[1])["error"]
        return
    assert code == 400
    if named in LOCKSTEP:
        want = post(ref, path, body)
        assert want[0] == 400 and "--kv-pages" in raw
        assert json.loads(raw)["error"] == json.loads(want[1])["error"]
    else:
        assert "not yet ported" in raw and named in raw


def test_unported_server_flag_exits():
    from dllama_tpu_torch.server import api
    # --step-timeout is ported since the fleet slice, --weights-float-type
    # since the loading flags came over, --elastic since the elastic slice:
    # the server takes them, and a flag still outside the port stands in
    # (--coordinator since the worker slice, which the server refuses by
    # name: tests/test_torch_multihost.py; --sp stands in for it)
    with pytest.raises(SystemExit,
                       match=r"not yet ported to dllama_tpu_torch: --sp \(run"):
        api.parse_args(["--spec", "pld", "--weights-float-type", "q40", "--dequantize",
                        "--elastic", "--sp", "2"])
