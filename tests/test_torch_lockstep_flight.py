"""The lockstep paths of the port's API server close a request's flight
record before its reply reaches the client.

List-prompt completions, their streamed form and chat ``n > 1`` run as
one lockstep batch.  Each retires its record (``finish``, the produced
tokens, each choice's finish reason) before it writes the reply, or the
stream's ``[DONE]``; the handler's ``finally`` retire is only the
fallback for errors.  Each test holds that ``finally`` (at the handler's
``state.leave``) and reads ``/debug/requests/<id>`` once the reply is
in: the record must already be closed.  The JAX server writes first
and retires in its ``finally``; the port retires first, by design.
"""

import contextlib
import json
import threading
import urllib.request

import pytest

from dllama_tpu import quants
from fixtures import write_tiny_model, write_tiny_tokenizer


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    """The port's server on the tiny fixture, 4 contiguous slot rows, with
    the handler's ``finally`` held at ``state.leave`` until the test opens
    the gate it yields."""
    from dllama_tpu_torch.server import api
    d = tmp_path_factory.mktemp("torch_lockstep_flight")
    m, t = str(d / "tiny.m"), str(d / "tiny.t")
    write_tiny_model(m, ftype=quants.Q40)
    write_tiny_tokenizer(t)
    srv = api.start(["--model", m, "--tokenizer", t, "--device", "cpu", "--temperature",
                     "0", "--batch-slots", "4", "--host", "127.0.0.1", "--port", "0"])
    state = srv.state
    leave = state.leave
    gate = threading.Event()

    def held_leave(duration_s):
        gate.wait(timeout=30)
        leave(duration_s)

    state.leave = held_leave
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}", gate
    finally:
        gate.set()
        state.leave = leave
        api.stop(srv)


def _post(base, path, body, rid):
    return urllib.request.urlopen(urllib.request.Request(
        base + path, json.dumps(body).encode(),
        headers={"Content-Type": "application/json", "X-Request-Id": rid}), timeout=120)


def _record(base, rid) -> dict:
    with urllib.request.urlopen(base + "/debug/requests/" + rid, timeout=60) as r:
        return json.loads(r.read())


@contextlib.contextmanager
def _held(gate):
    """The handler's finally waits until the block ends."""
    gate.clear()
    try:
        yield
    finally:
        gate.set()


def test_list_prompt_completion_retires_before_reply(server):
    base, gate = server
    with _held(gate):
        with _post(base, "/v1/completions", {"prompt": ["hi", "hello"], "max_tokens": 4,
                                             "temperature": 0}, "flight-list") as r:
            body = json.loads(r.read())
        rec = _record(base, "flight-list")
    assert len(body["choices"]) == 2
    assert rec["finish"] == "served", rec
    assert rec["produced"] == body["usage"]["completion_tokens"]
    assert rec["finish_reasons"] == [c["finish_reason"] for c in body["choices"]]


def test_streamed_list_completion_retires_before_done(server):
    base, gate = server
    finishes = {}
    with _held(gate):
        with _post(base, "/v1/completions", {"prompt": ["hi", "hello"], "max_tokens": 4,
                                             "temperature": 0, "stream": True},
                   "flight-stream") as r:
            for line in r:
                line = line.decode().strip()
                if line == "data: [DONE]":
                    break
                if line.startswith("data: "):
                    c = json.loads(line[6:])["choices"][0]
                    if c["finish_reason"] is not None:
                        finishes[c["index"]] = c["finish_reason"]
            rec = _record(base, "flight-stream")
    assert rec["finish"] == "served", rec
    assert rec["finish_reasons"] == [finishes[0], finishes[1]]
    # the same prompts, not streamed: the completion tokens to expect
    with _post(base, "/v1/completions", {"prompt": ["hi", "hello"], "max_tokens": 4,
                                         "temperature": 0}, "flight-stream-ref") as r:
        ref = json.loads(r.read())
    assert rec["produced"] == ref["usage"]["completion_tokens"]


def test_chat_n_retires_before_reply(server):
    base, gate = server
    with _held(gate):
        with _post(base, "/v1/chat/completions",
                   {"messages": [{"role": "user", "content": "hi"}], "n": 3,
                    "max_tokens": 4, "temperature": 0.8, "seed": 1}, "flight-chat-n") as r:
            body = json.loads(r.read())
        rec = _record(base, "flight-chat-n")
    assert len(body["choices"]) == 3
    assert rec["finish"] == "served", rec
    assert rec["produced"] == body["usage"]["completion_tokens"]
    assert rec["finish_reasons"] == [c["finish_reason"] for c in body["choices"]]
