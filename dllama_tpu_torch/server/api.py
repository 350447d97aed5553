"""OpenAI-compatible HTTP API server — a trimmed copy of
``dllama_tpu/server/api.py``.

    python -m dllama_tpu_torch.server.api --model m.m --tokenizer t.t \\
        --batch-slots 8 --kv-pages 513 --kv-page-size 16

* ``POST /v1/chat/completions`` and ``POST /v1/completions``: JSON or SSE
  streaming, per-request temperature / top_p / max_tokens / seed / stop.
* **continuous batching** (``--batch-slots`` + runtime/scheduler.py):
  single-prompt completions, and chat, join the slot engine at decode-step
  granularity.  With ``--kv-pages`` the slot engine keeps its KV in a paged
  pool and a radix prefix cache shares prompt prefixes across requests
  (chat then always rides a slot).  Seeded sampling stays on the
  **mutex path**: the batch-1 engine, one request at a time, with the
  **NaiveCache** resuming a conversation whose messages extend the cached
  prefix.  The mutex path parks the scheduler while it runs, so the two
  never use the card at once.
* ``GET /v1/models`` and ``GET /health``.
* bounded admission (``--max-pending`` → 429 with a jittered
  Retry-After), per-request deadlines (``timeout``/``max_time`` body
  fields, ``--request-timeout``), and a graceful drain on SIGTERM/SIGINT.

Not yet ported (each answers 400 naming itself): ``n > 1``,
``logprobs``, ``echo``, list prompts, ``priority``, ``/metrics``, the
``/debug`` routes and the admin and hand-off routes.
"""

from __future__ import annotations

import codecs
import contextlib
import json
import logging
import os
import signal
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..ops import attention, q8, q40
from ..runtime.engine import ContextOverflow, Engine
from ..runtime.scheduler import SchedulerClosed, SchedulerSaturated, SlotScheduler
from ..runtime.stream import drain_generation
from ..tokenizer.bpe import Tokenizer
from ..tokenizer.chat import ChatItem, ChatTemplate, TokenizerChatStops
from ..tokenizer.eos import EosDetector
from .backoff import jittered_retry_after

_log = logging.getLogger("dllama_tpu_torch.server.api")

#: request bodies above this are refused with 413
MAX_BODY_BYTES = 8 * 1024 * 1024


def _not_ported_msg(what: str) -> str:
    return f"{what} is not yet ported to dllama_tpu_torch"


@dataclass
class ChatMessage:
    role: str
    content: str


@dataclass
class CacheItem:
    end_pos: int
    message: ChatMessage


class NaiveCache:
    """Longest-prefix conversation cache of the mutex path."""

    def __init__(self):
        self.items: list[CacheItem] = []

    def clear(self):
        self.items.clear()

    def push(self, end_pos: int, message: ChatMessage):
        self.items.append(CacheItem(end_pos, message))

    def resolve_delta_prompt(self, messages: list[ChatMessage]) -> tuple[int, list[ChatMessage]]:
        """Returns (start_pos, delta_messages). On any mismatch the cache is
        cleared and the full message list is returned with start_pos 0."""
        n = len(self.items)
        if n and len(messages) > n:
            for i in range(n):
                if (self.items[i].message.role != messages[i].role or
                        self.items[i].message.content != messages[i].content):
                    break
            else:
                start = self.items[n - 1].end_pos
                return start, messages[n:]
        self.clear()
        return 0, messages


@dataclass
class InferenceParams:
    messages: list[ChatMessage] = field(default_factory=list)
    temperature: float = 0.7
    top_p: float = 0.9
    max_tokens: int = 0
    stream: bool = False
    seed: int | None = None
    stop: list[str] = field(default_factory=list)


def parse_request(body: dict, default_temp: float, default_topp: float) -> InferenceParams:
    """Request-param extraction.  JSON ``null`` for an optional field means
    "unset"."""
    p = InferenceParams(temperature=default_temp, top_p=default_topp)
    for m in body.get("messages", []):
        p.messages.append(ChatMessage(str(m.get("role", "")), str(m.get("content", ""))))
    if body.get("temperature") is not None:
        p.temperature = float(body["temperature"])
    if body.get("top_p") is not None:
        p.top_p = float(body["top_p"])
    if body.get("max_tokens") is not None:
        p.max_tokens = int(body["max_tokens"])
    if body.get("stream") is not None:
        p.stream = bool(body["stream"])
    if body.get("seed") is not None:
        p.seed = int(body["seed"])
    stop = body.get("stop")
    if isinstance(stop, str):
        p.stop = [stop]
    elif isinstance(stop, list):
        p.stop = [str(s) for s in stop]
    return p


def unported_fields(path: str, body: dict) -> list[str]:
    """The request fields of ``body`` that ask for a feature the port does
    not carry yet."""
    out = []
    try:
        if int(body.get("n") or 1) != 1:
            out.append("n > 1")
    except (TypeError, ValueError):
        pass  # malformed: the endpoint's own parse answers 400
    if body.get("logprobs") is not None:
        out.append("logprobs")
    if body.get("priority") is not None:
        out.append("priority")
    if path == "/v1/completions":
        if body.get("echo"):
            out.append("echo")
        if isinstance(body.get("prompt"), list):
            out.append("a list prompt")
    return out


class ServerMetrics:
    """The serving counters and the EMA request duration that feeds the
    Retry-After hint."""

    COUNTERS = ("requests_served", "requests_rejected_429", "requests_rejected_503",
                "read_timeouts_408", "deadline_timeouts", "client_disconnects",
                "server_errors")

    def __init__(self):
        self.started_at = time.time()
        self._lock = threading.Lock()
        self._counts = dict.fromkeys(self.COUNTERS, 0)
        self.avg_request_s = 0.0

    def bump(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] += n

    def observe_duration(self, seconds: float) -> None:
        with self._lock:
            a = self.avg_request_s
            self.avg_request_s = seconds if a == 0.0 else 0.8 * a + 0.2 * seconds

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._counts)


class _StreamTimer:
    """Time to first token of one request: started at admission (so queue
    wait counts, as the client sees it), ticked as each delta is
    emitted."""

    def __init__(self):
        self.t0 = time.monotonic()
        self.ttft_s: float | None = None

    def tick(self) -> None:
        if self.ttft_s is None:
            self.ttft_s = time.monotonic() - self.t0


def _bounded(stream, state: "ApiState", deadline: float | None,
             is_aborted, flag: dict, n_prompt: int = 0):
    """Wrap an engine token stream so generation stops between tokens when
    the deadline (or the drain deadline) passes or the client has gone;
    ``flag`` reports why.  The deadline arms only after ``n_prompt`` + 1
    items: a timed-out completion is truncated, never empty."""
    with contextlib.closing(stream):
        for i, item in enumerate(stream):
            yield item
            if is_aborted is not None and is_aborted():
                flag["aborted"] = True
                return
            d = state.effective_deadline(deadline)
            if d is not None and i >= n_prompt and time.monotonic() >= d:
                flag["timed_out"] = True
                return


class ApiState:
    """Engine + tokenizer + conversation cache shared across requests.

    ``batch_engine`` (``--batch-slots``) is the slot engine the
    ``scheduler`` drives; it shares the batch-1 engine's weight tensors on
    the device, so the only extra memory is its KV cache.  ``engine_lock``
    is the mutex of the batch-1 path.  ``finished`` keeps one record per
    served request (path, tokens, time to first token, latency)."""

    def __init__(self, engine: Engine, tokenizer: Tokenizer,
                 default_temperature: float = 0.7, default_topp: float = 0.9,
                 chunk: int = 16, model_name: str = "dllama-tpu-torch",
                 batch_engine: Engine | None = None,
                 max_pending: int = 8, request_timeout: float = 0.0,
                 io_timeout: float = 15.0, drain_grace: float = 30.0,
                 scheduler: SlotScheduler | None = None):
        self.engine = engine
        self.batch_engine = batch_engine
        self.scheduler = scheduler
        self.tokenizer = tokenizer
        self.default_temperature = default_temperature
        self.default_topp = default_topp
        self.chunk = chunk
        self.model_name = model_name
        self.naive_cache = NaiveCache()
        stops = TokenizerChatStops(tokenizer)
        self.base_stops = stops.stops
        eos = tokenizer.vocab[tokenizer.chat_eos_id].decode("utf-8", "replace")
        self.template = ChatTemplate(tokenizer.chat_template, eos)
        self.max_pending = max_pending
        self.request_timeout = request_timeout
        self.io_timeout = io_timeout
        self.drain_grace = drain_grace
        self.engine_lock = threading.Lock()
        self.metrics = ServerMetrics()
        self.finished: deque[dict] = deque(maxlen=4096)
        self._admit_lock = threading.Lock()
        self._pending = 0   # admitted: queued on the mutex or generating
        self._active = 0    # generating
        self.draining = False
        self.drain_deadline: float | None = None

    # -- admission / drain ---------------------------------------------
    def try_enter(self) -> str:
        """Admit one request: ``"ok"`` (caller MUST pair with ``leave``),
        ``"full"`` (→ 429) or ``"draining"`` (→ 503)."""
        with self._admit_lock:
            if self.draining:
                return "draining"
            if self._pending >= self.max_pending:
                return "full"
            self._pending += 1
            return "ok"

    def leave(self, duration_s: float) -> None:
        with self._admit_lock:
            self._pending -= 1
        self.metrics.observe_duration(duration_s)

    def mark_active(self, on: bool) -> None:
        with self._admit_lock:
            self._active += 1 if on else -1

    def queue_depths(self) -> tuple[int, int]:
        """(in_flight, queued) — for /health and Retry-After."""
        with self._admit_lock:
            return self._active, max(self._pending - self._active, 0)

    def begin_drain(self, grace: float | None = None) -> None:
        """Stop admitting; clamp every in-flight deadline to now+grace."""
        with self._admit_lock:
            self.draining = True
            g = self.drain_grace if grace is None else grace
            self.drain_deadline = time.monotonic() + max(g, 0.0)
        if self.scheduler is not None:
            self.scheduler.begin_drain(self.drain_deadline)

    def retry_after_hint(self) -> int:
        """Retry-After seconds: queue depth × the EMA request duration."""
        with self._admit_lock:
            depth = self._pending
        avg = self.metrics.avg_request_s or 1.0
        return max(1, min(int(depth * avg + 0.999), 60))

    def request_deadline(self, body: dict) -> float | None:
        """Monotonic deadline from the body's ``timeout``/``max_time``
        seconds, clamped by ``--request-timeout``; None when neither."""
        t = body.get("timeout")
        if t is None:
            t = body.get("max_time")
        try:
            t = float(t) if t is not None else None
        except (TypeError, ValueError):
            t = None
        if t is not None and t <= 0:
            t = None
        if self.request_timeout > 0:
            t = self.request_timeout if t is None else min(t, self.request_timeout)
        return time.monotonic() + t if t is not None else None

    def effective_deadline(self, deadline: float | None) -> float | None:
        """The request deadline clamped by the drain deadline."""
        dd = self.drain_deadline
        if dd is None:
            return deadline
        return dd if deadline is None else min(deadline, dd)

    def health(self) -> dict:
        """Readiness and load for ``/health``, with the kernels' launch
        counters."""
        eng = self.engine
        in_flight, queued = self.queue_depths()
        return {
            "status": "draining" if self.draining else "ok",
            "ready": True,  # the model loads before serve() binds the port
            "model": self.model_name,
            "backend": eng.device.type,
            "seq_len": eng.seq_len,
            "batch_slots": self.batch_engine.batch if self.batch_engine else 0,
            "scheduler": self.scheduler.occupancy() if self.scheduler else None,
            "in_flight": in_flight,
            "queued": queued,
            "max_pending": self.max_pending,
            "uptime_s": round(time.time() - self.metrics.started_at, 3),
            **self.metrics.snapshot(),
            "launches": {
                **{name: {k: v for k, v in mod.counters().items() if isinstance(v, int)}
                   for name, mod in (("q40", q40), ("q8", q8))},
                "paged_attention": attention.counters()},
        }

    def exclusive(self):
        """Hold the card for the batch-1 path: park the scheduler until its
        slots are empty."""
        if self.scheduler is not None:
            return self.scheduler.exclusive()
        return contextlib.nullcontext()

    # -- mutex path ------------------------------------------------------
    def complete(self, params: InferenceParams, emit, *,
                 deadline: float | None = None, is_aborted=None):
        """Run one chat completion on the batch-1 engine; calls
        ``emit(delta_text)`` as text becomes safe to stream.  Returns
        ``(content, n_prompt_tokens, n_completion_tokens, finish_reason)``
        with finish ``stop``, ``timeout`` or ``aborted``.  Every early exit
        flows through drain_generation's end-of-stream path, so
        ``engine.pos`` and the conversation cache stay consistent."""
        engine, tok = self.engine, self.tokenizer
        if deadline is not None and time.monotonic() >= deadline:
            return "", 0, 0, "timeout"
        start_pos, delta_messages = self.naive_cache.resolve_delta_prompt(params.messages)
        if start_pos == 0:
            engine.reset()
        engine.pos = start_pos
        items = [ChatItem(m.role, m.content) for m in delta_messages]
        prompt_tokens = tok.encode(self.template.generate(items, True),
                                   add_bos=start_pos == 0)
        prompt_end = start_pos + len(prompt_tokens)
        if prompt_end + 1 >= engine.seq_len:
            # refuse before touching the cache
            raise ContextOverflow(
                f"prompt needs {prompt_end} of {engine.seq_len} context positions")
        for m in delta_messages:
            self.naive_cache.push(prompt_end, m)
        max_pos = engine.seq_len
        if params.max_tokens > 0:
            max_pos = min(prompt_end + params.max_tokens, engine.seq_len)
        detector = EosDetector(tok.chat_eos_id, self.base_stops + params.stop,
                               padding_left=2, padding_right=2)
        seed = params.seed if params.seed is not None else int(time.time())
        stream = engine.generate_stream(
            prompt_tokens, max_pos - start_pos, temperature=params.temperature,
            topp=params.top_p, seed=seed, chunk=self.chunk,
            eos_ids=(tok.chat_eos_id,))
        flag: dict = {}
        if deadline is not None or is_aborted is not None \
                or self.drain_deadline is not None:
            stream = _bounded(stream, self, deadline, is_aborted, flag,
                              n_prompt=len(prompt_tokens))
        reply, n_completion, _ = drain_generation(
            engine, tok, detector, stream, len(prompt_tokens), prompt_end, emit)
        if engine.pos >= engine.seq_len:
            self.naive_cache.clear()  # context exhausted
        else:
            self.naive_cache.push(engine.pos, ChatMessage("assistant", reply))
        finish = "aborted" if flag.get("aborted") \
            else "timeout" if flag.get("timed_out") else "stop"
        return reply, len(prompt_tokens), n_completion, finish

    def complete_text(self, ids: list[int], max_tokens: int, *,
                      temperature: float, top_p: float, seed: int | None,
                      stop: list[str], emit, deadline: float | None = None,
                      is_aborted=None) -> tuple[str, int, str]:
        """One text completion on the batch-1 engine (the mutex path of
        ``/v1/completions``: seeded sampling, or no ``--batch-slots``).
        Same stop-scan and ``emit(delta, finish)`` contract as
        :meth:`sched_drain`; returns ``(text, n_completion, finish)``."""
        engine, tok = self.engine, self.tokenizer
        if len(ids) + 1 >= engine.seq_len:
            raise ContextOverflow(f"prompt needs {len(ids)} of {engine.seq_len} "
                                  "context positions")
        engine.reset()
        budget = engine.seq_len - len(ids)
        if max_tokens > 0:
            budget = min(budget, max_tokens)
        eos = tok.eos_id if tok.eos_id >= 0 else tok.chat_eos_id
        stream = engine.generate_stream(
            ids, len(ids) + budget, temperature=temperature, topp=top_p,
            seed=seed if seed is not None else int(time.time()),
            chunk=self.chunk, eos_ids=(eos,))
        flag: dict = {}
        stream = _bounded(stream, self, deadline, is_aborted, flag, n_prompt=len(ids))

        def completion():
            for i, (t, _) in enumerate(stream):
                if i < len(ids):
                    continue  # the engine echoes the prompt first
                if t == eos:
                    flag["eos"] = True
                    return
                yield t

        text, n_comp, finish = self._drain_tokens(
            completion(), ids[-1], stop=stop, emit=emit, is_aborted=is_aborted,
            cancel=lambda reason: None,
            finish=lambda: "aborted" if flag.get("aborted")
            else "timeout" if flag.get("timed_out")
            else "stop" if flag.get("eos") else "length")
        return text, n_comp, finish

    # -- scheduler path ------------------------------------------------
    def overflow_body(self, e: Exception) -> dict:
        """Error body for a capacity 4xx: the message plus the slot count
        and live scheduler occupancy."""
        body: dict = {"error": str(e)}
        if self.batch_engine is not None:
            body["batch_slots"] = self.batch_engine.batch
        if self.scheduler is not None:
            body["scheduler"] = self.scheduler.occupancy()
        return body

    def sched_submit(self, prompt_tokens: list[int], max_tokens: int, *,
                     temperature: float, top_p: float, eos_id: int,
                     deadline: float | None, stop: list[str] | None = None):
        """Validate and submit one request to the slot scheduler (split
        from :meth:`sched_drain` so a streaming handler can answer
        400/429/503 before committing to SSE headers).  Raises
        ContextOverflow / SchedulerClosed / SchedulerSaturated."""
        eng = self.scheduler.engine
        if not prompt_tokens:
            raise ContextOverflow("a prompt encoded to zero tokens")
        if len(prompt_tokens) + 1 >= eng.seq_len:
            raise ContextOverflow(f"prompt needs {len(prompt_tokens)} of "
                                  f"{eng.seq_len} context positions")
        max_new = eng.seq_len - len(prompt_tokens)
        if max_tokens > 0:
            max_new = min(max_new, max_tokens)
        ticket = self.scheduler.submit(
            prompt_tokens, max_new, temperature=temperature, top_p=top_p,
            eos_ids=(eos_id,), deadline=self.effective_deadline(deadline))
        ticket.stop = [str(s) for s in stop or []]
        return ticket

    def sched_drain(self, ticket, prev: int, *, stop: list[str], emit,
                    is_aborted=None) -> tuple[str, int, str]:
        """Consume one ticket's token stream; calls ``emit(delta,
        finish_or_None)`` as text becomes safe and returns ``(text,
        n_completion_tokens, finish)`` with finish
        stop/length/timeout/aborted.  A scheduler-side failure re-raises
        here, on this handler's thread."""
        return self._drain_tokens(ticket.tokens(), prev, stop=stop, emit=emit,
                                  is_aborted=is_aborted, cancel=ticket.cancel,
                                  finish=lambda: ticket.finish or "aborted")

    def _drain_tokens(self, tokens, prev: int, *, stop: list[str], emit,
                      is_aborted, cancel, finish) -> tuple[str, int, str]:
        """Incremental UTF-8 decode of completion ``tokens`` with a
        ``max(len(stop)) - 1`` character hold-back, so a stop string split
        across tokens is never emitted.  ``cancel(reason)`` asks the
        producer to stop; ``finish()`` is the producer's verdict once the
        tokens end."""
        tok = self.tokenizer
        dec = codecs.getincrementaldecoder("utf-8")("replace")
        hold = max((len(s) for s in stop), default=0)
        parts: list[str] = []
        buf = ""
        n_comp = 0

        def push(delta, fin):
            parts.append(delta)
            emit(delta, fin)

        for t in tokens:
            if is_aborted is not None and is_aborted():
                cancel("aborted")
                break
            n_comp += 1
            buf += dec.decode(tok.decode_piece(prev, t))
            prev = t
            cuts = [c for c in (buf.find(s) for s in stop) if c != -1]
            if cuts:
                # the producer keeps running until it honors the cancel;
                # tokens past the stop are never decoded here
                cancel("stop")
                push(buf[:min(cuts)], "stop")
                return "".join(parts), n_comp, "stop"
            if hold and len(buf) >= hold:
                push(buf[:len(buf) - (hold - 1)], None)
                buf = buf[len(buf) - (hold - 1):]
            elif not hold and buf:
                push(buf, None)
                buf = ""
        fin = finish()
        buf += dec.decode(b"", True)
        cuts = [c for c in (buf.find(s) for s in stop) if c != -1]
        if cuts:
            buf = buf[:min(cuts)]
            fin = "stop"
        push(buf, fin)
        return "".join(parts), n_comp, fin


def make_handler(state: ApiState):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # socket read/write timeout: a stalled peer costs one 408 or a
        # disconnect, never a hung thread
        timeout = state.io_timeout if state.io_timeout > 0 else None

        def log_message(self, fmt, *a):
            _log.debug("http %s %s", self.command, self.path)

        def send_response(self, *a, **kw):
            self._began_response = True
            super().send_response(*a, **kw)

        def _json(self, code: int, obj: dict, headers: dict | None = None):
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            for k, v in (headers or {}).items():
                self.send_header(k, str(v))
            if state.draining:
                self.close_connection = True
            self.end_headers()
            try:
                self.wfile.write(data)
            except OSError:
                self.close_connection = True

        def _sse_headers(self):
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.end_headers()

        def _sse_emitter(self, aborted: list, chunk_of, timer: _StreamTimer | None):
            """``emit(delta, finish)`` writing one SSE chunk per delta; a
            dead client flips ``aborted`` instead of raising."""
            def emit(delta, finish):
                if aborted[0]:
                    return
                chunk = chunk_of(delta, finish)
                if chunk is None:
                    return
                try:
                    self.wfile.write(f"data: {json.dumps(chunk)}\n\n".encode())
                    self.wfile.flush()
                    if timer is not None:
                        timer.tick()
                    if finish == "timeout":
                        state.metrics.bump("deadline_timeouts")
                except OSError:
                    aborted[0] = True
                    state.metrics.bump("client_disconnects")
            return emit

        def _safe_write(self, data: bytes, aborted: list) -> None:
            if aborted[0]:
                return
            try:
                self.wfile.write(data)
                self.wfile.flush()
            except OSError:
                aborted[0] = True
                state.metrics.bump("client_disconnects")

        def _maybe_500(self, err: Exception) -> None:
            if getattr(self, "_began_response", False):
                return
            try:
                self._json(500, {"error": {"message": str(err), "type": "server_error"}})
            except OSError:
                pass

        def _read_body(self) -> dict | None:
            """Read and parse the JSON body; None when a response
            (408/400/413) was already sent or the client vanished."""
            try:
                length = int(self.headers.get("Content-Length", 0) or 0)
                if length > MAX_BODY_BYTES:
                    self.close_connection = True
                    self._json(413, {"error": "request body too large"})
                    return None
                raw = self.rfile.read(length) if length > 0 else b""
                if len(raw) < length:  # peer closed mid-body
                    state.metrics.bump("client_disconnects")
                    self.close_connection = True
                    return None
            except TimeoutError:
                state.metrics.bump("read_timeouts_408")
                self.close_connection = True
                self._json(408, {"error": "timed out reading request body"})
                return None
            except (TypeError, ValueError):
                self._json(400, {"error": "bad Content-Length"})
                return None
            try:
                body = json.loads(raw or b"{}")
            except json.JSONDecodeError as e:
                self._json(400, {"error": f"bad request: {e}"})
                return None
            if not isinstance(body, dict):
                self._json(400, {"error": "request body must be a JSON object"})
                return None
            return body

        def do_GET(self):
            path = self.path.partition("?")[0]
            if path == "/v1/models":
                self._json(200, {"object": "list", "data": [{
                    "id": state.model_name, "object": "model",
                    "created": int(time.time()), "owned_by": "user"}]})
            elif path in ("/health", "/healthz"):
                self._json(200, state.health())
            elif path == "/metrics" or path.startswith(("/debug/", "/admin/")):
                self._json(400, {"error": _not_ported_msg(f"GET {path}")})
            else:
                self._json(404, {"error": "not found"})

        def _sched_eligible(self, body: dict) -> bool:
            """True when this request can ride the slot scheduler.  Seeded
            sampling keeps the mutex path: slot rows share the engine's
            generator, so a per-request seed is only reproducible when the
            request owns the engine."""
            if state.scheduler is None:
                return False
            try:
                temperature = float(body["temperature"]) \
                    if body.get("temperature") is not None \
                    else state.default_temperature
            except (TypeError, ValueError):
                return False  # malformed: the mutex handlers own the 400
            return body.get("seed") is None or temperature == 0.0

        def _submit_or_reject(self, ids, max_tokens, *, temperature, top_p,
                              eos_id, deadline, stop=None):
            """sched_submit with every refusal mapped to its HTTP answer;
            None when a response was already sent."""
            try:
                return state.sched_submit(
                    ids, max_tokens, temperature=temperature, top_p=top_p,
                    eos_id=eos_id, deadline=deadline, stop=stop)
            except ContextOverflow as e:
                self._json(400, state.overflow_body(e))
            except SchedulerSaturated as e:
                state.metrics.bump("requests_rejected_429")
                self._json(429, state.overflow_body(e), headers={
                    "Retry-After": jittered_retry_after(state.retry_after_hint())})
            except SchedulerClosed:
                state.metrics.bump("requests_rejected_503")
                self._json(503, {"error": "server is draining; no new requests accepted"},
                           headers={"Retry-After": jittered_retry_after(30)})
            return None

        def _completion_args(self, body: dict):
            """(text, temperature, top_p, max_tokens, seed, stop, stream)
            of a /v1/completions body; None after answering 400."""
            try:
                text = str(body.get("prompt") or "")
                temperature = float(body["temperature"]) \
                    if body.get("temperature") is not None else state.default_temperature
                top_p = float(body["top_p"]) \
                    if body.get("top_p") is not None else state.default_topp
                max_tokens = int(body.get("max_tokens") or 0)
                seed = int(body["seed"]) if body.get("seed") is not None else None
                stop = body.get("stop")
                stop = [stop] if isinstance(stop, str) else \
                    [str(s) for s in stop] if isinstance(stop, list) else []
                stream = bool(body.get("stream"))
            except (TypeError, ValueError) as e:
                self._json(400, {"error": f"bad request: {e}"})
                return None
            if not text:
                self._json(400, {"error": "prompt required"})
                return None
            return text, temperature, top_p, max_tokens, seed, stop, stream

        def _completions(self, body: dict, deadline: float | None,
                         timer: _StreamTimer, use_sched: bool):
            """Single-prompt /v1/completions: over the slot scheduler when
            ``use_sched``, else on the batch-1 engine under the mutex."""
            args = self._completion_args(body)
            if args is None:
                return
            text, temperature, top_p, max_tokens, seed, stop, stream = args
            tok = state.tokenizer
            ids = tok.encode(text, add_bos=state.engine.cfg.add_bos)
            eos_id = tok.eos_id if tok.eos_id >= 0 else tok.chat_eos_id
            ticket = None
            if use_sched:
                # submit BEFORE any SSE commitment so refusals answer with
                # their proper status codes
                ticket = self._submit_or_reject(
                    ids, max_tokens, temperature=temperature, top_p=top_p,
                    eos_id=eos_id, deadline=deadline, stop=stop)
                if ticket is None:
                    return
            elif len(ids) + 1 >= state.engine.seq_len:
                self._json(400, state.overflow_body(ContextOverflow(
                    f"prompt needs {len(ids)} of {state.engine.seq_len} "
                    "context positions")))
                return
            created = int(time.time())
            cid = f"cmpl-{uuid.uuid4().hex[:12]}"

            def run(emit, is_aborted=None):
                if ticket is not None:
                    return state.sched_drain(ticket, ids[-1], stop=stop, emit=emit,
                                             is_aborted=is_aborted)
                return state.complete_text(
                    ids, max_tokens, temperature=temperature, top_p=top_p,
                    seed=seed, stop=stop, emit=emit, deadline=deadline,
                    is_aborted=is_aborted)

            if stream:
                self._sse_headers()
                aborted = [False]
                emit = self._sse_emitter(aborted, lambda d, f: {
                    "id": cid, "object": "text_completion", "created": created,
                    "model": state.model_name,
                    "choices": [{"text": d, "index": 0, "finish_reason": f,
                                 "logprobs": None}]}, timer)
                try:
                    _, n_comp, finish = run(emit, lambda: aborted[0])
                except Exception as e:
                    if ticket is not None:
                        ticket.cancel("aborted")
                    err = {"error": {"message": str(e), "type": "server_error"}}
                    self._safe_write(f"data: {json.dumps(err)}\n\n".encode()
                                     + b"data: [DONE]\n\n", aborted)
                    raise
                self._safe_write(b"data: [DONE]\n\n", aborted)
                self._record = dict(prompt_tokens=len(ids), completion_tokens=n_comp,
                                    finish=finish)
                return
            try:
                reply, n_comp, finish = run(lambda d, f: timer.tick())
            finally:
                if ticket is not None:
                    ticket.cancel("aborted")  # no-op unless we errored out
            if finish == "timeout":
                state.metrics.bump("deadline_timeouts")
            self._record = dict(prompt_tokens=len(ids), completion_tokens=n_comp,
                                finish=finish)
            self._json(200, {
                "id": cid, "object": "text_completion", "created": created,
                "model": state.model_name,
                "choices": [{"text": reply, "index": 0, "finish_reason": finish,
                             "logprobs": None}],
                "usage": {"prompt_tokens": len(ids), "completion_tokens": n_comp,
                          "total_tokens": len(ids) + n_comp}})

        def _chat_sched(self, body: dict, deadline: float | None,
                        timer: _StreamTimer):
            """Chat over the slot scheduler.  With the paged radix cache
            the templated history matches the tree at admission and only
            the new suffix is prefilled; the NaiveCache is neither
            consulted nor updated here."""
            try:
                params = parse_request(body, state.default_temperature,
                                       state.default_topp)
            except (TypeError, ValueError) as e:
                self._json(400, {"error": f"bad request: {e}"})
                return
            if not params.messages:
                self._json(400, {"error": "messages required"})
                return
            tok = state.tokenizer
            items = [ChatItem(m.role, m.content) for m in params.messages]
            ids = tok.encode(state.template.generate(items, True), add_bos=True)
            stops = state.base_stops + params.stop
            ticket = self._submit_or_reject(
                ids, params.max_tokens, temperature=params.temperature,
                top_p=params.top_p, eos_id=tok.chat_eos_id, deadline=deadline,
                stop=stops)
            if ticket is None:
                return
            created = int(time.time())
            cid = f"chatcmpl-{uuid.uuid4().hex[:12]}"
            if params.stream:
                self._sse_headers()
                aborted = [False]
                emit = self._sse_emitter(aborted, lambda d, f: None if not d else {
                    "id": cid, "object": "chat.completion.chunk", "created": created,
                    "model": state.model_name,
                    "choices": [{"index": 0, "delta": {"content": d},
                                 "finish_reason": None}]}, timer)
                _, n_comp, finish = state.sched_drain(
                    ticket, ids[-1], stop=stops, emit=emit,
                    is_aborted=lambda: aborted[0])
                if finish == "aborted" or aborted[0]:
                    return  # nobody is listening
                if finish == "length":
                    finish = "stop"  # the chat budget contract
                if finish == "timeout":
                    state.metrics.bump("deadline_timeouts")
                final = {"id": cid, "object": "chat.completion.chunk",
                         "created": created, "model": state.model_name,
                         "choices": [{"index": 0, "delta": {}, "finish_reason": finish}]}
                self._safe_write(f"data: {json.dumps(final)}\n\n".encode()
                                 + b"data: [DONE]\n\n", aborted)
                self._record = dict(prompt_tokens=len(ids), completion_tokens=n_comp,
                                    finish=finish)
                return
            reply, n_comp, finish = state.sched_drain(
                ticket, ids[-1], stop=stops, emit=lambda d, f: timer.tick())
            if finish == "length":
                finish = "stop"
            if finish == "timeout":
                state.metrics.bump("deadline_timeouts")
            self._record = dict(prompt_tokens=len(ids), completion_tokens=n_comp,
                                finish=finish)
            self._json(200, {
                "id": cid, "object": "chat.completion", "created": created,
                "model": state.model_name,
                "choices": [{"index": 0, "finish_reason": finish,
                             "message": {"role": "assistant", "content": reply}}],
                "usage": {"prompt_tokens": len(ids), "completion_tokens": n_comp,
                          "total_tokens": len(ids) + n_comp}})

        def _chat(self, body: dict, deadline: float | None, timer: _StreamTimer):
            """Chat on the batch-1 engine (the mutex path)."""
            try:
                params = parse_request(body, state.default_temperature,
                                       state.default_topp)
            except (TypeError, ValueError) as e:
                self._json(400, {"error": f"bad request: {e}"})
                return
            if not params.messages:
                self._json(400, {"error": "messages required"})
                return
            created = int(time.time())
            cid = f"chatcmpl-{uuid.uuid4().hex[:12]}"
            if params.stream:
                self._sse_headers()
                aborted = [False]
                emit = self._sse_emitter(aborted, lambda d, f: {
                    "id": cid, "object": "chat.completion.chunk", "created": created,
                    "model": state.model_name,
                    "choices": [{"index": 0, "delta": {"content": d},
                                 "finish_reason": None}]}, timer)
                try:
                    _, n_prompt, n_comp, finish = state.complete(
                        params, lambda d: emit(d, None), deadline=deadline,
                        is_aborted=lambda: aborted[0])
                except ContextOverflow as e:
                    # headers already sent: an OpenAI-shaped error object,
                    # with no normal finish chunk
                    err = {"error": {"message": str(e), "type": "invalid_request_error"}}
                    self._safe_write(f"data: {json.dumps(err)}\n\n".encode()
                                     + b"data: [DONE]\n\n", aborted)
                    return
                if finish == "aborted" or aborted[0]:
                    return
                if finish == "timeout":
                    state.metrics.bump("deadline_timeouts")
                final = {"id": cid, "object": "chat.completion.chunk",
                         "created": created, "model": state.model_name,
                         "choices": [{"index": 0, "delta": {}, "finish_reason": finish}]}
                self._safe_write(f"data: {json.dumps(final)}\n\n".encode()
                                 + b"data: [DONE]\n\n", aborted)
                self._record = dict(prompt_tokens=n_prompt, completion_tokens=n_comp,
                                    finish=finish)
                return
            try:
                reply, n_prompt, n_comp, finish = state.complete(
                    params, lambda d: timer.tick(), deadline=deadline)
            except ContextOverflow as e:
                self._json(400, {"error": str(e)})
                return
            if finish == "timeout":
                state.metrics.bump("deadline_timeouts")
            self._record = dict(prompt_tokens=n_prompt, completion_tokens=n_comp,
                                finish=finish)
            self._json(200, {
                "id": cid, "object": "chat.completion", "created": created,
                "model": state.model_name,
                "choices": [{"index": 0, "finish_reason": finish,
                             "message": {"role": "assistant", "content": reply}}],
                "usage": {"prompt_tokens": n_prompt, "completion_tokens": n_comp,
                          "total_tokens": n_prompt + n_comp}})

        def do_POST(self):
            path = self.path.partition("?")[0]
            if path.startswith(("/debug/", "/admin/")):
                self._json(400, {"error": _not_ported_msg(f"POST {path}")})
                return
            if path not in ("/v1/chat/completions", "/v1/completions"):
                self._json(404, {"error": "not found"})
                return
            body = self._read_body()
            if body is None:
                return
            missing = unported_fields(path, body)
            if missing:
                self._json(400, {"error": _not_ported_msg(", ".join(missing))})
                return
            verdict = state.try_enter()
            if verdict == "draining":
                state.metrics.bump("requests_rejected_503")
                self._json(503, {"error": "server is draining; no new requests accepted"},
                           headers={"Retry-After": jittered_retry_after(30)})
                return
            if verdict == "full":
                state.metrics.bump("requests_rejected_429")
                self._json(429, {"error": f"server at capacity ({state.max_pending} "
                                          "requests pending); retry later"},
                           headers={"Retry-After": jittered_retry_after(
                               state.retry_after_hint())})
                return
            t0 = time.monotonic()
            deadline = state.request_deadline(body)
            timer = _StreamTimer()  # starts at admission: queue wait counts
            self._record = None
            try:
                locked = False
                use_sched = False
                if self._sched_eligible(body):
                    if path == "/v1/completions" or state.scheduler.prefix_cache is not None:
                        # with the radix prefix cache chat always rides a
                        # slot: shared system prompts bind cached pages
                        use_sched = True
                    else:
                        # chat spillover: the mutex path keeps the
                        # NaiveCache resume while uncontended
                        locked = state.engine_lock.acquire(blocking=False)
                        use_sched = not locked
                if use_sched:
                    state.mark_active(True)
                    try:
                        if path == "/v1/completions":
                            self._completions(body, deadline, timer, True)
                        else:
                            self._chat_sched(body, deadline, timer)
                    finally:
                        state.mark_active(False)
                else:
                    # the batch-1 engine's mutex: the wait here is the queue
                    # try_enter bounded; the scheduler parks meanwhile
                    if not locked:
                        state.engine_lock.acquire()
                    state.mark_active(True)
                    try:
                        with state.exclusive():
                            if path == "/v1/completions":
                                self._completions(body, deadline, timer, False)
                            else:
                                self._chat(body, deadline, timer)
                    finally:
                        state.mark_active(False)
                        state.engine_lock.release()
                state.metrics.bump("requests_served")
                if self._record is not None:
                    state.finished.append(dict(
                        self._record, path=path, stream=bool(body.get("stream")),
                        scheduler=use_sched, ttft_s=timer.ttft_s,
                        latency_s=time.monotonic() - t0))
            except (BrokenPipeError, ConnectionResetError):
                state.metrics.bump("client_disconnects")
                self.close_connection = True
            except Exception as e:
                state.metrics.bump("server_errors")
                self._maybe_500(e)
                _log.exception("error on %s", path)
                raise  # surface in the server log: a 500 is a bug to fix
            finally:
                state.leave(time.monotonic() - t0)

    return Handler


class ApiServer(ThreadingHTTPServer):
    """Threaded HTTP server wired for graceful drain: non-daemon handler
    threads + ``block_on_close`` make ``shutdown()`` wait for in-flight
    requests, each bounded by the drain deadline."""
    daemon_threads = False
    block_on_close = True
    allow_reuse_address = True

    def __init__(self, addr, handler, state: ApiState):
        self.state = state
        super().__init__(addr, handler)


def serve(state: ApiState, host: str = "0.0.0.0", port: int = 9990, *,
          block: bool = True, install_signals: bool | None = None) -> ApiServer:
    """Bind and serve.  With ``block=False`` it serves on a background
    thread and returns the server (``server.server_address`` has the bound
    port; :func:`stop` ends it).  SIGTERM/SIGINT drain: new requests get
    503, in-flight deadlines clamp to now + the drain grace, then the
    server shuts down; a second signal hard-exits."""
    server = ApiServer((host, port), make_handler(state), state)
    if install_signals is None:
        install_signals = block and threading.current_thread() is threading.main_thread()
    if install_signals:
        def _drain(signum, frame):
            if state.draining:  # second signal: the operator means now
                os._exit(1)
            state.begin_drain()
            _log.info("draining on %s (grace %.1f s)", signal.Signals(signum).name,
                      state.drain_grace)
            threading.Thread(target=server.shutdown, daemon=True).start()

        signal.signal(signal.SIGTERM, _drain)
        signal.signal(signal.SIGINT, _drain)
    _log.info("listening on %s:%d", host, server.server_address[1])
    if block:
        try:
            server.serve_forever()
        finally:
            server.server_close()
    else:
        threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def build_state(args) -> ApiState:
    """Load the model and build the server state from parsed CLI args: the
    batch-1 engine, and with ``--batch-slots`` the slot engine (sharing
    its weights) and its scheduler."""
    from ..cli import load_stack
    if args.kv_quant == "int8" and args.kv_pages <= 0:
        raise SystemExit("--kv-quant int8 needs a paged pool (--kv-pages); "
                         "contiguous slot rows have no per-page scales")
    engine, tok = load_stack(args)
    batch_engine = scheduler = None
    if args.batch_slots > 0:
        batch_engine = Engine(engine.cfg, engine.params, seq_len=args.max_seq_len,
                              kv_dtype="q8" if args.kv_quant == "int8"
                              else engine.cache.k.dtype,
                              device=engine.device, batch=args.batch_slots,
                              kv_pages=args.kv_pages, kv_page_size=args.kv_page_size,
                              mesh=engine.mesh)
        scheduler = SlotScheduler(
            batch_engine, prefill_chunk=args.sched_prefill_chunk,
            max_wait_ms=args.sched_max_wait_ms, max_queue=args.sched_max_queue,
            prefix_reuse=not args.no_prefix_reuse, overlap=not args.no_sched_overlap)
        _log.info("slot scheduler: %d slots, %d pages of %d, kv %s, prefix reuse %s, "
                  "overlap %s", args.batch_slots, args.kv_pages, args.kv_page_size,
                  args.kv_quant, scheduler.prefix_cache is not None, scheduler.overlap)
    return ApiState(engine, tok, default_temperature=args.temperature,
                    default_topp=args.topp, chunk=args.chunk,
                    batch_engine=batch_engine, max_pending=args.max_pending,
                    request_timeout=args.request_timeout, scheduler=scheduler)


def parse_args(argv):
    """The server's flags: the CLI's parser without a positional mode;
    flags of the JAX server that the port does not carry exit naming
    them."""
    from ..cli import build_parser, not_ported
    args = build_parser().parse_args(["inference", *argv])
    missing = not_ported(args)
    if missing:
        raise SystemExit(f"not yet ported to dllama_tpu_torch: {', '.join(missing)} "
                         "(run python -m dllama_tpu.server.api for these)")
    return args


def start(argv) -> ApiServer:
    """Load and serve on a background thread (in-process callers: tests and
    ``chip_smoke.py``); :func:`stop` ends it.  ``--port 0`` binds a free
    port."""
    args = parse_args(list(argv))
    return serve(build_state(args), host=args.host, port=args.port, block=False)


def stop(server: ApiServer) -> None:
    server.shutdown()
    server.server_close()
    if server.state.scheduler is not None:
        server.state.scheduler.close()


def main(argv=None):
    import sys
    args = parse_args(list(sys.argv[1:] if argv is None else argv))
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    state = build_state(args)
    try:
        serve(state, host=args.host, port=args.port)
    finally:
        if state.scheduler is not None:
            state.scheduler.close()


if __name__ == "__main__":
    main()
