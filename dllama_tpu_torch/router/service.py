"""Router HTTP service: OpenAI-surface proxy over the replica registry —
a copy of ``dllama_tpu/router/service.py``.

One ``ThreadingHTTPServer`` (stdlib only — the router carries no model,
no tokenizer, no device) that fronts N API-server replicas
(``python -m dllama_tpu_torch.server.api``, or the JAX package's: the
wire is the same):

* ``POST /v1/completions`` and ``/v1/chat/completions`` dispatch to the
  least-loaded healthy replica (:mod:`.registry`), stamping
  ``X-Request-Id`` (the fleet-wide correlation id — the replica's
  flight record and hand-off record both key on it) and
  ``X-Dllama-Hop`` (this router's instance id) on the upstream hop.
* A backend that fails **before any response bytes were forwarded** is
  retried on another replica — the request was idempotent up to that
  point.  A backend that dies **mid-stream** is transparently resumed
  on a peer when the request is greedy (``temperature: 0``) and
  streaming: tier 1 imports the latest proactive DLREQ01 checkpoint
  (``--checkpoint-interval``), tier 2 replays the request and swallows
  the regenerated prefix, verified char-by-char — the client's bytes
  are identical to an uninterrupted run.  Sampled requests (no
  determinism to lean on) and ``resume_policy: "never"`` keep the
  honest ``finish_reason="replica_lost"`` chunk: the truncation is
  flagged, never silent.  A stream that goes *silent* without the
  socket dying (``--stall-timeout``) is treated the same way, and the
  wedged replica is force-ejected.
* A replica that begins draining finishes each in-flight scheduler
  request with the internal ``finish_reason="handoff"``.  The router
  intercepts it (never forwarded), fetches the request's DLREQ01 record
  from ``/admin/export/<rid>``, offers it to geometry-compatible peers
  via ``/admin/import?emitted_chars=N``, and splices the peer's
  continuation into the client's still-open stream — the client sees
  one seamless completion across the replica move.  A request that had
  produced no client-visible bytes yet (e.g. it was still queued) falls
  back to a plain full retry.
* ``GET /health`` is the fleet aggregate, ``/metrics`` the router's own
  registry (router_* families; ``?scope=fleet`` federates every
  replica's), ``/debug/requests`` the router-side flight ring.

* ``POST /admin/scale?n=N`` and ``/admin/reshape?tp=N`` hand a command to
  the elastic pod's controller (``serve-pod --supervise --elastic``,
  :mod:`.elastic`): 202 with the accepted target, 400 on a bad argument,
  404 on a router without a controller.
"""

from __future__ import annotations

import http.client
import json
import re
import signal
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs

from ..obs import events as obs_events, flight as obs_flight, \
    metrics as obs_metrics, trace as obs_trace
from ..obs.log import get_logger, set_request_id
from ..runtime.snapshot import RecordStore
from ..server.backoff import jittered_retry_after
from .fleet import FleetScraper
from .registry import Backend, Registry

_log = get_logger("router.service")

_RID_RE = re.compile(r"[^A-Za-z0-9._-]")
_RID_MAX = 64
MAX_BODY_BYTES = 1 << 20
_PRIORITIES = ("interactive", "standard", "batch")


def _iter_sse(resp):
    """Yield the payload of each ``data:`` line from an SSE response.

    Our servers emit exactly one ``data: ...`` line per event, so
    per-line is per-event; blank separator lines are skipped."""
    while True:
        line = resp.readline()
        if not line:
            return
        line = line.rstrip(b"\r\n")
        if line.startswith(b"data: "):
            yield line[len(b"data: "):]


def _evt_fields(evt: dict, chat: bool) -> tuple[str, str | None]:
    """(delta_text, finish_reason) of one upstream SSE event."""
    choice = (evt.get("choices") or [{}])[0]
    if chat:
        text = (choice.get("delta") or {}).get("content") or ""
    else:
        text = choice.get("text") or ""
    return text, choice.get("finish_reason")


class RouterState:
    def __init__(self, registry: Registry, *, retries: int = 2,
                 upstream_timeout: float = 120.0,
                 model_name: str = "fleet",
                 stall_timeout: float = 0.0,
                 checkpoint_interval: float = 0.0,
                 resume_policy: str = "auto",
                 resume_window: float = 10.0,
                 fleet_scope_default: bool = False):
        self.registry = registry
        self.retries = max(0, int(retries))
        self.upstream_timeout = float(upstream_timeout)
        self.model_name = model_name
        # ---- crash tolerance (mid-stream resume) ----------------------
        # stall_timeout: per-read socket timeout on an open upstream
        # stream — a connected-but-silent replica (SIGSTOP, device hang)
        # is treated as dead after this window.  checkpoint_interval:
        # how often the background poller snapshots each greedy stream's
        # slot via GET /admin/checkpoint/<rid>; 0 disables.  Cached
        # checkpoints expire after 4 intervals (min 30 s) — a crashed
        # request's record must not outlive its usefulness.
        self.stall_timeout = max(0.0, float(stall_timeout))
        self.checkpoint_interval = max(0.0, float(checkpoint_interval))
        self.resume_policy = resume_policy \
            if resume_policy in ("auto", "never") else "auto"
        # resume_window: how long a resume keeps trying before the
        # honest replica_lost — the natural peer is often seconds away
        # (mid-readmission after a respawn, or momentarily saturated),
        # and a resume that gives up in milliseconds wastes the ladder
        self.resume_window = max(0.0, float(resume_window))
        self.checkpoints = RecordStore(
            ttl=max(4.0 * self.checkpoint_interval, 30.0)
            if self.checkpoint_interval > 0 else 0.0)
        self._streams_lock = threading.Lock()
        self._streams: dict[str, Backend] = {}
        # hop id: correlates every replica-side flight record this
        # router created (X-Dllama-Hop) with this process
        self.hop = f"router-{uuid.uuid4().hex[:8]}"
        self.started_at = time.time()
        # elastic pod controller (router/elastic.py), wired by
        # serve-pod --supervise --elastic; None → /admin/scale 404s
        self.elastic = None
        # fleet federation (router/fleet.py): /metrics?scope=fleet
        # scrapes every registered replica and re-exposes everything
        # with a replica label; serve-pod makes fleet the default scope
        # (its replicas sit on loopback ephemeral ports — the pod's
        # public port is the only scrapeable surface)
        self.fleet = FleetScraper(registry)
        self.fleet_scope_default = bool(fleet_scope_default)

    def connect(self, b: Backend) -> http.client.HTTPConnection:
        return http.client.HTTPConnection(b.host, b.port,
                                          timeout=self.upstream_timeout)

    # -- checkpoint targets (greedy in-flight streams) ------------------
    def track_stream(self, rid: str, b: Backend) -> None:
        with self._streams_lock:
            self._streams[rid] = b

    def untrack_stream(self, rid: str) -> None:
        with self._streams_lock:
            self._streams.pop(rid, None)
        self.checkpoints.discard(rid)

    def checkpoint_targets(self) -> list[tuple[str, Backend]]:
        with self._streams_lock:
            return list(self._streams.items())

    def health(self) -> dict:
        snap = self.registry.snapshot()
        out = {
            "status": "ok" if snap["available"] else "unavailable",
            "ready": snap["available"] > 0,
            "role": "router",
            "hop": self.hop,
            "model": self.model_name,
            "uptime_s": round(time.time() - self.started_at, 3),
            **snap,
        }
        if self.elastic is not None:
            out["fleet"] = self.elastic.fleet_status()
        return out


class _Ctx:
    """Per-request forwarding state shared across dispatch attempts."""

    def __init__(self):
        self.chars = 0            # completion-text chars forwarded
        self.text = ""            # the forwarded completion text itself
        #                           (the byte-parity oracle for resume)
        self.headers_sent = False  # client SSE headers committed
        self.client_gone = False
        self.finished = False      # a finish_reason reached the client
        self.busy = None           # last (status, body, retry_after)
        self.cid = None            # id/model/created of the first
        self.model = None          # upstream chunk — reused when the
        self.created = None        # router must fabricate chunks


def make_handler(state: RouterState):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        server_version = "dllama-router"

        def log_message(self, fmt, *args):  # route through our logger
            _log.debug("%s " + fmt, self.client_address[0], *args)

        # -- plumbing --------------------------------------------------
        def _json(self, code: int, obj: dict, headers=()) -> None:
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.send_header("X-Request-Id", getattr(self, "_rid", "") or "")
            if getattr(self, "_trace", None):
                self.send_header("X-Dllama-Trace", self._trace)
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            try:
                self.wfile.write(data)
            except OSError:
                pass

        def _relay(self, code: int, data: bytes, ctype: str | None,
                   headers=()) -> None:
            self.send_response(code)
            self.send_header("Content-Type",
                             ctype or "application/octet-stream")
            self.send_header("Content-Length", str(len(data)))
            self.send_header("X-Request-Id", getattr(self, "_rid", "") or "")
            if getattr(self, "_trace", None):
                self.send_header("X-Dllama-Trace", self._trace)
            for k, v in headers:
                if v:
                    self.send_header(k, v)
            self.end_headers()
            try:
                self.wfile.write(data)
            except OSError:
                pass

        def _sse_headers(self, ctx: _Ctx) -> None:
            if ctx.headers_sent:
                return
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.send_header("X-Request-Id", self._rid)
            if getattr(self, "_trace", None):
                self.send_header("X-Dllama-Trace", self._trace)
            self.end_headers()
            ctx.headers_sent = True

        def _client_event(self, ctx: _Ctx, payload: bytes) -> bool:
            if ctx.client_gone:
                return False
            try:
                self.wfile.write(b"data: " + payload + b"\n\n")
                self.wfile.flush()
                return True
            except OSError:
                ctx.client_gone = True
                return False

        def _client_chunk(self, ctx: _Ctx, chat: bool, text: str,
                          finish: str | None) -> None:
            """Fabricate a chunk in the client's endpoint shape (used
            for hand-off continuations and replica_lost finishes)."""
            if chat:
                if text:
                    self._client_event(ctx, json.dumps({
                        "id": ctx.cid, "object": "chat.completion.chunk",
                        "created": ctx.created, "model": ctx.model,
                        "choices": [{"index": 0,
                                     "delta": {"content": text},
                                     "finish_reason": None}]}).encode())
                if finish is not None:
                    self._client_event(ctx, json.dumps({
                        "id": ctx.cid, "object": "chat.completion.chunk",
                        "created": ctx.created, "model": ctx.model,
                        "choices": [{"index": 0, "delta": {},
                                     "finish_reason": finish}]}).encode())
            else:
                self._client_event(ctx, json.dumps({
                    "id": ctx.cid, "object": "text_completion",
                    "created": ctx.created, "model": ctx.model,
                    "choices": [{"text": text, "index": 0,
                                 "finish_reason": finish,
                                 "logprobs": None}]}).encode())
            if text:
                ctx.chars += len(text)
                ctx.text += text
            if finish is not None:
                ctx.finished = True

        # -- GET surface -----------------------------------------------
        def do_GET(self):
            self._rid = _RID_RE.sub(
                "", self.headers.get("X-Request-Id") or "")[:_RID_MAX] \
                or uuid.uuid4().hex[:16]
            path, _, query = self.path.partition("?")
            if path in ("/health", "/healthz"):
                self._json(200, state.health())
            elif path == "/metrics":
                q = parse_qs(query)
                accept = self.headers.get("Accept") or ""
                prom = (q.get("format", [""])[0] == "prometheus"
                        or "text/plain" in accept or "openmetrics" in accept)
                scope = q.get("scope", [""])[0] or (
                    "fleet" if state.fleet_scope_default else "self")
                if scope not in ("fleet", "self"):
                    self._json(400, {"error": f"unknown scope {scope!r}; "
                                              "expected fleet|self"})
                    return
                if prom:
                    text = state.fleet.federated_prometheus() \
                        if scope == "fleet" \
                        else obs_metrics.render_prometheus()
                    data = text.encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "text/plain; version=0.0.4; charset=utf-8")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                elif scope == "fleet":
                    self._json(200, state.fleet.federated_json())
                else:
                    self._json(200, obs_metrics.snapshot_json())
            elif path == "/debug/trace":
                # scope=fleet stitches every replica's span ring (plus
                # the router's own) into one wall-clock-aligned Perfetto
                # timeline with journal markers; ?trace=<id> narrows to
                # one request's fleet-wide story.  Default scope is the
                # router's own ring, same contract as a replica's.
                qs = parse_qs(query)
                scope = qs.get("scope", [""])[0]
                if scope == "fleet":
                    self._json(200, state.fleet.fleet_trace(
                        trace=qs.get("trace", [None])[0]))
                    return
                if "since" in qs:
                    try:
                        since = int(qs["since"][0])
                    except ValueError:
                        since = 0
                    self._json(200, obs_trace.raw(since))
                    return
                try:
                    last = int(qs["last"][0]) if "last" in qs else 20
                except ValueError:
                    last = 20
                self._json(200, obs_trace.trace_json(last))
            elif path == "/debug/events":
                # the pod event journal (spawn/death/respawn/quarantine/
                # eject/readmit/scale/reshape live here in the router
                # process); ?since=<seq> tails incrementally,
                # ?scope=fleet folds in every replica's journal too
                qs = parse_qs(query)
                since = None
                if "since" in qs:
                    try:
                        since = int(qs["since"][0])
                    except ValueError:
                        since = 0
                if qs.get("scope", [""])[0] == "fleet":
                    self._json(200, state.fleet.fleet_events(since))
                else:
                    self._json(200, obs_events.snapshot(since))
            elif path == "/debug/requests":
                try:
                    n = int(q[0]) if (q := parse_qs(query).get("n")) else 50
                except ValueError:
                    n = 50
                self._json(200, {"requests": obs_flight.recent(n)})
            elif path.startswith("/debug/requests/"):
                rid = path[len("/debug/requests/"):]
                rec = obs_flight.get(rid)
                if rec is None:
                    self._json(404, {"error": f"no flight record for "
                                              f"request id {rid!r}"})
                else:
                    self._json(200, rec)
            elif path == "/v1/models":
                self._proxy_models()
            else:
                self._json(404, {"error": f"unknown path {path}"})

        def _admin_elastic(self, path, query):
            """Elastic pod control surface: ``POST /admin/scale?n=N``
            and ``POST /admin/reshape?tp=N``.  Commands are accepted
            (202) and executed asynchronously on the controller
            thread; convergence is observable through the ``fleet``
            block in ``/health``."""
            ctl = state.elastic
            if ctl is None:
                self._json(404, {"error": "this router has no elastic "
                                          "controller (run serve-pod "
                                          "--supervise --elastic)"})
                return
            q = parse_qs(query)
            try:
                if path == "/admin/scale":
                    if "n" not in q:
                        raise ValueError("scale needs ?n=<replicas>")
                    out = ctl.request_scale(int(q["n"][0]))
                else:
                    if "tp" not in q:
                        raise ValueError("reshape needs ?tp=<degree>")
                    out = ctl.request_reshape(int(q["tp"][0]))
            except ValueError as e:
                self._json(400, {"error": f"bad elastic command: {e}"})
                return
            self._json(202, out)

        def _proxy_models(self):
            b = state.registry.pick()
            if b is None:
                self._json(503, {"error": "no backend available"},
                           headers=[("Retry-After",
                                     jittered_retry_after(5))])
                return
            try:
                conn = state.connect(b)
                try:
                    conn.request("GET", "/v1/models")
                    resp = conn.getresponse()
                    data = resp.read()
                    self._relay(resp.status, data,
                                resp.getheader("Content-Type"))
                finally:
                    conn.close()
            except OSError:
                state.registry.record_failure(b)
                self._json(502, {"error": f"backend {b.addr} unreachable"})

        # -- POST surface ----------------------------------------------
        def do_POST(self):
            path, _, query = self.path.partition("?")
            if path in ("/admin/scale", "/admin/reshape"):
                self._admin_elastic(path, query)
                return
            if path not in ("/v1/completions", "/v1/chat/completions"):
                self._json(404, {"error": f"unknown path {path}"})
                return
            try:
                length = int(self.headers.get("Content-Length") or 0)
            except ValueError:
                self._json(400, {"error": "bad Content-Length"})
                return
            if length <= 0:
                self._json(400, {"error": "request body required"})
                return
            if length > MAX_BODY_BYTES:
                self._json(413, {"error": "request body too large"})
                return
            try:
                raw = self.rfile.read(length)
            except OSError:
                return
            try:
                body = json.loads(raw)
            except ValueError as e:
                self._json(400, {"error": f"bad JSON: {e}"})
                return
            self._rid = _RID_RE.sub(
                "", self.headers.get("X-Request-Id") or "")[:_RID_MAX] \
                or uuid.uuid4().hex[:16]
            set_request_id(self._rid)
            # fleet trace context: adopt the client's X-Dllama-Trace or
            # mint one here at the fleet edge.  Propagated on every
            # upstream hop and carried inside DLREQ01 records, so a
            # request that is handed off / resumed between replicas is
            # ONE trace id across every process's span ring.
            self._trace = obs_trace.sanitize_trace_id(
                self.headers.get("X-Dllama-Trace")) \
                or obs_trace.new_trace_id()
            obs_trace.set_trace(self._rid, self._trace)
            # QoS class rides alongside X-Request-Id: body field wins
            # over the header; unknown values degrade to None (the
            # replica applies its own default/validation)
            prio = body.get("priority") \
                or self.headers.get("X-Dllama-Priority")
            prio = str(prio).strip().lower() if prio is not None else None
            self._prio = prio if prio in _PRIORITIES else None
            # resume_policy is a ROUTER contract, never forwarded: with
            # "auto" (the default) a greedy stream whose replica dies
            # mid-decode is transparently resumed on a peer; "never"
            # keeps today's honest finish_reason="replica_lost"
            resume = body.pop("resume_policy", None)
            if resume is not None:
                resume = str(resume).strip().lower()
                if resume not in ("auto", "never"):
                    self._json(400, {
                        "error": f"unknown resume_policy {resume!r}; "
                                 "expected auto|never"})
                    return
                raw = json.dumps(body).encode()
            self._resume_policy = resume
            # the byte-parity resume guarantee only exists for greedy
            # decode (the house invariant); sampled requests are never
            # silently regenerated
            self._greedy = body.get("temperature") == 0
            self._proxy_completion(path, raw, body)

        def _proxy_completion(self, path: str, raw: bytes,
                              body: dict) -> None:
            chat = path == "/v1/chat/completions"
            stream = bool(body.get("stream"))
            rid = self._rid
            obs_flight.submit(rid, path=path, stream=stream, hop=state.hop,
                              priority=self._prio)
            ctx = _Ctx()
            tried: list[Backend] = []
            retries_left = state.retries
            # the checkpoint poller only follows greedy streams: those
            # are the only ones the resume ladder may replay, so
            # checkpointing anything else would be wasted /admin work
            track = (stream and getattr(self, "_greedy", False)
                     and state.checkpoint_interval > 0)
            try:
                while True:
                    b = state.registry.pick(exclude=tried,
                                            priority=self._prio)
                    if b is None:
                        self._out_of_backends(ctx, chat, rid)
                        return
                    tried.append(b)
                    obs_flight.phase(rid, "dispatch", backend=b.addr)
                    obs_metrics.ROUTER_DISPATCH.inc(b.addr)
                    if track:
                        state.track_stream(rid, b)
                    state.registry.acquire(b)
                    try:
                        verdict = self._attempt(b, path, raw, chat,
                                                stream, rid, ctx)
                    finally:
                        state.registry.release(b)
                    if verdict == "done":
                        obs_flight.retire(rid, reason="done",
                                          backend=b.addr)
                        return
                    if verdict == "busy":
                        continue  # not a failure; try the next replica
                    if verdict == "lost":
                        self._handle_lost(b, path, raw, chat, stream,
                                          rid, ctx, tried)
                        return
                    # verdict == "retry": nothing client-visible
                    # happened — the request is still idempotent
                    if retries_left <= 0:
                        self._out_of_backends(ctx, chat, rid)
                        return
                    retries_left -= 1
                    obs_metrics.ROUTER_RETRIES.inc()
                    obs_flight.phase(rid, "retry", backend=b.addr)
            finally:
                if track:
                    state.untrack_stream(rid)

        def _out_of_backends(self, ctx: _Ctx, chat: bool,
                             rid: str) -> None:
            """No replica can take (or finish) this request."""
            if ctx.headers_sent:
                self._finish_replica_lost(ctx, chat, rid)
                return
            if ctx.busy is not None:
                status, data, retry_after = ctx.busy
                self._relay(status, data, "application/json",
                            headers=[("Retry-After", retry_after)])
                obs_flight.retire(rid, reason=f"busy_{status}")
                return
            self._json(503, {"error": "no backend available"},
                       headers=[("Retry-After", jittered_retry_after(5))])
            obs_flight.retire(rid, reason="no_backend")

        def _finish_replica_lost(self, ctx: _Ctx, chat: bool,
                                 rid: str) -> None:
            """End a stream that already carried content: flag the
            truncation instead of silently closing the socket."""
            obs_metrics.ROUTER_REPLICA_LOST.inc()
            if ctx.headers_sent and not ctx.client_gone:
                self._client_chunk(ctx, chat, "", "replica_lost")
                self._client_event(ctx, b"[DONE]")
            elif not ctx.headers_sent:
                # non-stream request whose backend vanished after the
                # retry budget: a 502 is the honest answer
                self._json(502, {"error": "backend lost mid-request",
                                 "finish_reason": "replica_lost"})
            obs_flight.retire(rid, reason="replica_lost")

        # -- mid-stream resume (crash tolerance) -----------------------
        def _handle_lost(self, dead: Backend, path: str, raw: bytes,
                         chat: bool, stream: bool, rid: str, ctx: _Ctx,
                         tried: list[Backend]) -> None:
            """A backend died after forwarding content.  For a greedy
            stream under ``resume_policy=auto`` the router resumes on a
            peer instead of truncating: tier 1 imports the most recent
            DLREQ01 checkpoint (KV intact — no re-prefill), tier 2
            replays the original request and swallows the regenerated
            prefix (greedy decode is deterministic, so the peer
            re-produces byte-identical text — verified char by char).
            Anything non-greedy, non-stream, or opted out keeps the
            honest ``finish_reason="replica_lost"``.
            """
            policy = getattr(self, "_resume_policy", None) \
                or state.resume_policy
            resumable = (stream and ctx.headers_sent
                         and not ctx.client_gone and not ctx.finished
                         and policy == "auto"
                         and getattr(self, "_greedy", False))
            if not resumable:
                self._finish_replica_lost(ctx, chat, rid)
                return
            obs_flight.phase(rid, "resume", backend=dead.addr,
                             chars=ctx.chars)
            record = state.checkpoints.pop(rid)
            if record is not None:
                got = self._offer_record(record, ctx.chars,
                                         exclude=set(tried))
                if got is not None:
                    peer, resp, conn = got
                    obs_flight.phase(rid, "resume_checkpoint",
                                     backend=peer.addr)
                    try:
                        verdict = self._relay_continuation(
                            peer, resp, chat, rid, ctx)
                    finally:
                        conn.close()
                    if verdict == "done":
                        obs_metrics.ROUTER_RESUMES.inc("checkpoint")
                        obs_flight.retire(rid, reason="resumed",
                                          backend=peer.addr)
                        obs_events.emit(
                            "resume", rid=rid, tier="checkpoint",
                            src=dead.addr, dst=peer.addr,
                            trace=getattr(self, "_trace", None))
                        return
                    # the continuation died too — fall through to the
                    # re-run tier; ctx.text still covers every char the
                    # client has seen, so the prefix oracle holds
            verdict = self._resume_rerun(path, raw, chat, rid, ctx,
                                         tried)
            if verdict == "done":
                obs_metrics.ROUTER_RESUMES.inc("rerun")
                obs_flight.retire(rid, reason="resumed")
                obs_events.emit("resume", rid=rid, tier="rerun",
                                src=dead.addr,
                                trace=getattr(self, "_trace", None))
                return
            obs_metrics.ROUTER_RESUMES.inc(verdict)
            self._finish_replica_lost(ctx, chat, rid)

        def _resume_rerun(self, path: str, raw: bytes, chat: bool,
                          rid: str, ctx: _Ctx,
                          tried: list[Backend]) -> str:
            """Tier-2 resume: replay the ORIGINAL request on up to
            ``retries+1`` fresh peers per round, for up to
            ``resume_window`` seconds.  Returns ``done`` on a spliced
            finish, ``mismatch`` on prefix divergence, ``failed`` on a
            replica-side error event, ``no_peer`` when the window
            closes with the fleet still exhausted.

            The window (not a single pass) is the point: right after a
            crash the best peer is often seconds away — the victim's
            replacement mid-readmission, or the survivor riding out a
            saturation burst (429 → ``retry``) — and truncating the
            client over a transient costs the whole resume.  Round one
            excludes the backends the request already died on; later
            rounds trust the registry's live ejection state instead, so
            a respawned victim becomes eligible the moment it is
            re-admitted."""
            deadline = time.monotonic() + state.resume_window
            first_round = True
            while True:
                round_tried = list(tried) if first_round else []
                for _ in range(state.retries + 1):
                    b = state.registry.pick(
                        exclude=round_tried,
                        priority=getattr(self, "_prio", None))
                    if b is None:
                        break
                    round_tried.append(b)
                    obs_flight.phase(rid, "resume_rerun",
                                     backend=b.addr)
                    state.registry.acquire(b)
                    try:
                        verdict = self._rerun_attempt(b, path, raw,
                                                      chat, rid, ctx)
                    finally:
                        state.registry.release(b)
                    if verdict != "retry":
                        return verdict
                first_round = False
                if time.monotonic() >= deadline:
                    return "no_peer"
                time.sleep(0.5)

        def _rerun_attempt(self, b: Backend, path: str, raw: bytes,
                           chat: bool, rid: str, ctx: _Ctx) -> str:
            """One re-run on one peer: swallow the regenerated prefix
            (comparing against ``ctx.text`` — any divergence aborts the
            splice), then forward the remainder into the client's open
            stream as if it never broke."""
            try:
                conn = state.connect(b)
            except OSError:
                state.registry.record_failure(b)
                return "retry"
            try:
                try:
                    headers = {"Content-Type": "application/json",
                               "X-Request-Id": rid,
                               "X-Dllama-Hop": state.hop}
                    if getattr(self, "_trace", None):
                        headers["X-Dllama-Trace"] = self._trace
                    if getattr(self, "_prio", None):
                        headers["X-Dllama-Priority"] = self._prio
                    conn.request("POST", path, raw, headers=headers)
                    if state.stall_timeout > 0 and conn.sock is not None:
                        # armed before getresponse: a close-delimited
                        # response nulls conn.sock (see _attempt)
                        conn.sock.settimeout(state.stall_timeout)
                    resp = conn.getresponse()
                except OSError:
                    state.registry.record_failure(b)
                    return "retry"
                if resp.status != 200 or "text/event-stream" not in (
                        resp.getheader("Content-Type") or ""):
                    resp.read()
                    return "retry"
                prefix = ctx.text
                pos = 0  # chars of the prefix re-verified so far
                try:
                    for payload in _iter_sse(resp):
                        if payload == b"[DONE]":
                            state.registry.record_success(b)
                            if ctx.finished:
                                self._client_event(ctx, b"[DONE]")
                                return "done"
                            return "retry"
                        try:
                            evt = json.loads(payload)
                        except ValueError:
                            continue
                        if "error" in evt:
                            # deterministic server-side error: a third
                            # peer would hit it too — stop here
                            return "failed"
                        text, finish = _evt_fields(evt, chat)
                        if finish == "handoff":
                            # the peer began draining mid-re-run: chase
                            # its record; emitted_chars=ctx.chars makes
                            # the importer absorb whatever prefix was
                            # still unregenerated
                            got = self._handoff(b, rid, chat, ctx,
                                                stream=True)
                            return "done" if got == "done" else "failed"
                        if pos < len(prefix):
                            k = min(len(text), len(prefix) - pos)
                            if text[:k] != prefix[pos:pos + k]:
                                _log.warning(
                                    "resume prefix mismatch at char %d "
                                    "on %s (request %s): re-run is not "
                                    "byte-identical; aborting splice",
                                    pos, b.addr, rid)
                                return "mismatch"
                            pos += k
                            text = text[k:]
                        if finish is not None and pos < len(prefix):
                            # finished before regenerating everything
                            # the client already saw — divergence
                            return "mismatch"
                        if text or finish is not None:
                            self._client_chunk(ctx, chat, text, finish)
                            if ctx.client_gone:
                                return "done"
                except TimeoutError:
                    obs_metrics.ROUTER_STALLS.inc()
                    state.registry.force_eject(
                        b, "stream stall (--stall-timeout)")
                except (OSError, http.client.HTTPException):
                    state.registry.record_failure(b)
                if ctx.finished:
                    self._client_event(ctx, b"[DONE]")
                    return "done"
                # the re-run died mid-way; ctx.text grew to cover all
                # forwarded chars, so another peer can pick up the
                # (longer) prefix — still a clean retry
                return "retry"
            finally:
                conn.close()

        def _attempt(self, b: Backend, path: str, raw: bytes, chat: bool,
                     stream: bool, rid: str, ctx: _Ctx) -> str:
            """One dispatch to one backend.  Returns a verdict:
            ``done`` (response fully relayed), ``busy`` (replica said
            429/503 — try a sibling), ``retry`` (backend failed with
            nothing forwarded), ``lost`` (failed after content)."""
            try:
                conn = state.connect(b)
            except OSError:
                state.registry.record_failure(b)
                return "retry"
            try:
                try:
                    headers = {"Content-Type": "application/json",
                               "X-Request-Id": rid,
                               "X-Dllama-Hop": state.hop}
                    if getattr(self, "_trace", None):
                        headers["X-Dllama-Trace"] = self._trace
                    if getattr(self, "_prio", None):
                        headers["X-Dllama-Priority"] = self._prio
                    conn.request("POST", path, raw, headers=headers)
                    if stream and state.stall_timeout > 0 \
                            and conn.sock is not None:
                        # per-read deadline on the stream: a replica that
                        # is connected but silent (SIGSTOP, device hang)
                        # trips TimeoutError in _relay_stream and is
                        # treated as dead.  Armed BEFORE getresponse —
                        # a close-delimited response nulls conn.sock
                        # when the headers land — so it also bounds
                        # time-to-first-token (queue + prefill + compile
                        # all count) and the flag must exceed worst-case
                        # cold-start (the kernels' first build included).
                        conn.sock.settimeout(state.stall_timeout)
                    resp = conn.getresponse()
                except OSError:
                    state.registry.record_failure(b)
                    return "retry"
                if resp.status in (429, 503):
                    ctx.busy = (resp.status, resp.read(),
                                resp.getheader("Retry-After") or "5")
                    return "busy"
                if resp.status != 200:
                    # a client error is between the client and the model
                    # server — relay it verbatim, no retry
                    self._relay(resp.status, resp.read(),
                                resp.getheader("Content-Type"))
                    state.registry.record_success(b)
                    obs_flight.phase(rid, "relay_error",
                                     status=resp.status)
                    return "done"
                if "text/event-stream" in (resp.getheader("Content-Type")
                                           or ""):
                    return self._relay_stream(b, resp, chat, rid, ctx)
                try:
                    data = resp.read()
                except OSError:
                    state.registry.record_failure(b)
                    return "retry"
                state.registry.record_success(b)
                return self._relay_json(b, data, chat, rid, ctx)
            finally:
                conn.close()

        def _relay_stream(self, b: Backend, resp, chat: bool, rid: str,
                          ctx: _Ctx) -> str:
            self._sse_headers(ctx)
            try:
                for payload in _iter_sse(resp):
                    if payload == b"[DONE]":
                        state.registry.record_success(b)
                        self._client_event(ctx, b"[DONE]")
                        return "done"
                    try:
                        evt = json.loads(payload)
                    except ValueError:
                        continue
                    if "error" in evt:
                        # replica-side server error mid-stream: relay it
                        # and the DONE that follows; no retry (the
                        # replica is alive and already answered)
                        self._client_event(ctx, payload)
                        ctx.finished = True
                        continue
                    if ctx.cid is None:
                        ctx.cid = evt.get("id")
                        ctx.model = evt.get("model")
                        ctx.created = evt.get("created")
                    text, finish = _evt_fields(evt, chat)
                    if finish == "handoff":
                        # internal signal — never forwarded.  The held-
                        # back text riding this chunk is NOT forwarded
                        # either: the importer re-emits everything past
                        # ctx.chars, so dropping it here keeps the
                        # client's stream gapless and duplicate-free.
                        return self._handoff(b, rid, chat, ctx,
                                             stream=True)
                    if not self._client_event(ctx, payload):
                        return "done"  # client gone; nothing to salvage
                    ctx.chars += len(text)
                    ctx.text += text
                    if finish is not None:
                        ctx.finished = True
            except TimeoutError:
                # TimeoutError precedes the OSError catch (it IS an
                # OSError since 3.10): a stalled read is a wedged-but-
                # connected replica, which a failure streak would never
                # eject (its /health may still answer) — force it out.
                obs_metrics.ROUTER_STALLS.inc()
                state.registry.force_eject(
                    b, "stream stall (--stall-timeout)")
                obs_flight.phase(rid, "stream_stall", backend=b.addr)
                if ctx.finished:
                    self._client_event(ctx, b"[DONE]")
                    return "done"
                return "retry" if ctx.chars == 0 else "lost"
            except (OSError, http.client.HTTPException):
                pass
            # upstream socket died (or closed without [DONE])
            state.registry.record_failure(b)
            if ctx.finished:
                # the finish chunk made it out; only [DONE] was lost
                self._client_event(ctx, b"[DONE]")
                return "done"
            return "retry" if ctx.chars == 0 else "lost"

        def _relay_json(self, b: Backend, data: bytes, chat: bool,
                        rid: str, ctx: _Ctx) -> str:
            try:
                obj = json.loads(data)
                choice = (obj.get("choices") or [{}])[0]
                finish = choice.get("finish_reason")
            except (ValueError, AttributeError):
                self._relay(200, data, "application/json")
                return "done"
            if finish != "handoff":
                self._relay(200, data, "application/json")
                return "done"
            # the replica drained mid-request: the buffered JSON holds a
            # partial completion.  Resume on a peer and splice.
            partial = (choice.get("message") or {}).get("content", "") \
                if chat else choice.get("text", "")
            cont = self._handoff_collect(b, rid, len(partial))
            if cont is None:
                if not partial:
                    return "retry"  # nothing to lose: full re-run
                obs_metrics.ROUTER_REPLICA_LOST.inc()
                self._patch_json(obj, chat, partial, "replica_lost", None)
                self._relay(200, json.dumps(obj).encode(),
                            "application/json")
                obs_flight.retire(rid, reason="replica_lost")
                return "done"
            tail, cont_finish, completion_tokens = cont
            if chat and cont_finish == "length":
                cont_finish = "stop"  # the chat budget contract
            self._patch_json(obj, chat, partial + tail, cont_finish,
                             completion_tokens)
            self._relay(200, json.dumps(obj).encode(), "application/json")
            return "done"

        @staticmethod
        def _patch_json(obj: dict, chat: bool, text: str,
                        finish: str, completion_tokens: int | None) -> None:
            choice = obj["choices"][0]
            choice["finish_reason"] = finish
            if chat:
                choice.setdefault("message", {})["content"] = text
            else:
                choice["text"] = text
            usage = obj.get("usage")
            if usage and completion_tokens is not None:
                usage["completion_tokens"] = completion_tokens
                usage["total_tokens"] = \
                    usage.get("prompt_tokens", 0) + completion_tokens

        # -- KV hand-off -----------------------------------------------
        def _fetch_record(self, b: Backend, rid: str) -> bytes | None:
            try:
                conn = state.connect(b)
                try:
                    conn.request("GET", f"/admin/export/{rid}")
                    resp = conn.getresponse()
                    data = resp.read()
                    return data if resp.status == 200 else None
                finally:
                    conn.close()
            except OSError:
                return None

        def _offer_record(self, record: bytes, emitted_chars: int,
                          exclude) -> tuple[Backend, object, object] | None:
            """POST the record to peers best-first; returns the open
            ``(peer, response, connection)`` of the accepting one."""
            for peer in state.registry.handoff_peers(exclude=exclude):
                try:
                    conn = state.connect(peer)
                    conn.request(
                        "POST",
                        f"/admin/import?emitted_chars={emitted_chars}",
                        record,
                        headers={"Content-Type":
                                 "application/octet-stream"})
                    resp = conn.getresponse()
                except OSError:
                    state.registry.record_failure(peer)
                    continue
                if resp.status == 200:
                    return peer, resp, conn
                body = resp.read()
                conn.close()
                if resp.status == 409:
                    _log.info("peer %s refused hand-off (geometry): %s",
                              peer.addr, body[:200])
                    continue  # incompatible shape — a sibling may fit
                if resp.status in (429, 503):
                    continue  # saturated/draining — try the next peer
                # 400 = the record itself is bad; no peer will differ
                _log.warning("hand-off import rejected (%d): %s",
                             resp.status, body[:200])
                return None
            return None

        def _handoff(self, b: Backend, rid: str, chat: bool, ctx: _Ctx,
                     *, stream: bool) -> str:
            """Migrate an exported request to a peer and splice its
            continuation into the client's open stream."""
            obs_flight.phase(rid, "handoff", backend=b.addr,
                             emitted_chars=ctx.chars)
            record = self._fetch_record(b, rid)
            got = self._offer_record(record, ctx.chars, exclude={b}) \
                if record else None
            if got is None:
                # no record (request was still queued — nothing decoded)
                # or no peer could take it: retry from scratch if the
                # client saw nothing, else flag the truncation
                return "retry" if ctx.chars == 0 else "lost"
            peer, resp, conn = got
            obs_metrics.ROUTER_HANDOFFS.inc()
            obs_flight.phase(rid, "handoff_resume", backend=peer.addr)
            obs_events.emit("handoff", rid=rid, src=b.addr, dst=peer.addr,
                            chars=ctx.chars,
                            trace=getattr(self, "_trace", None))
            try:
                return self._relay_continuation(peer, resp, chat, rid,
                                                ctx)
            finally:
                conn.close()

        def _relay_continuation(self, peer: Backend, resp, chat: bool,
                                rid: str, ctx: _Ctx) -> str:
            """Forward a ``/admin/import`` continuation (always
            text_completion-shaped) re-wrapped in the client's endpoint
            shape, with the original stream's id/model/created."""
            try:
                for payload in _iter_sse(resp):
                    if payload == b"[DONE]":
                        state.registry.record_success(peer)
                        if not ctx.finished:
                            # error event upstream ended without finish
                            return "lost"
                        self._client_event(ctx, b"[DONE]")
                        return "done"
                    try:
                        evt = json.loads(payload)
                    except ValueError:
                        continue
                    if evt.get("object") == "handoff.usage" \
                            or "error" in evt:
                        continue
                    choice = (evt.get("choices") or [{}])[0]
                    text = choice.get("text") or ""
                    finish = choice.get("finish_reason")
                    if finish == "handoff":
                        # the peer started draining too — chase the
                        # record to the next replica (chained hand-off)
                        if text:
                            self._client_chunk(ctx, chat, text, None)
                        return self._handoff(peer, rid, chat, ctx,
                                             stream=True)
                    if chat and finish == "length":
                        finish = "stop"
                    self._client_chunk(ctx, chat, text, finish)
                    if ctx.client_gone:
                        return "done"
            except (OSError, http.client.HTTPException):
                pass
            state.registry.record_failure(peer)
            if ctx.finished:
                self._client_event(ctx, b"[DONE]")
                return "done"
            return "lost"  # the record was consumed; no second chance

        def _handoff_collect(self, b: Backend, rid: str,
                             emitted_chars: int
                             ) -> tuple[str, str, int | None] | None:
            """Non-streaming twin of :meth:`_handoff`: fetch + offer,
            then drain the continuation into ``(tail_text, finish,
            completion_tokens)``.  Follows chained hand-offs."""
            obs_flight.phase(rid, "handoff", backend=b.addr,
                             emitted_chars=emitted_chars)
            record = self._fetch_record(b, rid)
            got = self._offer_record(record, emitted_chars,
                                     exclude={b}) if record else None
            if got is None:
                return None
            peer, resp, conn = got
            obs_metrics.ROUTER_HANDOFFS.inc()
            obs_flight.phase(rid, "handoff_resume", backend=peer.addr)
            obs_events.emit("handoff", rid=rid, src=b.addr, dst=peer.addr,
                            chars=emitted_chars,
                            trace=getattr(self, "_trace", None))
            parts: list[str] = []
            finish = None
            completion_tokens = None
            try:
                for payload in _iter_sse(resp):
                    if payload == b"[DONE]":
                        break
                    try:
                        evt = json.loads(payload)
                    except ValueError:
                        continue
                    if evt.get("object") == "handoff.usage":
                        completion_tokens = (evt.get("usage") or {}) \
                            .get("completion_tokens")
                        continue
                    if "error" in evt:
                        return None
                    choice = (evt.get("choices") or [{}])[0]
                    parts.append(choice.get("text") or "")
                    finish = choice.get("finish_reason") or finish
            except (OSError, http.client.HTTPException):
                state.registry.record_failure(peer)
                return None
            finally:
                conn.close()
            if finish == "handoff":
                nxt = self._handoff_collect(
                    peer, rid, emitted_chars + sum(map(len, parts)))
                if nxt is None:
                    return None
                tail2, finish2, ct2 = nxt
                return "".join(parts) + tail2, finish2, ct2
            if finish is None:
                return None
            state.registry.record_success(peer)
            return "".join(parts), finish, completion_tokens

    return Handler


def _checkpoint_loop(state: RouterState, stop: threading.Event) -> None:
    """Proactive DLREQ01 checkpointing of in-flight greedy streams.

    Every ``checkpoint_interval`` seconds, snapshot each tracked
    stream's slot via ``GET /admin/checkpoint/<rid>`` on its current
    backend and cache the record.  When that backend later dies
    mid-stream, tier-1 resume imports the cached record on a peer —
    the request restarts from the checkpoint's KV state instead of
    re-prefilling the whole prompt (the win grows with context
    length).  A failed poll is skipped, never fatal: the stream it
    covers is still live and tier-2 re-run remains available."""
    while not stop.wait(state.checkpoint_interval):
        for rid, b in state.checkpoint_targets():
            try:
                # short deadline: one hung replica must not stall the
                # whole poll round for upstream_timeout
                conn = http.client.HTTPConnection(
                    b.host, b.port,
                    timeout=max(2.0, state.checkpoint_interval))
                try:
                    conn.request("GET", f"/admin/checkpoint/{rid}")
                    resp = conn.getresponse()
                    data = resp.read()
                finally:
                    conn.close()
            except OSError:
                continue
            if resp.status == 200 and data:
                state.checkpoints.put(rid, data)
        state.checkpoints.sweep()


def serve(state: RouterState, *, host: str = "0.0.0.0",
          port: int = 9990, block: bool = True) -> ThreadingHTTPServer:
    """Bind the router and start its probe and checkpoint threads.  With
    ``block`` it serves until SIGTERM/SIGINT; else it serves on a
    background thread and returns the server (``server_address`` has the
    bound port, ``port=0`` binds a free one; :func:`stop` ends it)."""
    httpd = ThreadingHTTPServer((host, port), make_handler(state))
    httpd.daemon_threads = True
    state.registry.start()
    ckpt_stop = threading.Event()
    ckpt_thread = None
    if state.checkpoint_interval > 0:
        ckpt_thread = threading.Thread(
            target=_checkpoint_loop, args=(state, ckpt_stop),
            name="router-checkpoint", daemon=True)
        ckpt_thread.start()

    def close():
        ckpt_stop.set()
        if ckpt_thread is not None:
            ckpt_thread.join(timeout=state.checkpoint_interval + 3.0)
        state.registry.stop()
        httpd.server_close()

    httpd.close_router = close
    bound = httpd.server_address[1]
    _log.info("router listening on %s:%d fronting %s", host, bound,
              ",".join(b.addr for b in state.registry.backends))
    print(f"💡 router on {host}:{bound} → "
          f"{len(state.registry.backends)} backends", flush=True)
    if not block:
        threading.Thread(target=httpd.serve_forever, name="router-http",
                         daemon=True).start()
        return httpd

    def _shutdown(signum, frame):
        _log.info("router signal %d: shutting down", signum)
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _shutdown)
    signal.signal(signal.SIGINT, _shutdown)
    try:
        httpd.serve_forever()
    finally:
        close()
    return httpd


def stop(httpd: ThreadingHTTPServer) -> None:
    """End a router :func:`serve` started with ``block=False``."""
    httpd.shutdown()
    httpd.close_router()


def main(args) -> None:
    addrs = [a.strip() for a in (getattr(args, "backends", None) or "")
             .split(",") if a.strip()]
    if not addrs:
        raise SystemExit("router mode requires --backends host:port,...")
    registry = Registry(
        addrs,
        probe_interval=getattr(args, "probe_interval", 2.0),
        eject_after=getattr(args, "eject_after", 3),
        readmit_after=getattr(args, "readmit_after", 2),
        probe_timeout=min(float(getattr(args, "upstream_timeout", 120.0)),
                          5.0))
    state = RouterState(
        registry,
        retries=getattr(args, "router_retries", 2),
        upstream_timeout=getattr(args, "upstream_timeout", 120.0),
        stall_timeout=getattr(args, "stall_timeout", 0.0),
        checkpoint_interval=getattr(args, "checkpoint_interval", 0.0),
        resume_policy=getattr(args, "resume_policy", "auto"))
    serve(state, host=getattr(args, "host", "0.0.0.0"),
          port=getattr(args, "port", 9990))
