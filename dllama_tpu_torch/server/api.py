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
* **the lockstep batch** (``--batch-slots`` over contiguous slot rows,
  ``--kv-pages 0``): a list ``prompt``, ``n > 1`` (completions and chat),
  ``logprobs`` (up to 5 alternatives a position) and ``echo`` run as one
  lockstep batch on the slot engine while the scheduler is parked;
  ``logprobs`` adds one teacher-forced scoring forward
  (``Engine.score_batch``).  With ``--kv-pages`` these answer 400, as the
  JAX server does.
* ``GET /v1/models``, ``GET /health`` (with the ``--slo`` verdict and the
  ``perf`` block of ``obs/cost.py``: MFU/MBU, modelled work, the peaks and
  the card's name and power limit),
  ``GET /metrics`` (JSON, or Prometheus text 0.0.4 with ``Accept:
  text/plain`` or ``?format=prometheus``), and ``GET /debug/trace``,
  ``/debug/events``, ``/debug/requests[/<id>]``, ``/debug/timeline``
  (``obs/``), ``GET /debug/launches`` (the kernels' launch counters, the
  matmuls' by shape too; the port's own), and ``POST /debug/profile?steps=N&top=K`` (N single-token
  decode steps of the batch-1 engine under ``torch.profiler``, the
  scheduler parked: the top-K kernels and the compute/collective split).
  Every response carries ``X-Request-Id`` (the client's, sanitized, or a
  fresh one).
* bounded admission (``--max-pending`` → 429 with a jittered
  Retry-After), per-request deadlines (``timeout``/``max_time`` body
  fields, ``--request-timeout``), and a graceful drain on SIGTERM/SIGINT.
* QoS: a request's class is the body field ``priority`` (an unknown class
  answers 400) or the ``X-Dllama-Priority`` header (an unknown one falls
  back to ``standard``); the scheduler admits by class and preempts lower
  classes (``--no-preempt``, ``--preempt-age-ms``, ``--preempt-cap``,
  ``--preempt-spill-dir``); with ``--slo`` a burning error budget sheds
  ``batch`` first, ``standard`` once violating, ``interactive`` never.
* hand-off (``--handoff``, a paged scheduler): a drain exports every live
  request as a DLREQ01 record, fetched once by ``GET /admin/export/<rid>``
  (kept ``--handoff-ttl`` seconds); ``GET /admin/checkpoint/<rid>`` copies
  a live request without stopping it; ``POST
  /admin/import?emitted_chars=N`` resumes a record here and streams the
  text past the first N characters (409 on another geometry).
* snapshots (``--snapshot-dir``): a drain saves the batch-1 engine, its
  conversation cache and the paged pool with its radix tree; the next boot
  restores them (a corrupt or mismatched file cold-starts).
* speculative decoding (``--spec pld|draft``, ``--spec-k``,
  ``--draft-model``; needs ``--batch-slots``): the slot scheduler verifies
  each greedy slot's drafts in one step (``runtime/spec.py``).
* robustness: ``--io-timeout`` (a stalled body read is a 408),
  ``--drain-grace``, ``--step-timeout`` (a device step that does not land
  in time fails its requests with 500 and marks the server degraded:
  ``/health`` then answers 503 with ``status: "degraded"``, so a router
  ejects it and a supervisor replaces the process), ``--numeric-checks``
  (NaN/Inf logits: a 500, the conversation cache dropped, the engine
  reset, and serving goes on), ``--verify-weights`` (checksum manifests,
  ``io/integrity.py``); the fault points ``server.read_body`` and
  ``server.emit_delta`` (``runtime/faults.py``).  The router's
  ``X-Dllama-Trace`` (the fleet trace id) and ``X-Dllama-Hop`` headers are
  adopted and echoed.
"""

from __future__ import annotations

import codecs
import contextlib
import json
import os
import re
import signal
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs

from ..obs import cost as obs_cost, dispatch as obs_dispatch, events as obs_events
from ..obs import flight as obs_flight, metrics as obs_metrics, trace as obs_trace
from ..io.integrity import ArtifactError
from ..obs.log import get_logger, new_request_id, set_request_id
from ..ops import attention, q8, q40
from ..runtime.engine import ContextOverflow, Engine, NumericFault, StepTimeout
from ..runtime.faults import FAULTS
from ..runtime.scheduler import (PRIORITY_LEVELS, PRIORITY_NAMES, SchedulerClosed,
                                 SchedulerSaturated, SlotScheduler)
from ..runtime.snapshot import RecordStore, SnapshotMismatch
from ..runtime.stream import drain_generation
from ..tokenizer.bpe import Tokenizer
from ..tokenizer.chat import ChatItem, ChatTemplate, TokenizerChatStops
from ..tokenizer.eos import EosDetector
from .backoff import jittered_retry_after

_log = get_logger("server.api")

#: request bodies above this are refused with 413
MAX_BODY_BYTES = 8 * 1024 * 1024

#: /admin/import bodies (DLREQ01 records) carry raw KV pages: their own,
#: larger bound
MAX_HANDOFF_BYTES = 1 << 30

#: a client's X-Request-Id lands in logs and headers: keep it to this
#: charset and length
_RID_RE = re.compile(r"[^A-Za-z0-9._-]")
_RID_MAX = 64


def _decode_continuation(tok: Tokenizer, prev: int, token_ids: list[int]) -> str:
    """Decode a continuation from ``prev``, the last prompt token — not
    from BOS, whose decode strips the first piece's leading space — so a
    batch reply reads exactly as the streamed one."""
    parts = []
    for t in token_ids:
        parts.append(tok.decode_piece(prev, t))
        prev = t
    return b"".join(parts).decode("utf-8", errors="replace")


def priority_level(value) -> int | None:
    """A QoS class name → the scheduler's level; None for anything that is
    not a known class (the caller answers 400 or takes the default)."""
    try:
        return PRIORITY_LEVELS[str(value).strip().lower()]
    except (KeyError, AttributeError):
        return None


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
    n: int = 1  # choices; n > 1 runs on the lockstep batch


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
    if body.get("n") is not None:
        p.n = int(body["n"])
    stop = body.get("stop")
    if isinstance(stop, str):
        p.stop = [stop]
    elif isinstance(stop, list):
        p.stop = [str(s) for s in stop]
    return p


#: the serving counters ServerMetrics mediates; each name is both the
#: /metrics JSON key and the registry's json_key
_SERVING_COUNTERS = (
    "requests_served", "requests_rejected_429", "requests_rejected_503",
    "read_timeouts_408", "deadline_timeouts", "client_disconnects",
    "server_errors")


class ServerMetrics:
    """A per-``ApiState`` view over the process-global registry: bumps land
    in the registry (so both /metrics formats read the same numbers),
    while attribute reads and :meth:`snapshot` are deltas against a
    baseline taken at construction, so several servers in one process
    each see their own traffic.  ``avg_request_s`` is this server's EMA
    request duration (it feeds the Retry-After hint); the registry's
    gauge mirrors it."""

    def __init__(self):
        self.started_at = time.time()
        self._lock = threading.Lock()
        self._counters = {n: obs_metrics.REGISTRY.counter(n) for n in _SERVING_COUNTERS}
        self._base = {n: c.value for n, c in self._counters.items()}
        self._avg_request_s = 0.0

    def bump(self, name: str, n: int = 1) -> None:
        self._counters[name].inc(n)

    def observe_duration(self, seconds: float) -> None:
        with self._lock:
            a = self._avg_request_s
            self._avg_request_s = seconds if a == 0.0 else 0.8 * a + 0.2 * seconds
        obs_metrics.AVG_REQUEST_S.set(self._avg_request_s)
        obs_metrics.REQUEST_DURATION.observe(seconds)

    @property
    def avg_request_s(self) -> float:
        with self._lock:
            return self._avg_request_s

    def __getattr__(self, name: str) -> int:
        try:
            counters = object.__getattribute__(self, "_counters")
            base = object.__getattribute__(self, "_base")
        except AttributeError:
            raise AttributeError(name) from None
        if name in counters:
            return counters[name].value - base[name]
        raise AttributeError(name)

    def snapshot(self) -> dict:
        out = {"uptime_s": round(time.time() - self.started_at, 3)}
        for n, c in self._counters.items():
            out[n] = c.value - self._base[n]
        out["avg_request_s"] = round(self.avg_request_s, 6)
        return out


class _StreamTimer:
    """TTFT and inter-token gaps of one request: started at admission (so
    queue wait counts, as the client sees it), ticked after each delta is
    written.  Each value feeds its histogram and the request's flight
    record, so the two agree."""

    def __init__(self, rid=None):
        self.t0 = time.monotonic()
        self.rid = rid
        self.ttft_s: float | None = None
        self._last: float | None = None

    def tick(self) -> None:
        now = time.monotonic()
        if self._last is None:
            self.ttft_s = now - self.t0
            obs_metrics.TTFT.observe(self.ttft_s)
            obs_flight.first_token(self.rid, self.ttft_s)
        else:
            gap = now - self._last
            obs_metrics.INTER_TOKEN.observe(gap)
            obs_flight.inter_token(self.rid, gap)
        self._last = now


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


def launch_counters(by_shape: bool = False) -> dict:
    """This process's kernel launch and plain-call counters; with
    ``by_shape``, the matmuls' launches by shape too, as ``[*key, n]``."""
    def matmul(c):
        out = {k: v for k, v in c.items() if isinstance(v, int)}
        if by_shape:
            out["by_shape"] = [[*k, n] for k, n in c["launches_by_shape"].items()]
        return out
    return {"q40": matmul(q40.counters()), "q8": matmul(q8.counters()),
            "paged_attention": attention.counters()}


class ApiState:
    """Engine + tokenizer + conversation cache shared across requests.

    ``batch_engine`` (``--batch-slots``) is the slot engine the
    ``scheduler`` drives; it shares the batch-1 engine's weight tensors on
    the device, so the only extra memory is its KV cache; on contiguous
    slot rows it also runs the one-shot lockstep batches (list prompts,
    ``n > 1``, ``logprobs``, ``echo``).  ``engine_lock`` is the mutex of
    the batch-1 and lockstep paths.  ``slo`` (``obs.slo.SloEngine``) adds
    its verdict to ``/health`` and drives shedding.  ``finished`` keeps one
    record per served request (path, tokens, time to first token,
    latency).  ``snapshot_dir`` turns on drain-time snapshots and the warm
    boot; ``handoff`` (a paged scheduler) turns a drain into an export of
    every live request, each record kept ``handoff_ttl`` seconds (0: until
    claimed)."""

    def __init__(self, engine: Engine, tokenizer: Tokenizer,
                 default_temperature: float = 0.7, default_topp: float = 0.9,
                 chunk: int = 16, model_name: str = "dllama-tpu-torch",
                 batch_engine: Engine | None = None,
                 max_pending: int = 8, request_timeout: float = 0.0,
                 io_timeout: float = 15.0, drain_grace: float = 30.0,
                 scheduler: SlotScheduler | None = None, slo=None,
                 snapshot_dir: str | None = None, handoff: bool = False,
                 handoff_ttl: float = 0.0):
        self.engine = engine
        self.slo = slo
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
        self.snapshot_dir = snapshot_dir
        self.handoff = bool(handoff and scheduler is not None and scheduler.pool is not None)
        # a drain's export records wait here for GET /admin/export/<rid>;
        # unclaimed ones expire after handoff_ttl
        self.handoff_records = RecordStore(ttl=handoff_ttl, on_expire=self._handoff_expired)
        #: device steps that outlived --step-timeout; any makes the server
        #: degraded for good (the card may be wedged)
        self.step_timeouts = 0

    def note_step_timeout(self, err: StepTimeout) -> None:
        """A device step outlived the watchdog: from now on ``/health``
        answers 503 ``degraded``, so a router ejects this server and a
        supervisor replaces its process."""
        with self._admit_lock:
            self.step_timeouts += 1
        _log.error("step timeout; this server is degraded: %s", err)
        obs_events.emit("degraded", reason="step_timeout", error=str(err))

    def _handoff_expired(self, rid: str) -> None:
        obs_metrics.HANDOFF_EXPIRED.inc()
        _log.warning("handoff record %s expired unclaimed", rid)

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
        if self.scheduler is None:
            return
        if self.handoff:
            # every live slot becomes a DLREQ01 record for GET
            # /admin/export/<rid>; their handlers see finish "handoff" and
            # answer at once, so the drain takes an export, not the longest
            # decode
            try:
                self.handoff_records.update(
                    self.scheduler.drain_with_export(self.drain_deadline))
                return
            except Exception as e:
                # a failed export degrades to a plain drain, never a crash
                _log.error("handoff export failed: %r", e)
        self.scheduler.begin_drain(self.drain_deadline)

    # -- engine-state snapshot (warm restart) --------------------------
    @property
    def snapshot_path(self) -> str | None:
        return os.path.join(self.snapshot_dir, "engine.snap") if self.snapshot_dir else None

    @property
    def sched_snapshot_path(self) -> str | None:
        return os.path.join(self.snapshot_dir, "scheduler.snap") if self.snapshot_dir else None

    def save_snapshot(self) -> str | None:
        """Snapshot the batch-1 engine and its conversation cache to
        ``--snapshot-dir`` (after the drain, when no request holds the
        engine), and a paged scheduler's pool, page tables and radix tree
        to a sibling file.  Returns the path, or None when off or failed:
        a failed snapshot never turns a clean drain into a crash."""
        path = self.snapshot_path
        if path is None:
            return None
        try:
            os.makedirs(self.snapshot_dir, exist_ok=True)
            with self.engine_lock:
                items = [[it.end_pos, it.message.role, it.message.content]
                         for it in self.naive_cache.items]
                self.engine.snapshot(path, extra={"naive_cache": items})
            _log.info("snapshot saved to %s", path)
        except Exception as e:
            _log.warning("snapshot to %s failed: %r", path, e)
            return None
        if self.scheduler is not None and self.scheduler.pool is not None:
            try:
                self.scheduler.snapshot_paged(self.sched_snapshot_path)
            except Exception as e:
                # the prefix cache only saves prefills: losing it is cheap
                _log.warning("scheduler snapshot failed: %r", e)
        return path

    def restore_snapshot(self) -> bool:
        """Warm boot from ``--snapshot-dir`` when a snapshot is there.  The
        files are one-shot (deleted once restored, so a crash loop cannot
        replay ever staler state); a corrupt or mismatched file logs why
        and cold-starts, and is left for a post-mortem."""
        path = self.snapshot_path
        if path is None or not os.path.exists(path):
            return False
        try:
            extra = self.engine.restore(path)
        except Exception as e:  # ArtifactError and anything else: cold start
            _log.warning("snapshot %s rejected, cold start: %r", path, e)
            self.engine.reset()
            return False
        for end_pos, role, content in extra.get("naive_cache", []):
            self.naive_cache.push(int(end_pos), ChatMessage(str(role), str(content)))
        with contextlib.suppress(OSError):
            os.remove(path)
        _log.info("warm start from %s at pos %d", path, self.engine.pos)
        spath = self.sched_snapshot_path
        if self.scheduler is not None and self.scheduler.pool is not None \
                and os.path.exists(spath):
            try:
                self.scheduler.restore_paged(spath)
            except Exception as e:
                # another geometry: a cold pool, everything else warm
                _log.warning("scheduler snapshot %s rejected, cold pool: %r", spath, e)
            with contextlib.suppress(OSError):
                os.remove(spath)
        return True

    def should_shed(self, level: int) -> bool:
        """SLO-driven shedding: ``interactive`` never; ``batch`` once any
        objective burns its budget on the fast window; ``standard`` only
        while the verdict is ``violating``."""
        if self.slo is None or level <= PRIORITY_LEVELS["interactive"]:
            return False
        try:
            verdict = self.slo.evaluate()
        except Exception:
            return False
        if level >= PRIORITY_LEVELS["batch"]:
            windows = verdict.get("windows") or []
            if not windows:
                return False
            fast = windows[0]
            return any((o.get("burn") or {}).get(fast, 0.0) >= 1.0
                       for o in (verdict.get("objectives") or {}).values())
        return verdict.get("status") == "violating"

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
        occ = self.scheduler.occupancy() if self.scheduler is not None else None
        degraded = self.step_timeouts > 0
        return {
            "status": "degraded" if degraded else "draining" if self.draining else "ok",
            "ready": True,  # the model loads before serve() binds the port
            "model": self.model_name,
            "backend": eng.device.type,
            "seq_len": eng.seq_len,
            "batch_slots": self.batch_engine.batch if self.batch_engine else 0,
            "scheduler": occ,
            # what a router's least-loaded pick needs in one probe: free
            # slots and pages, queue depth, hand-off, the tiering pressure
            # (resident free pages plus what a spill pass could free), and
            # the QoS state (parked requests, preemption on or off)
            "capacity": {
                "free_slots": (occ["slots"] - occ["active"]) if occ
                else max(self.max_pending - in_flight - queued, 0),
                "free_kv_pages": occ.get("kv_pages_free") if occ else None,
                "queue_depth": queued + (occ["queued"] if occ else 0),
                "batch_efficiency": obs_metrics.SCHED_BATCH_EFFICIENCY.json_value(),
                "handoff": self.handoff,
                "kv_pressure": occ.get("kv_pressure") if occ else None,
                "qos": {"preempt": self.scheduler.preempt and self.scheduler.paged,
                        "parked": occ["parked"], "preemptions": occ["preemptions"]}
                if occ else None,
            },
            "in_flight": in_flight,
            "queued": queued,
            "max_pending": self.max_pending,
            "uptime_s": round(time.time() - self.metrics.started_at, 3),
            **self.metrics.snapshot(),
            # a device step outlived --step-timeout (the JAX package's key
            # there is its kernel-degrade ledger, which the port has not)
            "degraded": degraded,
            "degrade_reasons": {"step_timeout": self.step_timeouts} if degraded else {},
            "launches": launch_counters(),
            # ok / at_risk / violating per objective, evaluated live
            "slo": self.slo.evaluate() if self.slo is not None else None,
            # obs/cost.py: MFU/MBU against the card's peaks, the modelled
            # work, chip time by QoS class, the card's name and power limit
            "perf": obs_cost.summary(),
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
        # coarse flight phases for the mutex path (the request id rides
        # the contextvar)
        obs_flight.phase(None, "prefill_chunk", tokens=len(prompt_tokens), pos=start_pos)
        obs_flight.phase(None, "decode_burst", tokens=n_completion)
        obs_flight.retire(None, finish, produced=n_completion)
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
        obs_flight.phase(None, "prefill_chunk", tokens=len(ids), pos=0)
        obs_flight.phase(None, "decode_burst", tokens=n_comp)
        obs_flight.retire(None, finish, produced=n_comp)
        return text, n_comp, finish

    # -- the lockstep batch (list prompts, n > 1, logprobs, echo) --------
    def _plan_ids(self, id_lists: list[list[int]], max_tokens: int,
                  eos_id: int) -> tuple[list[list[int]], int, int, int]:
        """The batch path's validation, padding and budget, shared by
        completions (streamed or not) and chat ``n > 1``: pads the real
        rows to the engine's batch by repeating row 0 and raises
        ContextOverflow for every client-side problem, so a handler answers
        400 before it commits to a response kind."""
        eng = self.batch_engine
        if eng is None:
            raise ValueError("batched serving not enabled (--batch-slots)")
        if eng.paged:
            # the paged pool has no whole-batch reset or lockstep mode
            raise ContextOverflow(
                "prompt lists, n>1 and logprobs are not available with "
                "--kv-pages (slot scheduling only); send requests "
                "individually")
        n_real = len(id_lists)
        if not 0 < n_real <= eng.batch:
            raise ContextOverflow(f"{n_real} prompts for {eng.batch} batch slots")
        if any(not ids for ids in id_lists):
            raise ContextOverflow("a prompt encoded to zero tokens")
        longest = max(len(i) for i in id_lists)
        if longest + 1 >= eng.seq_len:
            raise ContextOverflow(
                f"prompt needs {longest} of {eng.seq_len} context positions")
        padded = [list(i) for i in id_lists] + [list(id_lists[0])] * (eng.batch - n_real)
        budget = eng.seq_len
        if max_tokens > 0:
            budget = min(longest + max_tokens, eng.seq_len)
        return padded, n_real, budget, eos_id

    def _drain_batch(self, id_lists: list[list[int]], budget: int, *,
                     temperature: float, top_p: float, seed: int | None,
                     eos_id: int, deadline: float | None = None,
                     n_real: int | None = None
                     ) -> tuple[list[list[int]], list[bool]]:
        """Run one lockstep batch (``Engine.generate_batch`` semantics:
        per-row EOS and budget cuts) with a deadline check between device
        chunks.  Returns ``(outs, timed_out_per_row)``; a row cut by the
        deadline keeps what it had.  Rows past ``n_real`` are
        :meth:`_plan_ids` padding: they decode on the device but take no
        part in the host's EOS scan or early exit."""
        eng = self.batch_engine
        if n_real is None:
            n_real = len(id_lists)
        obs_metrics.SCHED_BATCH_EFFICIENCY.set(n_real / eng.batch)
        outs = [list(p) for p in id_lists]
        done = [len(o) >= budget or r >= n_real for r, o in enumerate(outs)]
        timed = [False] * len(outs)
        with self.exclusive():
            eng.reset()
            stream = eng.generate_batch_stream(
                id_lists, budget, temperature=temperature, topp=top_p,
                seed=seed if seed is not None else int(time.time()), chunk=self.chunk)
            with contextlib.closing(stream):
                for row_tokens in stream:
                    for r, t in enumerate(row_tokens.tolist()):
                        if done[r]:
                            continue
                        outs[r].append(int(t))
                        if int(t) == eos_id or len(outs[r]) >= budget:
                            done[r] = True
                    if all(done):
                        break
                    d = self.effective_deadline(deadline)
                    if d is not None and time.monotonic() >= d:
                        timed = [not dn and r < n_real for r, dn in enumerate(done)]
                        break
        return outs, timed

    def complete_n(self, params: InferenceParams, deadline: float | None = None
                   ) -> tuple[list[tuple[str, str]], int, int]:
        """``n > 1`` chat choices: the templated prompt n times, decoded as
        one lockstep batch on ``batch_engine`` (n sampled alternatives a
        weight read; greedy rows are identical).  A fresh conversation
        each time: the NaiveCache is neither consulted nor updated.
        Returns ``([(reply, finish)], n_prompt, n_completion)``."""
        eng, tok = self.batch_engine, self.tokenizer
        if eng is not None and params.n > eng.batch:
            raise ContextOverflow(
                f"n={params.n} exceeds the {eng.batch} batch slots; lower n "
                "or restart the server with a larger --batch-slots")
        items = [ChatItem(m.role, m.content) for m in params.messages]
        prompt_tokens = tok.encode(self.template.generate(items, True), add_bos=True)
        id_lists, _, budget, eos_id = self._plan_ids(
            [prompt_tokens] * params.n, params.max_tokens, tok.chat_eos_id)
        outs, timed = self._drain_batch(
            id_lists, budget, temperature=params.temperature, top_p=params.top_p,
            seed=params.seed, eos_id=eos_id, deadline=deadline, n_real=params.n)
        choices = []
        n_completion = 0
        for r in range(params.n):
            comp = outs[r][len(prompt_tokens):]
            finish = "timeout" if timed[r] else "length"
            if comp and comp[-1] == eos_id:
                comp = comp[:-1]
                finish = "stop"
            n_completion += len(comp)
            reply = _decode_continuation(tok, prompt_tokens[-1], comp)
            for stop in self.base_stops + params.stop:
                cut = reply.find(stop)
                if cut != -1:
                    reply = reply[:cut]
                    finish = "stop"
            choices.append((reply, finish))
        return choices, len(prompt_tokens), n_completion

    def plan_batch(self, prompts: list[str], max_tokens: int
                   ) -> tuple[list[list[int]], int, int, int]:
        """Tokenize a /v1/completions prompt list and run it through
        :meth:`_plan_ids`; plain-text completion stops at the base EOS."""
        tok = self.tokenizer
        if self.batch_engine is None:
            raise ValueError("batched serving not enabled (--batch-slots)")
        id_lists = [tok.encode(p, add_bos=self.batch_engine.cfg.add_bos) for p in prompts]
        eos_id = tok.eos_id if tok.eos_id >= 0 else tok.chat_eos_id
        return self._plan_ids(id_lists, max_tokens, eos_id)

    def complete_batch(self, prompts: list[str], *, temperature: float,
                       top_p: float, max_tokens: int, seed: int | None,
                       stop: list[str], echo: bool = False,
                       logprobs: int | None = None,
                       deadline: float | None = None
                       ) -> tuple[list[dict], int, int]:
        """Run B distinct prompts as one lockstep batch on ``batch_engine``;
        returns (choices, prompt_tokens, completion_tokens).  A shorter
        list is padded by repeating the first prompt (pad rows are
        dropped); stop strings cut post hoc.  ``logprobs`` (0-5) scores
        every returned completion with one teacher-forced forward
        (:meth:`Engine.score_batch`): the chosen tokens' log-probs, and the
        top alternatives a position when > 0."""
        tok = self.tokenizer
        id_lists, n_real, budget, eos_id = self.plan_batch(prompts, max_tokens)
        outs, timed = self._drain_batch(
            id_lists, budget, temperature=temperature, top_p=top_p, seed=seed,
            eos_id=eos_id, deadline=deadline, n_real=n_real)
        choices, comps = [], []
        n_prompt = n_completion = 0
        for r in range(n_real):
            ids = id_lists[r]
            comp = outs[r][len(ids):]
            # the shared budget is sized by the longest prompt: cap each row,
            # so a prompt in a batch gets the completion it would get alone
            if max_tokens > 0:
                comp = comp[:max_tokens]
            finish = "timeout" if timed[r] else "length"
            if comp and comp[-1] == eos_id:
                comp = comp[:-1]
                finish = "stop"
            comps.append(comp)
            n_prompt += len(ids)
            n_completion += len(comp)
            # echo decodes prompt + completion as one sequence, so a
            # codepoint split across the boundary reassembles
            text = tok.decode(ids + comp) if echo \
                else _decode_continuation(tok, ids[-1], comp)
            for s in stop:
                cut = text.find(s)
                if cut != -1:
                    text = text[:cut]
                    finish = "stop"
            choices.append({"text": text, "index": r, "finish_reason": finish,
                            "logprobs": None})
        if logprobs is not None and n_real:
            # an echo row owes the prompt's logprobs even with an empty
            # completion; an all-empty non-echo batch needs no forward
            if echo or any(comps):
                self._attach_logprobs(choices, id_lists, comps, n_real, int(logprobs), echo)
            else:
                for r in range(n_real):
                    choices[r]["logprobs"] = {
                        "tokens": [], "token_logprobs": [],
                        "top_logprobs": [] if int(logprobs) > 0 else None,
                        "text_offset": []}
        return choices, n_prompt, n_completion

    def _attach_logprobs(self, choices, id_lists, comps, n_real, top_k, echo):
        """Fill each choice's ``logprobs`` (the OpenAI completions shape)
        from one scoring forward over the padded batch.  Alignment:
        ``"".join(tokens)`` equals the choice's ``text`` (pieces from an
        incremental UTF-8 decode; tokens past a stop-string cut dropped);
        with ``echo`` the prompt's tokens lead, a leading BOS skipped, and
        position 0 (no conditional) has a ``None`` log-prob."""
        eng, tok = self.batch_engine, self.tokenizer
        # pad rows never touch real rows; the scorer needs >= 2 tokens a row
        seqs = [id_lists[r] + comps[r] if r < n_real else list(id_lists[r])
                for r in range(eng.batch)]
        seqs = [s if len(s) >= 2 else s + [0] for s in seqs]
        with self.exclusive():
            tok_lp, top_ids, top_lp = eng.score_batch(seqs, top_k=top_k)
        bucket = tok_lp.shape[1]
        for r in range(n_real):
            text = choices[r]["text"]
            if echo:
                skip = 1 if id_lists[r] and id_lists[r][0] == tok.bos_id else 0
                seq_tokens = (id_lists[r] + comps[r])[skip:]
                base = skip
            else:
                seq_tokens = comps[r]
                base = len(id_lists[r])  # sequence index of entry 0
            off = bucket - len(seqs[r])
            dec = codecs.getincrementaldecoder("utf-8")("replace")
            prev = tok.bos_id if echo else id_lists[r][-1]
            prevs, pieces = [], []
            for t in seq_tokens:
                prevs.append(prev)
                pieces.append(dec.decode(tok.decode_piece(prev, t)))
                prev = t
            tail = dec.decode(b"", True)
            if tail and pieces:
                pieces[-1] += tail
            tokens, lps, tops, offsets_txt = [], [], [], []
            text_pos = 0
            for m, piece in enumerate(pieces):
                if text_pos + len(piece) > len(text):
                    break  # a stop-string cut: align to the text
                seq_idx = base + m
                tokens.append(piece)
                offsets_txt.append(text_pos)
                text_pos += len(piece)
                if seq_idx == 0:  # echo: position 0 has no conditional
                    lps.append(None)
                    if top_k > 0:
                        tops.append(None)
                    continue
                col = off + seq_idx - 1
                lps.append(float(tok_lp[r, col]))
                if top_k > 0:
                    # distinct ids can render to one piece (byte fallback):
                    # the list is sorted descending, so keep the first
                    d: dict = {}
                    for i, lp in zip(top_ids[r, col], top_lp[r, col]):
                        d.setdefault(tok.decode_piece(prevs[m], int(i))
                                     .decode("utf-8", "replace"), float(lp))
                    tops.append(d)
            choices[r]["logprobs"] = {
                "tokens": tokens, "token_logprobs": lps,
                "top_logprobs": tops if top_k > 0 else None,
                "text_offset": offsets_txt}

    def complete_batch_stream(self, prompts: list[str], *, temperature: float,
                              top_p: float, max_tokens: int, seed: int | None,
                              stop: list[str], emit, plan: tuple | None = None,
                              deadline: float | None = None, is_aborted=None
                              ) -> tuple[list, int]:
        """The streaming twin of :meth:`complete_batch`: the same lockstep
        batch, calling ``emit(row_index, delta_text, finish_or_None)`` as
        each row's text becomes safe to send; a finished row stops
        emitting while the others decode on.  Per-row incremental UTF-8
        decoding and a ``max(len(stop)) - 1`` character hold-back keep the
        joined stream equal to the non-stream text.  ``plan`` is
        :meth:`plan_batch`'s result when the handler validated first.
        Returns each row's finish reason (None for a row cut by the
        client's leaving) and the completion tokens produced, EOS not
        counted."""
        eng, tok = self.batch_engine, self.tokenizer
        id_lists, n_real, budget, eos_id = \
            plan if plan is not None else self.plan_batch(prompts, max_tokens)
        obs_metrics.SCHED_BATCH_EFFICIENCY.set(n_real / eng.batch)
        decoders = [codecs.getincrementaldecoder("utf-8")("replace") for _ in range(n_real)]
        hold = max((len(s) for s in stop), default=0)
        prev = [ids[-1] for ids in id_lists[:n_real]]
        buf = [""] * n_real   # decoded, not yet emitted
        n_comp = [0] * n_real
        cap = [max_tokens if max_tokens > 0 else eng.seq_len - len(id_lists[r])
               for r in range(n_real)]
        done = [False] * n_real
        fin = [None] * n_real
        n_eos = 0

        def flush(r, closing, finish="length"):
            """Scan the row's unsent text for stops and emit what is safe;
            while the row is live the last ``hold - 1`` characters wait (a
            stop could still complete across the boundary)."""
            cuts = [c for c in (buf[r].find(s) for s in stop) if c != -1]
            if cuts:
                emit(r, buf[r][:min(cuts)], "stop")
                buf[r] = ""
                done[r] = True
                fin[r] = "stop"
            elif closing:
                done[r] = True
                fin[r] = finish
                emit(r, buf[r], finish)
                buf[r] = ""
            elif hold and len(buf[r]) >= hold:
                emit(r, buf[r][:len(buf[r]) - (hold - 1)], None)
                buf[r] = buf[r][len(buf[r]) - (hold - 1):]
            elif not hold and buf[r]:
                emit(r, buf[r], None)
                buf[r] = ""

        with self.exclusive():
            eng.reset()
            stream = eng.generate_batch_stream(
                id_lists, budget, temperature=temperature, topp=top_p,
                seed=seed if seed is not None else int(time.time()), chunk=self.chunk)
            with contextlib.closing(stream):
                for step_vec in stream:
                    for r in range(n_real):
                        if done[r]:
                            continue
                        t = int(step_vec[r])
                        n_comp[r] += 1
                        if t == eos_id:
                            n_eos += 1
                            buf[r] += decoders[r].decode(b"", True)
                            flush(r, closing=True, finish="stop")
                            continue
                        buf[r] += decoders[r].decode(tok.decode_piece(prev[r], t))
                        prev[r] = t
                        if n_comp[r] >= cap[r]:
                            buf[r] += decoders[r].decode(b"", True)
                            flush(r, closing=True)
                        else:
                            flush(r, closing=False)
                    if all(done):
                        break
                    if is_aborted is not None and is_aborted():
                        return fin, sum(n_comp) - n_eos  # the client is gone
                    d = self.effective_deadline(deadline)
                    if d is not None and time.monotonic() >= d:
                        for r in range(n_real):
                            if not done[r]:
                                buf[r] += decoders[r].decode(b"", True)
                                flush(r, closing=True, finish="timeout")
                        return fin, sum(n_comp) - n_eos
        for r in range(n_real):
            if not done[r]:  # budget spent with text still held
                buf[r] += decoders[r].decode(b"", True)
                flush(r, closing=True)
        return fin, sum(n_comp) - n_eos

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
                     deadline: float | None, stop: list[str] | None = None,
                     priority: int = PRIORITY_LEVELS["standard"]):
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
            eos_ids=(eos_id,), deadline=self.effective_deadline(deadline),
            priority=priority)
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

    def handoff_resume(self, ticket, extra: dict, emitted_chars: int, emit,
                       is_aborted=None) -> tuple[str, int, str]:
        """Drive an imported request to completion (``/admin/import``).
        The exporter's completion tokens are replayed through a fresh
        incremental decoder, so the decode and stop-scan state stand where
        the exporter's stream stood; only text past ``emitted_chars`` (what
        the client already has) is emitted.  Returns ``(completion text,
        completion tokens including the replayed ones, finish)``."""
        tok = self.tokenizer
        stop = [str(s) for s in extra.get("stop") or []]
        hold = max((len(s) for s in stop), default=0)
        dec = codecs.getincrementaldecoder("utf-8")("replace")
        prev = int(extra["prompt"][-1])
        full = ""
        cursor = max(0, int(emitted_chars))

        def feed(t):
            nonlocal full, prev
            full += dec.decode(tok.decode_piece(prev, t))
            prev = t

        def flush(limit, finish=None):
            nonlocal cursor
            delta = full[cursor:limit] if limit > cursor else ""
            if delta or finish is not None:
                emit(delta, finish)
            cursor = max(cursor, limit)

        replay = [int(x) for x in extra.get("completion") or []]
        for t in replay:
            feed(t)
        n_comp = len(replay)
        for t in ticket.tokens():
            if is_aborted is not None and is_aborted():
                ticket.cancel("aborted")
                break
            n_comp += 1
            feed(t)
            # a stop inside the exporter's emitted text would have fired
            # there: any cut found here is new text
            cuts = [c for c in (full.find(s) for s in stop) if c != -1]
            if cuts:
                ticket.cancel("stop")
                flush(min(cuts), "stop")
                return full[:cursor], n_comp, "stop"
            flush(len(full) - (hold - 1) if hold else len(full))
        finish = ticket.finish or "aborted"
        full += dec.decode(b"", True)
        cuts = [c for c in (full.find(s) for s in stop) if c != -1]
        limit = len(full)
        if cuts:
            limit = min(cuts)
            finish = "stop"
        flush(limit, finish)
        return full[:limit], n_comp, finish

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

        def _begin_request(self) -> str:
            """The request ID, set at accept: the client's ``X-Request-Id``
            (sanitized: it lands in logs and headers verbatim) or a fresh
            one, bound to the log contextvar for this thread."""
            client = self.headers.get("X-Request-Id") or ""
            self._rid = _RID_RE.sub("", client)[:_RID_MAX] or new_request_id()
            set_request_id(self._rid)
            # a router hop stamps X-Dllama-Hop (its instance id: the flight
            # record links back to the router's ring) and X-Dllama-Trace (the
            # fleet trace id, bound to the rid so the scheduler's spans for
            # this request carry it too)
            hop = self.headers.get("X-Dllama-Hop") or ""
            self._hop = _RID_RE.sub("", hop)[:_RID_MAX] or None
            self._trace = obs_trace.sanitize_trace_id(self.headers.get("X-Dllama-Trace"))
            obs_trace.trace_id_var.set(self._trace)
            if self._trace:
                obs_trace.set_trace(self._rid, self._trace)
            # the class from the transport header (a router relays it); the
            # body field overrides it in do_POST, and an unknown header value
            # falls back to the default rather than failing the request
            hdr = self.headers.get("X-Dllama-Priority")
            self._prio_hdr = priority_level(hdr) if hdr else None
            return self._rid

        def _rid_header(self) -> None:
            if getattr(self, "_rid", None):
                self.send_header("X-Request-Id", self._rid)
            if getattr(self, "_trace", None):
                self.send_header("X-Dllama-Trace", self._trace)

        def _send(self, code: int, data: bytes, content_type: str,
                  headers: dict | None = None):
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(data)))
            self._rid_header()
            for k, v in (headers or {}).items():
                self.send_header(k, str(v))
            if state.draining:
                self.close_connection = True
            self.end_headers()
            try:
                self.wfile.write(data)
            except OSError:
                self.close_connection = True

        def _json(self, code: int, obj: dict, headers: dict | None = None):
            self._send(code, json.dumps(obj).encode(), "application/json", headers)

        def _sse_headers(self):
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self._rid_header()
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
                    e0 = time.perf_counter()
                    FAULTS.fire("server.emit_delta")  # disconnect: a client gone
                    self.wfile.write(f"data: {json.dumps(chunk)}\n\n".encode())
                    self.wfile.flush()
                    obs_trace.record("emit", e0, time.perf_counter())
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
            (408/400/413) was already sent or the client vanished.  The
            ``server.read_body`` fault point stands in for a stalled client."""
            try:
                FAULTS.fire("server.read_body")
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
            self._begin_request()
            path, _, query = self.path.partition("?")
            qs = parse_qs(query)

            def qint(name, default):
                try:
                    return int(qs[name][0]) if name in qs else default
                except ValueError:
                    return default

            if path == "/v1/models":
                self._json(200, {"object": "list", "data": [{
                    "id": state.model_name, "object": "model",
                    "created": int(time.time()), "owned_by": "user"}]})
            elif path in ("/health", "/healthz"):
                health = state.health()
                # a degraded server fails the probe: routers eject it
                self._json(503 if health["degraded"] else 200, health)
            elif path == "/metrics":
                # one registry, two formats: Prometheus text 0.0.4 when
                # asked for (Accept or ?format), else the JSON dict with this
                # server's serving counters on top
                obs_dispatch.sync()
                accept = self.headers.get("Accept") or ""
                if (qs.get("format", [""])[0] == "prometheus"
                        or "text/plain" in accept or "openmetrics" in accept):
                    self._send(200, obs_metrics.render_prometheus().encode(),
                               "text/plain; version=0.0.4; charset=utf-8")
                else:
                    merged = obs_metrics.snapshot_json()
                    merged.update(state.metrics.snapshot())
                    self._json(200, merged)
            elif path == "/debug/trace":
                # Chrome trace JSON of the last N requests' spans; ?since=<seq>
                # is the raw incremental export
                if "since" in qs:
                    self._json(200, obs_trace.raw(qint("since", 0)))
                else:
                    self._json(200, obs_trace.trace_json(qint("last", 20)))
            elif path == "/debug/events":
                self._json(200, obs_events.snapshot(qint("since", 0) if "since" in qs
                                                    else None))
            elif path == "/debug/requests":
                self._json(200, {"requests": obs_flight.recent(qint("n", 50))})
            elif path.startswith("/debug/requests/"):
                rid = path[len("/debug/requests/"):]
                rec = obs_flight.get(rid)
                if rec is None:
                    self._json(404, {"error": f"no flight record for request id {rid!r}"})
                else:
                    self._json(200, rec)
            elif path == "/debug/launches":
                # /health's launch counters with the matmuls' by shape, as
                # [*key, n] (read once per replica, not by every probe)
                self._json(200, launch_counters(by_shape=True))
            elif path == "/debug/timeline":
                self._json(200, {
                    "slots": state.scheduler.engine.batch if state.scheduler else 0,
                    "steps": obs_flight.TIMELINE.snapshot(qint("n", 256)),
                    "components_ms": obs_metrics.SCHED_STEP_TIME_MS.json_value(),
                    "goodput_ratio": obs_metrics.SCHED_GOODPUT_RATIO.json_value(),
                    "host_gap_ms": obs_metrics.SCHED_HOST_GAP_MS.json_value()})
            elif path.startswith("/admin/export/"):
                # a drain's record, fetched once: it leaves this process
                # with the response, so a second fetch cannot resume the
                # request twice
                rid = path[len("/admin/export/"):]
                rec = state.handoff_records.pop(rid, None)
                if rec is None:
                    self._json(404, {"error": f"no hand-off record for request id {rid!r}"})
                else:
                    obs_metrics.HANDOFF_EXPORTS.inc()
                    self._send(200, rec, "application/octet-stream")
            elif path.startswith("/admin/checkpoint/"):
                # a non-destructive record of one live slot: the request
                # keeps decoding here
                rid = path[len("/admin/checkpoint/"):]
                if not state.handoff:
                    self._json(404, {"error": "hand-off is not enabled (--handoff)"})
                    return
                try:
                    rec = state.scheduler.checkpoint_export(rid)
                except Exception as e:  # noqa: BLE001 — never take the request down
                    _log.warning("checkpoint of %s failed: %r", rid, e)
                    rec = None
                if rec is None:
                    self._json(404, {"error": f"no live slot for request id {rid!r}"})
                else:
                    self._send(200, rec, "application/octet-stream")
            elif path.startswith("/debug/"):
                self._json(400, {"error": _not_ported_msg(f"GET {path}")})
            else:
                self._json(404, {"error": "not found"})

        def _sched_eligible(self, body: dict) -> bool:
            """True when this request can ride the slot scheduler.  The
            mutex path keeps what a slot cannot express: list prompts,
            ``n > 1``, ``logprobs``, ``echo``, and seeded sampling (slot
            rows share the engine's generator, so a per-request seed is
            only reproducible when the request owns the engine)."""
            if state.scheduler is None:
                return False
            try:
                if int(body.get("n") or 1) != 1:
                    return False
                temperature = float(body["temperature"]) \
                    if body.get("temperature") is not None \
                    else state.default_temperature
            except (TypeError, ValueError):
                return False  # malformed: the mutex handlers own the 400
            if body.get("seed") is not None and temperature != 0.0:
                return False
            if self.path.partition("?")[0] == "/v1/completions":
                return not isinstance(body.get("prompt"), list) \
                    and body.get("logprobs") is None and not body.get("echo")
            return True

        def _submit_or_reject(self, ids, max_tokens, *, temperature, top_p,
                              eos_id, deadline, stop=None):
            """sched_submit with every refusal mapped to its HTTP answer;
            None when a response was already sent."""
            try:
                return state.sched_submit(
                    ids, max_tokens, temperature=temperature, top_p=top_p,
                    eos_id=eos_id, deadline=deadline, stop=stop,
                    priority=self._priority)
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
            """The parsed fields of a /v1/completions body (``n`` replicates
            each prompt, row-major as OpenAI does; ``logprobs`` capped at 5);
            None after answering 400."""
            try:
                prompt = body.get("prompt")
                prompts = [str(p) for p in prompt] if isinstance(prompt, list) \
                    else [str(prompt or "")]
                if not any(prompts):
                    self._json(400, {"error": "prompt required"})
                    return None
                n = int(body.get("n") or 1)
                if n > 1:
                    prompts = [p for p in prompts for _ in range(n)]
                temperature = float(body["temperature"]) \
                    if body.get("temperature") is not None else state.default_temperature
                top_p = float(body["top_p"]) \
                    if body.get("top_p") is not None else state.default_topp
                max_tokens = int(body.get("max_tokens") or 0)
                seed = int(body["seed"]) if body.get("seed") is not None else None
                stop = body.get("stop")
                stop = [stop] if isinstance(stop, str) else \
                    [str(s) for s in stop] if isinstance(stop, list) else []
                logprobs = body.get("logprobs")
                if logprobs is not None:
                    logprobs = max(0, min(int(logprobs), 5))  # the OpenAI cap
            except (TypeError, ValueError) as e:
                self._json(400, {"error": f"bad request: {e}"})
                return None
            return dict(prompts=prompts, temperature=temperature, top_p=top_p,
                        max_tokens=max_tokens, seed=seed, stop=stop,
                        echo=bool(body.get("echo")), stream=bool(body.get("stream")),
                        logprobs=logprobs,
                        lockstep=isinstance(prompt, list) or n > 1
                        or logprobs is not None or bool(body.get("echo")))

        def _completions(self, body: dict, deadline: float | None,
                         timer: _StreamTimer, use_sched: bool):
            """/v1/completions: a single prompt over the slot scheduler when
            ``use_sched``, else on the batch-1 engine under the mutex; a
            list prompt, ``n > 1``, ``logprobs`` or ``echo`` as one lockstep
            batch on the slot engine (:meth:`_completions_batch`)."""
            args = self._completion_args(body)
            if args is None:
                return
            if args["lockstep"]:
                self._completions_batch(args, deadline, timer)
                return
            text, temperature, top_p = args["prompts"][0], args["temperature"], args["top_p"]
            max_tokens, seed, stop, stream = (args["max_tokens"], args["seed"], args["stop"],
                                              args["stream"])
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

        def _completions_batch(self, args: dict, deadline: float | None,
                               timer: _StreamTimer):
            """The lockstep /v1/completions: every row (each prompt, ``n``
            times) decodes as its own stream in one batch; streamed, each
            SSE chunk carries one row's delta under its choice index (echo
            is not streamed)."""
            if args["stream"] and args["logprobs"] is not None:
                self._json(400, {"error": "logprobs with stream is not supported; "
                                          "request them non-streaming"})
                return
            if state.batch_engine is None:
                self._json(400, {"error": "batched serving not enabled; start the "
                                          "server with --batch-slots N"})
                return
            prompts = args["prompts"]
            gen = {k: args[k] for k in ("temperature", "top_p", "max_tokens", "seed",
                                        "stop")}
            created = int(time.time())
            cid = f"cmpl-{uuid.uuid4().hex[:12]}"
            if not args["stream"]:
                try:
                    choices, n_prompt, n_comp = state.complete_batch(
                        prompts, echo=args["echo"], logprobs=args["logprobs"],
                        deadline=deadline, **gen)
                except ContextOverflow as e:
                    self._json(400, state.overflow_body(e))
                    return
                if any(c["finish_reason"] == "timeout" for c in choices):
                    state.metrics.bump("deadline_timeouts")
                self._record = dict(prompt_tokens=n_prompt, completion_tokens=n_comp,
                                    finish=choices[0]["finish_reason"])
                self._retire_lockstep([c["finish_reason"] for c in choices], n_comp)
                self._json(200, {
                    "id": cid, "object": "text_completion", "created": created,
                    "model": state.model_name, "choices": choices,
                    "usage": {"prompt_tokens": n_prompt, "completion_tokens": n_comp,
                              "total_tokens": n_prompt + n_comp}})
                return
            # validate before committing to SSE: an invalid request gets the
            # 400 it would get without stream
            try:
                plan = state.plan_batch(prompts, args["max_tokens"])
            except ContextOverflow as e:
                self._json(400, state.overflow_body(e))
                return
            self._sse_headers()
            aborted = [False]
            emitters = {}

            def emit(idx, delta, finish):
                if idx not in emitters:
                    emitters[idx] = self._sse_emitter(aborted, lambda d, f: {
                        "id": cid, "object": "text_completion", "created": created,
                        "model": state.model_name,
                        "choices": [{"text": d, "index": idx, "finish_reason": f,
                                     "logprobs": None}]}, timer)
                emitters[idx](delta, finish)

            try:
                finishes, n_comp = state.complete_batch_stream(
                    prompts, emit=emit, plan=plan, deadline=deadline,
                    is_aborted=lambda: aborted[0], **gen)
            except Exception as e:
                # mid-stream: an OpenAI-shaped error event, then [DONE]
                err = {"error": {"message": str(e), "type": "invalid_request_error"
                                 if isinstance(e, ContextOverflow) else "server_error"}}
                self._safe_write(f"data: {json.dumps(err)}\n\n".encode()
                                 + b"data: [DONE]\n\n", aborted)
                if not isinstance(e, ContextOverflow):
                    raise
                return
            self._retire_lockstep(finishes, n_comp)
            self._safe_write(b"data: [DONE]\n\n", aborted)
            self._record = dict(prompt_tokens=sum(len(i) for i in plan[0][:plan[1]]),
                                completion_tokens=None, finish=None)

        def _retire_lockstep(self, finishes: list, n_comp: int):
            """Close a lockstep request's flight record before its reply (or
            its stream's last event) is written: a client that reads
            ``/debug/requests/<id>`` as soon as it has the reply finds
            ``finish``, ``produced`` and each choice's finish reason.  The
            record's ``finish`` is ``served``, the handler fallback's reason
            for these paths.  A deliberate difference from the JAX server
            (``dllama_tpu/server/api.py`` retires them only in the handler's
            ``finally``, after the reply)."""
            obs_flight.retire(self._rid, "served", produced=n_comp,
                              finish_reasons=list(finishes))

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
            if params.n > 1:
                self._chat_n(params, deadline, cid, created)
                return
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

        def _chat_n(self, params: InferenceParams, deadline: float | None,
                    cid: str, created: int):
            """Chat with ``n > 1`` choices: one lockstep batch (not
            streamed)."""
            if params.stream:
                self._json(400, {"error": "stream with n>1 is not supported; "
                                          "request them separately"})
                return
            if state.batch_engine is None:
                self._json(400, {"error": "n>1 needs batched serving; start the "
                                          "server with --batch-slots N"})
                return
            try:
                choices, n_prompt, n_comp = state.complete_n(params, deadline=deadline)
            except ContextOverflow as e:
                self._json(400, state.overflow_body(e))
                return
            if any(fin == "timeout" for _, fin in choices):
                state.metrics.bump("deadline_timeouts")
            self._record = dict(prompt_tokens=n_prompt, completion_tokens=n_comp,
                                finish=choices[0][1])
            self._retire_lockstep([fin for _, fin in choices], n_comp)
            self._json(200, {
                "id": cid, "object": "chat.completion", "created": created,
                "model": state.model_name,
                "choices": [{"index": i, "finish_reason": fin,
                             "message": {"role": "assistant", "content": r}}
                            for i, (r, fin) in enumerate(choices)],
                "usage": {"prompt_tokens": n_prompt, "completion_tokens": n_comp,
                          "total_tokens": n_prompt + n_comp}})

        def _admin_import(self, query: str):
            """``POST /admin/import?emitted_chars=N``: resume a DLREQ01
            record (the octet-stream body) in a free slot and stream the
            rest of its completion as ``text_completion`` SSE chunks, past
            the first N characters (what the client already has from the
            exporter).  409 on another geometry, so a router tries another
            peer."""
            if not state.handoff:
                self._json(404, {"error": "hand-off is not enabled (--handoff)"})
                return
            try:
                emitted_chars = max(0, int(parse_qs(query).get("emitted_chars", ["0"])[0]))
            except ValueError:
                emitted_chars = 0
            try:
                length = int(self.headers.get("Content-Length", 0) or 0)
            except (TypeError, ValueError):
                self._json(400, {"error": "bad Content-Length"})
                return
            if length > MAX_HANDOFF_BYTES:
                self.close_connection = True
                self._json(413, {"error": "hand-off record too large"})
                return
            if length <= 0:
                self._json(400, {"error": "hand-off record body required"})
                return
            try:
                raw = self.rfile.read(length)
            except TimeoutError:
                state.metrics.bump("read_timeouts_408")
                self.close_connection = True
                self._json(408, {"error": "timed out reading hand-off record"})
                return
            if len(raw) < length:
                state.metrics.bump("client_disconnects")
                self.close_connection = True
                return
            try:
                ticket, extra = state.scheduler.import_request(raw)
            except SnapshotMismatch as e:
                obs_metrics.HANDOFF_IMPORT_REJECTS.inc()
                self._json(409, {"error": str(e)})
                return
            except ArtifactError as e:
                obs_metrics.HANDOFF_IMPORT_REJECTS.inc()
                self._json(400, {"error": str(e)})
                return
            except ContextOverflow as e:
                self._json(400, state.overflow_body(e))
                return
            except SchedulerSaturated as e:
                state.metrics.bump("requests_rejected_429")
                self._json(429, state.overflow_body(e), headers={
                    "Retry-After": jittered_retry_after(state.retry_after_hint())})
                return
            except SchedulerClosed:
                state.metrics.bump("requests_rejected_503")
                self._json(503, {"error": "server is draining; no new requests accepted"},
                           headers={"Retry-After": jittered_retry_after(30)})
                return
            obs_metrics.HANDOFF_IMPORTS.inc()
            self._sse_headers()
            aborted = [False]
            emit = self._sse_emitter(aborted, lambda d, f: {
                "object": "text_completion", "model": state.model_name,
                "choices": [{"text": d, "index": 0, "finish_reason": f,
                             "logprobs": None}]}, None)
            state.mark_active(True)
            try:
                _, n_comp, finish = state.handoff_resume(
                    ticket, extra, emitted_chars, emit, is_aborted=lambda: aborted[0])
            except Exception as e:
                ticket.cancel("aborted")
                err = {"error": {"message": str(e), "type": "server_error"}}
                self._safe_write(f"data: {json.dumps(err)}\n\n".encode()
                                 + b"data: [DONE]\n\n", aborted)
                raise
            finally:
                state.mark_active(False)
            usage = {"object": "handoff.usage",
                     "usage": {"prompt_tokens": len(extra.get("prompt") or []),
                               "completion_tokens": n_comp, "finish_reason": finish}}
            self._safe_write(f"data: {json.dumps(usage)}\n\n".encode()
                             + b"data: [DONE]\n\n", aborted)

        def _debug_profile(self, query: str):
            """``POST /debug/profile?steps=N&top=K``: N single-token decode
            steps of the batch-1 engine under ``torch.profiler``
            (``runtime/profiling.profile_decode_steps``: graph replays on the
            card, or eager steps when the profiler saw no kernel inside
            them, as ``how`` says), with the engine's mutex held and the
            scheduler parked; answers the top-K kernels and the
            compute/collective split a step.  POST because it borrows the
            engine and rewinds its position after.  503 while draining."""
            from ..runtime.profiling import profile_decode_steps, summarize_split, top_ops
            if state.draining:
                self._json(503, {"error": "server is draining"},
                           headers={"Retry-After": jittered_retry_after(30)})
                return
            q = parse_qs(query)

            def qint(name, default, lo, hi):
                try:
                    v = int(q.get(name, [default])[0])
                except ValueError:
                    v = default
                return max(lo, min(hi, v))

            steps = qint("steps", 3, 1, 16)
            top = qint("top", 10, 1, 50)
            eng = state.engine
            with state.engine_lock:
                state.mark_active(True)
                try:
                    with state.exclusive():
                        if eng.pos + 2 * steps + 1 > eng.seq_len:
                            # no room: drop the conversation state first
                            state.naive_cache.clear()
                        times, how = profile_decode_steps(eng, steps)
                finally:
                    state.mark_active(False)
            if times is None:
                self._json(503, {"error": "the profiler recorded no time"})
                return
            split = summarize_split(times, steps)
            _log.info("profile", extra={"steps": steps, "n_ops": len(times)})
            self._json(200, {
                "steps": steps, "devices": eng.tp, "how": how,
                "compute_ms": round(split["compute_ms"], 4),
                "collective_ms": round(split["collective_ms"], 4),
                "collective_pct": round(split["collective_pct"], 2),
                "ops": [{"op": op, "ms": round(ms, 4)} for op, ms in top_ops(times, top, steps)],
            })

        def do_POST(self):
            self._begin_request()
            path, _, query = self.path.partition("?")
            if path == "/debug/profile":
                self._debug_profile(query)
                return
            if path == "/admin/import":
                self._admin_import(query)
                return
            if path not in ("/v1/chat/completions", "/v1/completions"):
                self._json(404, {"error": "not found"})
                return
            body = self._read_body()
            if body is None:
                return
            # the class: the body field over the header, else standard; an
            # unknown body value is the caller's error (400)
            prio = body.get("priority")
            if prio is not None:
                self._priority = priority_level(prio)
                if self._priority is None:
                    self._json(400, {"error": f"unknown priority class {prio!r}; "
                                              "expected interactive|standard|batch"})
                    return
            else:
                self._priority = self._prio_hdr if self._prio_hdr is not None \
                    else PRIORITY_LEVELS["standard"]
            prio_name = PRIORITY_NAMES[self._priority]
            # SLO shedding: before the request counts against capacity
            if state.should_shed(self._priority):
                state.metrics.bump("requests_rejected_429")
                obs_metrics.ADMISSIONS_SHED.inc(prio_name)
                _log.info("reject 429: slo shed (%s)", prio_name)
                self._json(429, {"error": "SLO error budget burning; shedding "
                                          f"{prio_name}-class admissions — retry later"},
                           headers={"Retry-After": jittered_retry_after(
                               state.retry_after_hint())})
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
            tp0 = time.perf_counter()
            deadline = state.request_deadline(body)
            # starts at admission: queue wait counts into TTFT
            timer = _StreamTimer(rid=self._rid)
            # the flight record opens at admission; the scheduler merges its
            # per-dispatch detail into it by request ID
            if self._hop:
                obs_flight.submit(self._rid, path=path, priority=prio_name, hop=self._hop)
            else:
                obs_flight.submit(self._rid, path=path, priority=prio_name)
            self._record = None
            ok = False
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
                    q0 = time.perf_counter()
                    if not locked:
                        state.engine_lock.acquire()
                    q1 = time.perf_counter()
                    obs_metrics.QUEUE_WAIT.observe(q1 - q0)
                    obs_trace.record("queue_wait", q0, q1)
                    obs_flight.admit(self._rid, queued_ms=(q1 - q0) * 1e3)
                    _log.info("queue", extra={"wait_s": round(q1 - q0, 6)})
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
                ok = True
                _log.info("finish", extra={"path": path,
                                           "duration_s": round(time.monotonic() - t0, 6)})
                if self._record is not None:
                    state.finished.append(dict(
                        self._record, path=path, stream=bool(body.get("stream")),
                        scheduler=use_sched, ttft_s=timer.ttft_s,
                        latency_s=time.monotonic() - t0))
            except (BrokenPipeError, ConnectionResetError):
                state.metrics.bump("client_disconnects")
                self.close_connection = True
            except NumericFault as e:
                # NaN/Inf logits (--numeric-checks): the KV cache may be
                # poisoned, so resuming is not safe — drop the conversation
                # cache and the position; the request gets a 500 and the
                # server keeps serving fresh conversations
                state.metrics.bump("server_errors")
                state.naive_cache.clear()
                state.engine.reset()
                self._maybe_500(e)
                _log.error("numeric fault on %s: %s", path, e)
                raise  # surface in the server log — corruption is a page
            except StepTimeout as e:
                state.metrics.bump("server_errors")
                state.note_step_timeout(e)
                self._maybe_500(e)
                raise
            except Exception as e:
                state.metrics.bump("server_errors")
                self._maybe_500(e)
                _log.exception("error on %s", path)
                raise  # surface in the server log: a 500 is a bug to fix
            finally:
                state.leave(time.monotonic() - t0)
                obs_trace.record("request", tp0, time.perf_counter(), path=path)
                # the fallback close of a path that retired no specific
                # finish (a no-op when one did)
                obs_flight.retire(self._rid, "served" if ok else "error")

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

            def _shutdown():
                # hand-off records are pulled (GET /admin/export/<rid>) on
                # new connections, which shutdown() stops accepting: wait,
                # bounded by the drain deadline, until each is claimed
                deadline = state.drain_deadline or time.monotonic()
                while state.handoff_records and time.monotonic() < deadline:
                    time.sleep(0.05)
                if state.handoff_records:
                    _log.warning("%d hand-off records unclaimed", len(state.handoff_records))
                server.shutdown()

            threading.Thread(target=_shutdown, daemon=True).start()

        signal.signal(signal.SIGTERM, _drain)
        signal.signal(signal.SIGINT, _drain)
    _log.info("listening on %s:%d", host, server.server_address[1])
    if block:
        try:
            server.serve_forever()
        finally:
            server.server_close()
        # every request has finished and the engine is quiet: the next boot
        # starts warm (--snapshot-dir)
        if state.draining:
            state.save_snapshot()
    else:
        threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def build_state(args, slo=None, stack=None) -> ApiState:
    """Load the model and build the server state from parsed CLI args: the
    batch-1 engine, and with ``--batch-slots`` the slot engine (sharing
    its weights) and its scheduler.  A slot engine the scheduler cannot
    drive (a contiguous int8 cache, ``--kv-cache-dtype q8`` without pages)
    still serves the lockstep batch, as in the JAX server.  ``stack``, an
    ``(engine, tokenizer)`` loaded before, serves instead of loading
    ``--model`` again (:func:`~dllama_tpu_torch.cli.load_stack`).  With
    ``--snapshot-dir`` the state restores from a snapshot there."""
    from ..cli import load_draft_engine, load_stack
    from ..runtime.spec import make_proposer
    if args.kv_quant == "int8" and args.kv_pages <= 0:
        raise SystemExit("--kv-quant int8 needs a paged pool (--kv-pages); "
                         "contiguous slot rows have no per-page scales")
    if args.kv_pages > 0 and args.kv_cache_dtype == "q8":
        raise SystemExit("--kv-pages needs a dense chat-engine KV cache; drop "
                         "--kv-cache-dtype q8 (use --kv-quant int8 to quantize "
                         "the paged pool)")
    if args.handoff_ttl < 0:
        raise SystemExit("--handoff-ttl must be >= 0")
    if args.spec != "off" and args.batch_slots <= 0:
        # speculation lives in the slot scheduler: fail before the load
        raise SystemExit("--spec needs --batch-slots (speculative decoding runs "
                         "under the slot scheduler)")
    if args.batch_slots > 0 and args.sp > 1:
        # the slot engine's ragged prefill needs the whole sequence axis a
        # shard: refuse at start-up, before the load (the JAX server's)
        raise SystemExit("--batch-slots is not supported with --sp "
                         "(sequence-sharded KV cache); drop one of them")
    engine, tok = load_stack(args, stack=stack)
    batch_engine = scheduler = None
    if args.batch_slots > 0:
        batch_engine = Engine(engine.cfg, engine.params, seq_len=args.max_seq_len,
                              kv_dtype="q8" if args.kv_quant == "int8"
                              else engine.cache.k.dtype,
                              device=engine.device, batch=args.batch_slots,
                              kv_pages=args.kv_pages, kv_page_size=args.kv_page_size,
                              mesh=engine.mesh, step_timeout=args.step_timeout)
        try:
            spec = None
            if args.spec != "off":
                draft = load_draft_engine(args, batch_engine) if args.spec == "draft" else None
                spec = make_proposer(args.spec, batch_engine, draft_engine=draft)
            scheduler = SlotScheduler(
                batch_engine, prefill_chunk=args.sched_prefill_chunk,
                max_wait_ms=args.sched_max_wait_ms, max_queue=args.sched_max_queue,
                prefix_reuse=not args.no_prefix_reuse, overlap=not args.no_sched_overlap,
                preempt=not args.no_preempt, preempt_age_ms=args.preempt_age_ms,
                preempt_cap=args.preempt_cap, spill_dir=args.preempt_spill_dir,
                kv_reserve=args.kv_reserve, spill_headroom=args.spill_headroom,
                host_pool_mb=args.kv_host_pool_mb, spec=spec, spec_k=args.spec_k)
        except ValueError as e:
            # a contiguous int8 cache: the lockstep batch still serves,
            # only decode-step admission is off
            _log.warning("slot_scheduler_disabled", extra={"reason": str(e)})
        else:
            _log.info("slot_scheduler_enabled", extra={
                "slots": args.batch_slots, "kv_pages": args.kv_pages,
                "kv_page_size": args.kv_page_size, "kv_quant": args.kv_quant,
                "prefix_reuse": scheduler.prefix_cache is not None,
                "overlap": scheduler.overlap, "kv_reserve": scheduler.kv_reserve,
                "preempt": scheduler.preempt and scheduler.paged,
                "spec": args.spec, "spec_k": args.spec_k})
    if args.handoff and (scheduler is None or scheduler.pool is None):
        raise SystemExit("--handoff needs the paged scheduler (--batch-slots and --kv-pages)")
    state = ApiState(engine, tok, default_temperature=args.temperature,
                     default_topp=args.topp, chunk=args.chunk,
                     batch_engine=batch_engine, max_pending=args.max_pending,
                     request_timeout=args.request_timeout, io_timeout=args.io_timeout,
                     drain_grace=args.drain_grace, scheduler=scheduler,
                     slo=slo, snapshot_dir=args.snapshot_dir, handoff=args.handoff,
                     handoff_ttl=args.handoff_ttl)
    if args.snapshot_dir:
        state.restore_snapshot()
    return state


def parse_args(argv):
    """The server's flags: the CLI's parser without a positional mode;
    flags of the JAX server that the port does not carry exit naming
    them."""
    from ..cli import build_parser, check_q40_variant, not_ported
    args = build_parser().parse_args(["inference", *argv])
    missing = not_ported(args, server=True)
    if missing:
        raise SystemExit(f"not yet ported to dllama_tpu_torch: {', '.join(missing)} "
                         "(run python -m dllama_tpu.server.api for these)")
    if args.coordinator or args.nproc is not None or args.proc_id is not None:
        raise SystemExit("the API server does not run over a process group "
                         "(--coordinator/--nproc/--proc-id): serve with --workers tpu:N "
                         "in one process")
    check_q40_variant()
    return args


def start(argv, stack=None) -> ApiServer:
    """Load and serve on a background thread (in-process callers: tests and
    ``chip_smoke.py``); :func:`stop` ends it.  ``--port 0`` binds a free
    port; ``stack`` as in :func:`build_state`."""
    from ..cli import configure_obs
    args = parse_args(list(argv))
    slo = configure_obs(args)
    return serve(build_state(args, slo, stack), host=args.host, port=args.port,
                 block=False)


def stop(server: ApiServer) -> None:
    """Stop serving; a draining server then saves its snapshot
    (``--snapshot-dir``) as a blocking :func:`serve` does."""
    server.shutdown()
    server.server_close()
    if server.state.draining:
        server.state.save_snapshot()
    if server.state.scheduler is not None:
        server.state.scheduler.close()


def main(argv=None):
    import sys

    from ..cli import configure_obs
    args = parse_args(list(sys.argv[1:] if argv is None else argv))
    slo = configure_obs(args)
    if slo is not None:
        _log.info("slo_enabled", extra={"spec": slo.spec_display,
                                        "windows": [w for w, _ in slo.windows]})
    state = build_state(args, slo)
    try:
        serve(state, host=args.host, port=args.port)
    finally:
        if state.scheduler is not None:
            state.scheduler.close()
        if slo is not None:
            print(slo.summary_line())


if __name__ == "__main__":
    main()
