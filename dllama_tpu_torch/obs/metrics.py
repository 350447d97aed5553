"""Process-global metric registry with two expositions (JSON and
Prometheus) — a trimmed copy of ``dllama_tpu/obs/metrics.py``.

One :class:`Registry` (:data:`REGISTRY`) holds every counter, gauge and
histogram of the process: the server's ``ServerMetrics`` view, the
scheduler's and the engine's.  :func:`snapshot_json` is the ``/metrics``
JSON dict (counters seeded at import, histograms as ``{"count", "sum",
"avg", "buckets"}``, a ``schema_version``); :func:`render_prometheus` is
text exposition format 0.0.4.  The families are the ones the port feeds,
each with the JAX package's name, type, help and buckets; a family of a
feature the port lacks (the fleet router, the degrade ledger, compile
telemetry) comes with that feature.

Thread-safe (one small lock a metric) and stdlib-only.
"""

from __future__ import annotations

import bisect
import threading
import time

#: bumped when a key changes meaning or shape in the JSON exposition
SCHEMA_VERSION = 2


def _fmt(v: float) -> str:
    """Prometheus-style number rendering: integral values print without a
    trailing ``.0`` (``le="2.5"`` but ``le="1"``), everything else as the
    shortest round-tripping float."""
    f = float(v)
    if f == float("inf"):
        return "+Inf"
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


class Counter:
    """Monotonically increasing count."""

    kind = "counter"

    def __init__(self, name: str, json_key: str, help: str = ""):
        self.name = name
        self.json_key = json_key
        self.help = help
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0

    def json_value(self):
        return self.value

    def render(self, lines: list[str]) -> None:
        if self.help:
            lines.append(f"# HELP {self.name} {_escape_help(self.help)}")
        lines.append(f"# TYPE {self.name} counter")
        lines.append(f"{self.name} {_fmt(self.value)}")


class Gauge:
    """A value that goes up and down (or is computed at read time via
    ``fn`` — e.g. uptime)."""

    kind = "gauge"

    def __init__(self, name: str, json_key: str, help: str = "", fn=None):
        self.name = name
        self.json_key = json_key
        self.help = help
        self.fn = fn
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def add(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        if self.fn is not None:
            return float(self.fn())
        with self._lock:
            return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0.0

    def json_value(self):
        return round(self.value, 6)

    def render(self, lines: list[str]) -> None:
        if self.help:
            lines.append(f"# HELP {self.name} {_escape_help(self.help)}")
        lines.append(f"# TYPE {self.name} gauge")
        lines.append(f"{self.name} {_fmt(self.value)}")


class LabeledCounter:
    """A counter family: one Prometheus metric name, one sample per label
    value (``dllama_q40_degrade_total{reason="probe_failed"} 2``).  The
    JSON exposition is a dict keyed by the label value (multi-label
    children join their values with ``/``).  Children are created on
    first increment — a scrape between registration and the first event
    sees an empty family, which Prometheus accepts."""

    kind = "counter"

    def __init__(self, name: str, json_key: str, labels, help: str = ""):
        self.name = name
        self.json_key = json_key
        self.help = help
        self.labels = (labels,) if isinstance(labels, str) else tuple(labels)
        self._lock = threading.Lock()
        self._children: dict[tuple, float] = {}

    def inc(self, *values, n: float = 1) -> None:
        if len(values) != len(self.labels):
            raise ValueError(f"{self.name} takes {len(self.labels)} label "
                             f"value(s) {self.labels}, got {values!r}")
        key = tuple(str(v) for v in values)
        with self._lock:
            self._children[key] = self._children.get(key, 0) + n

    def get(self, *values):
        key = tuple(str(v) for v in values)
        with self._lock:
            return self._children.get(key, 0)

    @property
    def total(self):
        with self._lock:
            return sum(self._children.values())

    def reset(self) -> None:
        # test isolation parity with Counter.reset: drop the samples (a
        # zeroed-but-present label would survive into unrelated tests)
        with self._lock:
            self._children.clear()

    def json_value(self):
        with self._lock:
            return {"/".join(k): (v if isinstance(v, int) else round(v, 6))
                    for k, v in sorted(self._children.items())}

    def render(self, lines: list[str]) -> None:
        if self.help:
            lines.append(f"# HELP {self.name} {_escape_help(self.help)}")
        lines.append(f"# TYPE {self.name} counter")
        with self._lock:
            items = sorted(self._children.items())
        for values, count in items:
            lbl = ",".join(f'{l}="{v}"' for l, v in zip(self.labels, values))
            lines.append(f"{self.name}{{{lbl}}} {_fmt(count)}")


class LabeledGauge:
    """A gauge family (one sample per label-value combination; ``label``
    may be a single label name or a tuple of names).  ``fn`` — when set —
    computes the whole family at read time as a ``{label_value: number}``
    dict (e.g. per-device HBM stats queried at scrape); an empty dict
    means the backend has no data and the family renders no samples
    (graceful absence, never a fake zero)."""

    kind = "gauge"

    def __init__(self, name: str, json_key: str, label, help: str = "",
                 fn=None):
        self.name = name
        self.json_key = json_key
        self.labels = (label,) if isinstance(label, str) else tuple(label)
        self.help = help
        self.fn = fn
        self._lock = threading.Lock()
        self._values: dict[tuple, float] = {}

    @property
    def label(self) -> str:  # back-compat for single-label callers
        return self.labels[0]

    def set(self, *args) -> None:
        """``set(label_value, ..., v)`` — the last positional is the value,
        everything before it is one value per label."""
        *values, v = args
        if len(values) != len(self.labels):
            raise ValueError(f"{self.name} takes {len(self.labels)} label "
                             f"value(s) {self.labels}, got {values!r}")
        key = tuple(str(x) for x in values)
        with self._lock:
            self._values[key] = float(v)

    def get(self, *values) -> float:
        key = tuple(str(x) for x in values)
        with self._lock:
            return self._values.get(key, 0.0)

    def _items(self) -> dict[tuple, float]:
        if self.fn is not None:
            try:
                return {(str(k),) if not isinstance(k, tuple)
                        else tuple(str(x) for x in k): float(v)
                        for k, v in (self.fn() or {}).items()}
            except Exception:
                return {}
        with self._lock:
            return dict(self._values)

    def values(self) -> dict:
        """Single-label families keep their historical flat-string keys;
        multi-label families join label values with ``/``."""
        if len(self.labels) == 1:
            return {k[0]: v for k, v in self._items().items()}
        return {"/".join(k): v for k, v in self._items().items()}

    def reset(self) -> None:
        with self._lock:
            self._values.clear()

    def json_value(self):
        return {k: round(v, 6) for k, v in sorted(self.values().items())}

    def render(self, lines: list[str]) -> None:
        if self.help:
            lines.append(f"# HELP {self.name} {_escape_help(self.help)}")
        lines.append(f"# TYPE {self.name} gauge")
        for k, v in sorted(self._items().items()):
            lbl = ",".join(f'{l}="{x}"' for l, x in zip(self.labels, k))
            lines.append(f"{self.name}{{{lbl}}} {_fmt(v)}")


class Histogram:
    """Fixed-bucket histogram (Prometheus semantics: cumulative buckets,
    an implicit ``+Inf`` bucket, ``sum`` and ``count`` series).

    Buckets are chosen at registration and never change — fixed buckets
    make ``observe`` an O(log n_buckets) bisect plus two adds under one
    lock, cheap enough for the per-token emit path."""

    kind = "histogram"

    def __init__(self, name: str, json_key: str, buckets, help: str = ""):
        ups = sorted(float(b) for b in buckets)
        if not ups:
            raise ValueError(f"histogram {name!r} needs at least one bucket")
        self.name = name
        self.json_key = json_key
        self.help = help
        self.uppers = tuple(ups)
        self._lock = threading.Lock()
        self._counts = [0] * (len(ups) + 1)  # last slot = +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        i = bisect.bisect_left(self.uppers, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    def snapshot(self) -> tuple[list[int], float, int]:
        """(cumulative_counts incl. +Inf, sum, count) — one consistent
        view (a concurrent ``observe`` lands wholly before or after)."""
        with self._lock:
            raw = list(self._counts)
            total, count = self._sum, self._count
        cum, acc = [], 0
        for c in raw:
            acc += c
            cum.append(acc)
        return cum, total, count

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * len(self._counts)
            self._sum = 0.0
            self._count = 0

    def json_value(self):
        cum, total, count = self.snapshot()
        labels = [_fmt(u) for u in self.uppers] + ["+Inf"]
        return {"count": count, "sum": round(total, 6),
                "avg": round(total / count, 6) if count else 0.0,
                "buckets": dict(zip(labels, cum))}

    def render(self, lines: list[str]) -> None:
        if self.help:
            lines.append(f"# HELP {self.name} {_escape_help(self.help)}")
        lines.append(f"# TYPE {self.name} histogram")
        cum, total, count = self.snapshot()
        for upper, c in zip(list(self.uppers) + [float("inf")], cum):
            lines.append(f'{self.name}_bucket{{le="{_fmt(upper)}"}} {c}')
        lines.append(f"{self.name}_sum {_fmt(round(total, 9))}")
        lines.append(f"{self.name}_count {count}")


class Registry:
    """Named metric collection with get-or-create registration.

    ``json_key`` is the flat key in the JSON exposition (the pre-registry
    ``/metrics`` names); the Prometheus ``name`` derives from it
    (``dllama_<key>`` + ``_total`` for counters) unless given explicitly
    — e.g. when the JSON key predates unit-suffix conventions."""

    def __init__(self):
        self._lock = threading.Lock()
        self._by_name: dict[str, object] = {}
        self._by_json: dict[str, object] = {}
        self.started_at = time.time()

    def _register(self, cls, json_key: str, name: str | None, args, kwargs):
        name = name or ("dllama_" + json_key
                        + ("_total" if cls.kind == "counter" else ""))
        with self._lock:
            existing = self._by_json.get(json_key) or self._by_name.get(name)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise ValueError(
                        f"metric {json_key!r} already registered as "
                        f"{existing.kind}, not {cls.kind}")
                return existing
            m = cls(name, json_key, *args, **kwargs)
            self._by_name[name] = m
            self._by_json[json_key] = m
            return m

    def counter(self, json_key: str, help: str = "",
                name: str | None = None) -> Counter:
        return self._register(Counter, json_key, name, (help,), {})

    def gauge(self, json_key: str, help: str = "", name: str | None = None,
              fn=None) -> Gauge:
        return self._register(Gauge, json_key, name, (help,), {"fn": fn})

    def histogram(self, json_key: str, buckets, help: str = "",
                  name: str | None = None) -> Histogram:
        return self._register(Histogram, json_key, name, (buckets, help), {})

    def labeled_counter(self, json_key: str, labels, help: str = "",
                        name: str | None = None) -> LabeledCounter:
        return self._register(LabeledCounter, json_key, name, (labels, help),
                              {})

    def labeled_gauge(self, json_key: str, label, help: str = "",
                      name: str | None = None, fn=None) -> LabeledGauge:
        g = self._register(LabeledGauge, json_key, name, (label, help), {})
        if fn is not None:
            # get-or-create may return an earlier registration; the newest
            # reader wins (an Engine re-init re-binds the device query)
            g.fn = fn
        return g

    def metrics(self) -> list:
        with self._lock:
            return list(self._by_name.values())

    def snapshot_json(self) -> dict:
        out = {"schema_version": SCHEMA_VERSION,
               "uptime_s": round(time.time() - self.started_at, 3)}
        for m in self.metrics():
            out[m.json_key] = m.json_value()
        return out

    def render_prometheus(self) -> str:
        lines = [
            "# HELP dllama_uptime_seconds Seconds since process metrics init.",
            "# TYPE dllama_uptime_seconds gauge",
            f"dllama_uptime_seconds {_fmt(round(time.time() - self.started_at, 3))}",
        ]
        for m in self.metrics():
            m.render(lines)
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Zero every metric (test isolation; registration survives)."""
        for m in self.metrics():
            m.reset()


#: THE process-global registry both exposition paths read.
REGISTRY = Registry()


def snapshot_json() -> dict:
    return REGISTRY.snapshot_json()


def render_prometheus() -> str:
    return REGISTRY.render_prometheus()


# -- standard buckets
# Latency buckets span cold-start tails (a first request can take tens of
# seconds) down to sub-ms steady-state inter-token gaps.
TTFT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                1.0, 2.5, 5.0, 10.0, 30.0, 60.0)
INTER_TOKEN_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                       0.1, 0.25, 0.5, 1.0, 2.5)
DURATION_BUCKETS = (0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                    10.0, 30.0, 60.0, 120.0, 300.0)
STEP_MS_BUCKETS = (0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500,
                   1000, 2500, 5000)
BYTES_BUCKETS = (256, 1024, 4096, 16384, 65536, 262144,
                 1048576, 4194304, 16777216)


# -- standard metrics, seeded at import -----------------------------------
# Seeding keeps every exported key present from boot (a counter that
# appears only after its first event reads as "metric missing" to a
# dashboard, not "zero").

# serving counters (server/api.py ServerMetrics is a view over these)
REQUESTS_SERVED = REGISTRY.counter(
    "requests_served", "Requests completed successfully.")
REQUESTS_REJECTED_429 = REGISTRY.counter(
    "requests_rejected_429", "Requests rejected by bounded admission.")
REQUESTS_REJECTED_503 = REGISTRY.counter(
    "requests_rejected_503", "Requests rejected while draining.")
READ_TIMEOUTS_408 = REGISTRY.counter(
    "read_timeouts_408", "Request bodies that stalled past --io-timeout.")
DEADLINE_TIMEOUTS = REGISTRY.counter(
    "deadline_timeouts", "Requests truncated by their deadline.")
CLIENT_DISCONNECTS = REGISTRY.counter(
    "client_disconnects", "Clients that vanished mid-request.")
SERVER_ERRORS = REGISTRY.counter(
    "server_errors", "Requests that failed with a 500.")
AVG_REQUEST_S = REGISTRY.gauge(
    "avg_request_s", "EMA request duration (feeds Retry-After).",
    name="dllama_request_duration_ema_seconds")

# artifact-integrity counters (io/integrity.py delegates here)
SNAPSHOT_RESTORES = REGISTRY.counter(
    "snapshot_restores", "Engine warm starts restored from a snapshot.")

# request-path histograms (server/api.py)
TTFT = REGISTRY.histogram(
    "ttft_seconds", TTFT_BUCKETS,
    "Time from request admission to the first emitted delta.")
INTER_TOKEN = REGISTRY.histogram(
    "inter_token_seconds", INTER_TOKEN_BUCKETS,
    "Gap between consecutive emitted deltas of one request.")
QUEUE_WAIT = REGISTRY.histogram(
    "queue_wait_seconds", TTFT_BUCKETS,
    "Time an admitted request waited for the engine mutex.")
REQUEST_DURATION = REGISTRY.histogram(
    "request_duration_seconds", DURATION_BUCKETS,
    "Whole-request wall time, admission to completion.")

# engine-step histograms (runtime/engine.py; the reference's G/I/T
# contract: per-token values, chunk averages for the on-device decode)
ENGINE_GENERATION_MS = REGISTRY.histogram(
    "engine_generation_ms", STEP_MS_BUCKETS,
    "Per-token whole-step wall time (G), milliseconds.")
ENGINE_INFERENCE_MS = REGISTRY.histogram(
    "engine_inference_ms", STEP_MS_BUCKETS,
    "Per-token device execution time (I), milliseconds.")
ENGINE_TRANSFER_MS = REGISTRY.histogram(
    "engine_transfer_ms", STEP_MS_BUCKETS,
    "Per-token host<->device boundary time (T), milliseconds.")
HOST_DEVICE_SENT_BYTES = REGISTRY.histogram(
    "host_device_sent_bytes", BYTES_BUCKETS,
    "Host->device bytes per engine dispatch (tokens + scalars).")
HOST_DEVICE_RECV_BYTES = REGISTRY.histogram(
    "host_device_recv_bytes", BYTES_BUCKETS,
    "Device->host bytes per engine fetch (logits or token ids).")

# kernel-dispatch ledger (obs/dispatch.py; read from the kernels' launch
# counters at each scrape)
MATMUL_DISPATCH = REGISTRY.labeled_counter(
    "matmul_dispatch", ("codec", "path"),
    "Matmul dispatch decisions by codec (q40/q8/dense) and executed path "
    "(pallas-fused, pallas-blocked, xla-dequant, dense).  Counted at "
    "trace time: one bump per compiled call site, not per decode step.")

# continuous-batching scheduler (runtime/scheduler.py)
SCHED_SLOTS_OCCUPIED = REGISTRY.gauge(
    "sched_slots_occupied", "Batch slots holding a live request.")
SCHED_QUEUE_DEPTH = REGISTRY.gauge(
    "sched_queue_depth", "Requests admitted but waiting for a free slot.")
SCHED_BATCH_EFFICIENCY = REGISTRY.gauge(
    "sched_batch_efficiency",
    "Live rows per lockstep step / batch slots (last dispatch).")
SCHED_SLOT_JOINS = REGISTRY.labeled_counter(
    "sched_slot_joins", ("slot",),
    "Requests admitted into a batch slot, by slot index.")
SCHED_SLOT_RETIRES = REGISTRY.labeled_counter(
    "sched_slot_retires", ("slot", "reason"),
    "Requests retired from a batch slot, by slot index and reason "
    "(stop/length/timeout/aborted/error/drain).")

# paged KV pool + radix prefix cache (runtime/pagepool.py, driven by the
# scheduler)
KV_PAGES_TOTAL = REGISTRY.gauge(
    "kv_pages_total",
    "Usable pages in the paged KV pool (page 0, the reserved scratch "
    "page, excluded).")
KV_PAGES_IN_USE = REGISTRY.gauge(
    "kv_pages_in_use",
    "KV pages currently referenced by live slots or the prefix cache.")
PREFIX_HITS = REGISTRY.counter(
    "prefix_hits",
    "Admissions whose prompt matched a cached prefix in the radix tree.")
PREFIX_TOKENS_REUSED = REGISTRY.counter(
    "prefix_tokens_reused",
    "Prompt tokens bound to shared KV pages instead of being "
    "re-prefilled.")
KV_POOL_EXHAUSTED = REGISTRY.counter(
    "kv_pool_exhausted",
    "Admissions deferred because the page pool had no free pages (the "
    "request waits queued until retirements free pages).")

# KV memory tiering (runtime/kvtier.py, --kv-reserve optimistic): under
# pressure a grow evicts cold radix entries and spills the idle-longest
# slot's pages to the pinned host pool; spilled slots page back in when
# pages free.  Spill and page-in counters are page-granular; the host-pool
# gauge is the live byte footprint of spilled KV.
KV_PAGES_SPILLED = REGISTRY.counter(
    "kv_pages_spilled",
    "KV pages copied device-to-host and freed by the tiering policy "
    "(--kv-reserve optimistic under pool pressure).")
KV_PAGES_PAGED_IN = REGISTRY.counter(
    "kv_pages_paged_in",
    "Spilled KV pages copied back host-to-device when their slot "
    "rejoined the dispatch.")
KV_SPILL_BYTES = REGISTRY.counter(
    "kv_spill_bytes",
    "Bytes of KV page data moved device-to-host by spills (values plus "
    "per-position scale planes for int8 pages).")
KV_HOST_POOL_BYTES = REGISTRY.gauge(
    "kv_host_pool_bytes",
    "Bytes of spilled KV currently resident in the host-RAM pool "
    "(bounded by --kv-host-pool-mb).")
KV_PAGE_CODEC = REGISTRY.labeled_gauge(
    "kv_page_codec", "codec",
    "Active paged-KV page format (1 for the engine's codec: the pool "
    "dtype, e.g. bfloat16, or int8 under --kv-quant int8).")

# device-memory telemetry: per-card gauges, read at scrape time from
# torch.cuda (runtime/engine.py binds the readers); a CPU process exposes
# an empty family, not zeros
HBM_BYTES_IN_USE = REGISTRY.labeled_gauge(
    "hbm_bytes_in_use", "device",
    "Per-device HBM bytes currently allocated (jax memory_stats).")
HBM_BYTES_PEAK = REGISTRY.labeled_gauge(
    "hbm_bytes_peak", "device",
    "Per-device peak HBM bytes allocated since process start.")

# performance economics (obs/cost.py): the analytic roofline model's
# FLOPs / bytes-moved per dispatch family, per-class chip-time
# attribution, and the MFU/MBU utilization gauges (achieved rate over
# the per-backend peak table).  Bumped by the scheduler at dispatch-land
# time through the ledger seam (dispatch.record_cost).
DISPATCH_FLOPS = REGISTRY.labeled_counter(
    "dispatch_flops", ("codec", "path", "phase"),
    "Model FLOPs per analytic dispatch family: weight codec or KV codec, "
    "cost path (matmul / attention / paged-gather / paged-decode / "
    "paged-fused / tp-ring), and request phase (prefill / decode / "
    "verify).")
DISPATCH_BYTES = REGISTRY.labeled_counter(
    "dispatch_bytes", ("codec", "path", "phase"),
    "Bytes moved per analytic dispatch family (same labels as "
    "dispatch_flops): packed weight reads, KV reads+writes (page-"
    "granular when paged), and TP ring all-reduce hop bytes.")
CLASS_CHIP_MS = REGISTRY.labeled_counter(
    "class_chip_ms", "class",
    "Chip-time attributed to retired+live requests by QoS class "
    "(interactive / standard / batch): each dispatch's wall pro-rated "
    "across its occupied rows — cost-per-tenant as a scrape.")
MFU = REGISTRY.gauge(
    "mfu",
    "Model FLOPs utilization: achieved FLOP/s over dispatch wall divided "
    "by the backend peak (obs/cost.py peak table; CPU measures once).")
MBU = REGISTRY.gauge(
    "mbu",
    "Memory-bandwidth utilization: achieved HBM bytes/s over dispatch "
    "wall divided by the backend peak (TP ring bytes excluded).")

# speculative decoding (runtime/spec.py proposers + the scheduler's
# ragged verify bursts, --spec).  Proposed counts drafts fed into verify
# dispatches; accepted counts the leading drafts the target model's own
# argmax confirmed.  accepted/proposed is the acceptance rate that sets
# the speedup (each accepted draft is one extra token per weight read).
SCHED_SPEC_PROPOSED = REGISTRY.counter(
    "sched_spec_proposed",
    "Draft tokens proposed into slot-verify dispatches (--spec).")
SCHED_SPEC_ACCEPTED = REGISTRY.labeled_counter(
    "sched_spec_accepted", ("proposer",),
    "Proposed draft tokens the verify step accepted, by proposer "
    "(pld / draft).")
SCHED_SPEC_ACCEPT_RATIO = REGISTRY.gauge(
    "sched_spec_accept_ratio",
    "Cumulative accepted/proposed draft-token ratio since start "
    "(0 until the first proposal; collapses toward 0 under a reject "
    "storm while served bytes stay exact).")

# scheduler goodput accounting: every millisecond between the scheduler's
# first and last dispatch lands in exactly one component, so the family
# sums to the measured wall time
HOST_GAP_MS_BUCKETS = (0.1, 0.25, 0.5, 1, 2.5, 5, 10, 25, 50, 100,
                       250, 1000)
SCHED_STEP_TIME_MS = REGISTRY.labeled_counter(
    "sched_step_time_ms", ("component",),
    "Scheduler wall-time decomposition in milliseconds, by component "
    "(prefill|decode|pad|host_gap|idle).")
SCHED_GOODPUT_RATIO = REGISTRY.gauge(
    "sched_goodput_ratio",
    "Fraction of scheduler wall time spent on live rows "
    "((prefill+decode) / all components), cumulative since start.")
SCHED_HOST_GAP_MS = REGISTRY.histogram(
    "sched_host_gap_ms", HOST_GAP_MS_BUCKETS,
    "Host-side gap between consecutive scheduler dispatches (ms), "
    "excluding idle sleep — the dispatch overhead ROADMAP item 3 "
    "(on-device multi-step decode) would amortize.")

# overlapped dispatch pipeline (runtime/scheduler.py, on unless
# --no-sched-overlap)
SCHED_OVERLAP_RATIO = REGISTRY.gauge(
    "sched_overlap_ratio",
    "Fraction of scheduler dispatches enqueued while their predecessor "
    "was still in flight (cumulative since start).")
SCHED_INFLIGHT_DEPTH = REGISTRY.gauge(
    "sched_inflight_depth",
    "Scheduler dispatches enqueued on device but not yet landed "
    "(2 while the pipeline is full, 0 after a flush).")
SCHED_HOST_GAP_HIDDEN_MS = REGISTRY.counter(
    "sched_host_gap_hidden_ms",
    "Host-side dispatch-gap milliseconds hidden behind device execution "
    "by the overlapped pipeline (reported separately, never double-"
    "counted into sched_step_time_ms components).")
SCHED_OVERLAP_DISCARDS = REGISTRY.counter(
    "sched_overlap_discards",
    "Pipelined dispatches landed and thrown away at a pipeline flush "
    "point (admission, retire, cancel/deadline, drain, hand-off export).")

# multi-tenant QoS (runtime/scheduler.py preemption + server shedding).
# A higher-priority request that cannot admit evicts the lowest-priority
# longest-remaining slot through the DLREQ01 export path and parks the
# record; the server sheds low-priority admissions while the SLO error
# budget burns.
SCHED_PREEMPTIONS = REGISTRY.labeled_counter(
    "sched_preemptions", ("reason",),
    "Slot preemptions triggered by a higher-priority request, by trigger "
    "(no_free_slot / pool_exhausted).")
SCHED_PREEMPT_PARKED = REGISTRY.gauge(
    "sched_preempt_parked",
    "Preempted requests currently parked as DLREQ01 records awaiting "
    "re-admission (RAM or --preempt-spill-dir).")
ADMISSIONS_SHED = REGISTRY.labeled_counter(
    "admissions_shed", ("class",),
    "Admissions refused (429) by SLO-driven shedding, per priority class "
    "(batch sheds on a fast-window burn, standard only while violating; "
    "interactive is never shed).")

# per-request KV hand-off (runtime/scheduler.py export/import + server
# /admin/export/<rid> and /admin/import)
HANDOFF_EXPORTS = REGISTRY.counter(
    "handoff_exports",
    "Hand-off records fetched from this replica via /admin/export "
    "(one per drained in-flight request picked up by the router).")
HANDOFF_IMPORTS = REGISTRY.counter(
    "handoff_imports",
    "Hand-off records accepted via /admin/import and resumed in a "
    "local batch slot.")
HANDOFF_IMPORT_REJECTS = REGISTRY.counter(
    "handoff_import_rejects",
    "Hand-off records refused at /admin/import (geometry fingerprint "
    "mismatch or corrupt/invalid record).")
HANDOFF_EXPIRED = REGISTRY.counter(
    "handoff_expired",
    "Parked DLREQ01 export records dropped unclaimed after "
    "--handoff-ttl (the router that triggered the drain never fetched "
    "them).")

# SLO burn-rate engine (obs/slo.py)
SLO_BURN_RATE = REGISTRY.labeled_gauge(
    "slo_burn_rate", ("objective", "window"),
    "Error-budget burn rate per objective and rolling window "
    "(>= 1.0 means the budget is being spent faster than allowed).")
SLO_VIOLATIONS = REGISTRY.labeled_counter(
    "slo_violations", ("objective",),
    "Transitions of an objective into the violating state (all windows "
    "burning >= 1.0) since process start.")

# event journal (obs/events.py)
POD_EVENTS = REGISTRY.labeled_counter(
    "pod_events", ("kind",),
    "Structured events appended to this process's event journal "
    "(/debug/events), by kind: spawn, death, respawn, quarantine, "
    "eject, readmit, retire, scale, reshape, handoff, resume, "
    "preempt.")
