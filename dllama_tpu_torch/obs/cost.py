"""Analytic roofline cost model for the slot scheduler's dispatches — a
copy of ``dllama_tpu/obs/cost.py`` with the H100's peaks.

Each landed dispatch's FLOPs and bytes moved come from the model config
and the dispatch's shape alone (no device counter, no profiler), so the
accounting adds no work on the card.  The scheduler calls
:meth:`CostModel.dispatch_cost` once a landed dispatch and:

* bumps ``dllama_dispatch_flops_total`` / ``dllama_dispatch_bytes_total``
  ``{codec, path, phase}`` (:func:`.dispatch.record_cost`),
* pro-rates chip time and FLOPs over the occupied rows into each request's
  flight-record cost block and ``dllama_class_chip_ms_total{class}``,
* feeds :data:`TRACKER`, whose achieved FLOP/s and bytes/s over the
  dispatch wall, divided by the card's peaks, are the ``dllama_mfu`` /
  ``dllama_mbu`` gauges.

The model (the JAX package's, to the integer):

* matmul FLOPs: ``2 * tokens * params_touched`` over the seven per-layer
  projections plus the logits head for every sampled or verified
  position; norms, rotary and elementwise work are left out (<< 1 %);
* attention FLOPs: ``4 * dim * ctx`` a query token a layer;
* weight bytes: the packed size of every matmul weight (Q40 18 B, Q80 34 B
  a 32-weight block, dense ``itemsize`` a weight), read once a forward;
* KV bytes: a position's write plus the context read a layer (int8: 1 B
  values plus the f32 scale planes; paged reads round up to whole pages);
* TP all-reduce bytes: ``2 * (tp-1) * elems * 4`` a reduce, two a layer a
  token, on their own ``tp-ring`` path and left out of MBU.

Peaks (:func:`peaks`): ``DLLAMA_PEAK_FLOPS`` / ``DLLAMA_PEAK_BYTES_S``
first, then :data:`GPU_PEAKS` by a substring of the card's name, then, on
the CPU, a once-measured microbenchmark; any other card has no peaks
(``source: "none"``) and its gauges stay 0.  :func:`summary` (``/health``
``perf``) adds the card's name and power limit.

Import contract: stdlib-only at import, like every ``obs`` module; numpy,
torch and ``nvidia-smi`` are reached inside the functions that need them.
"""

from __future__ import annotations

import os
import subprocess
import threading
import time

# Q40/Q80 packed-block geometry (quants.py; plain ints here so importing
# obs pulls nothing)
_BLOCK = 32
_CODEC_BLOCK_BYTES = {"q40": 18, "q8": 34}

#: per-card peaks, matched by substring of ``torch.cuda.get_device_name`` —
#: (dense bf16 FLOP/s, HBM bytes/s).  NVIDIA's H100 data sheet, the SXM
#: part (80 GB HBM3, 700 W), dense rates; no other card is listed, so a
#: PCIe or NVL part reads ``source: "none"`` rather than a guess
GPU_PEAKS = (
    ("NVIDIA H100 80GB HBM3", 989.4e12, 3.35e12),
)

_lock = threading.Lock()
_device_kind: str | None = None
_platform: str | None = None
_device_index: int | None = None
_peaks_cache: dict | None = None
_card_cache: dict | None = None
_cpu_measured: tuple[float, float] | None = None


def set_backend(device_kind: str | None, platform: str | None,
                index: int | None = None) -> None:
    """Bind the device the peak lookup keys on: its name
    (``torch.cuda.get_device_name``), its platform (``cuda`` or ``cpu``)
    and, on a card, its index (called by :func:`model_from_engine`)."""
    global _device_kind, _platform, _device_index, _peaks_cache, _card_cache
    with _lock:
        _device_kind = device_kind
        _platform = platform
        _device_index = index
        _peaks_cache = None
        _card_cache = None


def _measure_cpu_peaks() -> tuple[float, float]:
    """Measured-once CPU fallback: a small f32 GEMM for FLOP/s and a big
    array copy for memory bytes/s.  Crude (one shape, one trial kept), but
    it anchors MFU/MBU to this host instead of pretending a CPU has a
    card's peaks.  DLLAMA_PEAK_FLOPS / DLLAMA_PEAK_BYTES_S override it
    where determinism matters (tests)."""
    global _cpu_measured
    if _cpu_measured is not None:
        return _cpu_measured
    import numpy as np
    n = 384
    a = np.random.default_rng(0).standard_normal((n, n), np.float32)
    b = a.T.copy()
    a @ b  # warm
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        a @ b
        best = min(best, time.perf_counter() - t0)
    flops = 2 * n ** 3 / max(best, 1e-9)
    buf = np.zeros(32 << 20, np.uint8)
    t0 = time.perf_counter()
    buf.copy()
    dt = max(time.perf_counter() - t0, 1e-9)
    bps = 2.0 * buf.nbytes / dt  # one read + one write stream
    _cpu_measured = (flops, bps)
    return _cpu_measured


def peaks() -> dict:
    """``{"flops", "bytes_per_s", "source", "device"}`` for the bound
    device: the env override first (``source: "env"``), then the card
    table (``"table"``), then the CPU microbenchmark (``"measured"``);
    ``None`` peaks and ``"none"`` when nothing matched (gauges stay 0
    rather than lie)."""
    global _peaks_cache
    with _lock:
        if _peaks_cache is not None:
            return _peaks_cache
        kind, platform = _device_kind, _platform
    env_f = os.environ.get("DLLAMA_PEAK_FLOPS")
    env_b = os.environ.get("DLLAMA_PEAK_BYTES_S")
    out = None
    if env_f or env_b:
        out = {"flops": float(env_f) if env_f else None,
               "bytes_per_s": float(env_b) if env_b else None,
               "source": "env", "device": kind or platform}
    elif kind:
        for sub, fl, bp in GPU_PEAKS:
            if sub in kind:
                out = {"flops": fl, "bytes_per_s": bp,
                       "source": "table", "device": kind}
                break
    if out is None and platform == "cpu":
        try:
            fl, bp = _measure_cpu_peaks()
            out = {"flops": fl, "bytes_per_s": bp,
                   "source": "measured", "device": kind or "cpu"}
        except Exception:  # numpy missing: stay peakless
            out = None
    if out is None:
        out = {"flops": None, "bytes_per_s": None,
               "source": "none", "device": kind or platform}
    with _lock:
        _peaks_cache = out
    return out


def card() -> dict:
    """The bound card's ``{"name", "power_limit"}``: the name from
    ``torch.cuda``, the power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints it; ``None`` for what
    cannot be read (the CPU, no ``nvidia-smi``).  Read once a binding."""
    global _card_cache
    with _lock:
        if _card_cache is not None:
            return _card_cache
        platform, index = _platform, _device_index
    out = {"name": None, "power_limit": None}
    if platform == "cuda":
        try:
            import torch
            out["name"] = torch.cuda.get_device_name(index or 0)
        except Exception:
            pass
        try:
            r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader", "-i", str(index or 0)],
                               capture_output=True, text=True, timeout=10)
            line = r.stdout.strip().splitlines()[0] if r.returncode == 0 else ""
            if "," in line:
                out["power_limit"] = line.rsplit(",", 1)[1].strip()
        except Exception:
            pass
    with _lock:
        _card_cache = out
    return out


class PerfTracker:
    """Cumulative achieved work over cumulative dispatch wall, the
    denominators MFU/MBU need.  ``wall_ms`` is the full dispatch wall
    (the chip is busy for the whole lockstep step, padding included), so
    padding and short batches show up as lower utilization — which is
    the point."""

    def __init__(self):
        self._lock = threading.Lock()
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.wall_ms = 0.0

    def note(self, flops: float, hbm_bytes: float, wall_ms: float) -> None:
        with self._lock:
            self.flops += flops
            self.hbm_bytes += hbm_bytes
            self.wall_ms += wall_ms

    def _util(self, achieved: float, peak: float | None) -> float | None:
        with self._lock:
            wall_s = self.wall_ms / 1e3
        if not peak or wall_s <= 0:
            return None
        return achieved / wall_s / peak

    def mfu(self) -> float | None:
        with self._lock:
            f = self.flops
        return self._util(f, peaks()["flops"])

    def mbu(self) -> float | None:
        with self._lock:
            b = self.hbm_bytes
        return self._util(b, peaks()["bytes_per_s"])

    def snapshot(self) -> dict:
        with self._lock:
            out = {"flops_total": self.flops,
                   "hbm_bytes_total": self.hbm_bytes,
                   "chip_wall_ms": round(self.wall_ms, 3)}
        out["mfu"] = self.mfu()
        out["mbu"] = self.mbu()
        return out

    def reset(self) -> None:
        with self._lock:
            self.flops = self.hbm_bytes = 0.0
            self.wall_ms = 0.0


#: process-global tracker behind the dllama_mfu / dllama_mbu gauges
TRACKER = PerfTracker()


def summary() -> dict:
    """The ``/health`` perf block: utilization, cumulative work, the peak
    table entry it was divided by, and the card's name and power limit."""
    out = TRACKER.snapshot()
    out["peaks"] = peaks()
    out["card"] = card()
    try:
        from . import metrics as obs_metrics
        out["chip_ms_by_class"] = obs_metrics.CLASS_CHIP_MS.json_value()
    except Exception:
        out["chip_ms_by_class"] = {}
    return out


class CostModel:
    """FLOPs/bytes for one llama-family model at one serving config.

    Pure integer arithmetic per row (the tests hand-count it); only the
    dispatch-level weight-read split across phases divides.  ``rows``
    passed to :meth:`dispatch_cost` are ``(phase, pos, n_new)`` tuples —
    ``phase`` in {"prefill", "decode", "verify"}, ``pos`` the row's cache
    clock at enqueue, ``n_new`` the *useful* tokens it advanced (chunk
    width, burst steps, or 1 + drafts)."""

    def __init__(self, *, dim: int, hidden_dim: int, n_layers: int,
                 n_heads: int, n_kv_heads: int, vocab_size: int,
                 weight_codec: str = "dense", weight_el_bytes: int = 2,
                 kv_codec: str = "kv_f32", kv_el_bytes: int = 4,
                 tp: int = 1, paged: bool = False, page_size: int = 0,
                 n_experts: int = 0, n_active_experts: int = 0,
                 fused: bool = False):
        self.dim = dim
        self.hidden_dim = hidden_dim
        self.n_layers = n_layers
        self.n_heads = n_heads
        self.n_kv_heads = n_kv_heads
        self.vocab_size = vocab_size
        self.head_size = dim // n_heads
        self.kv_dim = self.head_size * n_kv_heads
        self.weight_codec = weight_codec
        self.weight_el_bytes = weight_el_bytes
        self.kv_codec = kv_codec
        self.kv_el_bytes = kv_el_bytes
        self.tp = max(1, int(tp))
        self.paged = paged
        self.page_size = int(page_size or 0)
        #: decode attention runs the fused page-walk Pallas kernel (one
        #: attention-family dispatch; same FLOPs/bytes, different family
        #: so MFU/MBU attribution matches the ledger path)
        self.fused = bool(fused)
        self.moe = n_experts > 0
        self.n_active_experts = n_active_experts

        ffn = 3 * dim * hidden_dim  # w1 + w2 + w3
        if self.moe:
            ffn *= n_active_experts
        attn = 2 * dim * dim + 2 * dim * self.kv_dim  # wq+wo, wk+wv
        #: matmul weights touched per token (logits head separate)
        self.params_per_token = n_layers * (attn + ffn)

    # --- building blocks (all return ints) -------------------------------

    def codec_bytes(self, n_params: int) -> int:
        """Stored bytes of ``n_params`` matmul weights under the weight
        codec (Q40 18 B per 32, Q80 34 B per 32, dense itemsize each)."""
        bb = _CODEC_BLOCK_BYTES.get(self.weight_codec)
        if bb is not None:
            return n_params // _BLOCK * bb
        return n_params * self.weight_el_bytes

    def weight_read_bytes(self) -> int:
        """Bytes to stream the full matmul weight set (incl. the logits
        head) through the chip once — one forward pass."""
        return (self.codec_bytes(self.params_per_token)
                + self.codec_bytes(self.dim * self.vocab_size))

    def matmul_flops(self, tokens: int) -> int:
        return 2 * tokens * self.params_per_token

    def logit_flops(self, n_positions: int) -> int:
        return 2 * n_positions * self.dim * self.vocab_size

    @staticmethod
    def _ctx_sum(pos: int, n_new: int) -> int:
        # sum of context lengths seen by the n_new query tokens:
        # (pos+1) + (pos+2) + ... + (pos+n_new)
        return n_new * pos + n_new * (n_new + 1) // 2

    def attn_flops(self, pos: int, n_new: int) -> int:
        """QK^T + weighted V sum: 4 * dim MACs -> FLOPs per (query,
        context) pair, per layer."""
        return 4 * self.dim * self.n_layers * self._ctx_sum(pos, n_new)

    def kv_pos_bytes(self) -> int:
        """Bytes one (k, v) position occupies in one layer."""
        if self.kv_codec == "kv_int8":
            # 1 B values + per-(head, position) f32 scale planes
            return 2 * (self.kv_dim + 4 * self.n_kv_heads)
        return 2 * self.kv_dim * self.kv_el_bytes

    def kv_write_bytes(self, n_new: int) -> int:
        return n_new * self.n_layers * self.kv_pos_bytes()

    def _read_positions(self, pos: int, n_new: int, burst: bool) -> int:
        def paged_up(c: int) -> int:
            if self.paged and self.page_size:
                return -(-c // self.page_size) * self.page_size
            return c
        if burst:
            # steps sequential single-token passes, each re-reading its
            # full context
            return sum(paged_up(pos + j + 1) for j in range(n_new))
        # one block forward over n_new tokens streams the final context
        return paged_up(pos + n_new)

    def kv_read_bytes(self, pos: int, n_new: int, burst: bool) -> int:
        return (self._read_positions(pos, n_new, burst)
                * self.n_layers * self.kv_pos_bytes())

    def ring_bytes(self, tokens: int) -> int:
        """Aggregate TP ring all-reduce hop bytes: two f32 reduces of
        ``dim`` per layer per token, ``2*(tp-1)`` hop copies per
        element across the ring."""
        if self.tp <= 1:
            return 0
        return tokens * self.n_layers * 2 * (2 * (self.tp - 1)) * self.dim * 4

    # --- per-dispatch assembly -------------------------------------------

    def row_cost(self, phase: str, pos: int, n_new: int) -> dict:
        """One row's own work (weight reads EXCLUDED — they are shared
        per pass and split at dispatch level)."""
        burst = phase == "decode"
        n_logits = 1 if phase == "prefill" else n_new
        flops = (self.matmul_flops(n_new) + self.logit_flops(n_logits)
                 + self.attn_flops(pos, n_new))
        kv = (self.kv_write_bytes(n_new)
              + self.kv_read_bytes(pos, n_new, burst))
        return {"phase": phase, "flops": flops, "kv_bytes": kv,
                "attn_flops": self.attn_flops(pos, n_new),
                "ring_bytes": self.ring_bytes(n_new)}

    def attn_path(self, phase: str) -> str:
        if not self.paged:
            return "attention"
        if phase == "decode":
            return "paged-fused" if self.fused else "paged-decode"
        return "paged-gather"

    def dispatch_cost(self, rows, steps: int = 1) -> dict:
        """Cost of one landed dispatch.

        ``rows``: ``(phase, pos, n_new)`` per occupied row; ``steps``:
        forward passes the dispatch ran (a decode burst re-reads weights
        every pass — callers pass the burst length, 1 otherwise).

        Returns ``{"entries": {(codec, path, phase): {"flops", "bytes"}},
        "per_row": [...], "flops": total, "hbm_bytes": total-minus-ring}``.
        """
        rows = [(p, int(pos), int(n)) for p, pos, n in rows]
        n_rows = max(1, len(rows))
        passes = max(1, int(steps))
        w_read = self.weight_read_bytes() * passes
        entries: dict[tuple, dict] = {}

        def bump(codec, path, phase, flops=0, nbytes=0):
            e = entries.setdefault((codec, path, phase),
                                   {"flops": 0, "bytes": 0})
            e["flops"] += flops
            e["bytes"] += nbytes

        per_row = []
        for phase, pos, n_new in rows:
            rc = self.row_cost(phase, pos, n_new)
            w_share = w_read / n_rows
            bump(self.weight_codec, "matmul", phase,
                 flops=rc["flops"] - rc["attn_flops"], nbytes=w_share)
            bump(self.kv_codec, self.attn_path(phase), phase,
                 flops=rc["attn_flops"], nbytes=rc["kv_bytes"])
            if rc["ring_bytes"]:
                bump(self.weight_codec, "tp-ring", phase,
                     nbytes=rc["ring_bytes"])
            per_row.append({"phase": phase, "flops": rc["flops"],
                            "hbm_bytes": w_share + rc["kv_bytes"]})
        flops = sum(e["flops"] for e in entries.values())
        hbm = sum(e["bytes"] for (c, path, p), e in entries.items()
                  if path != "tp-ring")
        return {"entries": entries, "per_row": per_row,
                "flops": flops, "hbm_bytes": hbm}


def model_from_engine(engine) -> CostModel | None:
    """Build a CostModel from a live engine — the weight codec from the
    placed params' types (``ops.q40.QTensor``/``BlockedQTensor``,
    ``ops.q8.Q8Tensor``), the KV codec from the cache planes, tp from the
    engine's mesh — and bind the peak lookup to its device.  ``fused``
    (the single-token paged read is kernel 7) holds for a paged engine on
    the card unless ``attn_impl`` is ``"plain"``.  Returns None rather than
    raise: cost accounting must never take serving down."""
    try:
        from ..ops import q8, q40
        from ..runtime import snapshot as snapfmt
        cfg = engine.cfg
        codec, el = "dense", 2
        vals = []
        for v in (engine.params or {}).values():
            vals.extend(v if isinstance(v, (list, tuple)) else [v])
        for v in vals:
            if isinstance(v, (q40.QTensor, q40.BlockedQTensor)):
                codec = "q40"
                break
            if isinstance(v, q8.Q8Tensor):
                codec = "q8"
                break
        else:
            for v in vals:
                if getattr(v, "ndim", 0) >= 2 and hasattr(v, "element_size"):
                    el = int(v.element_size())
                    break
        cache = engine.cache
        if cache.quantized:
            kv_codec, kv_el = "kv_int8", 1
        else:
            kv_el = int(cache.k.element_size())
            kv_codec = f"kv_{snapfmt.dtype_of(cache.k.dtype)}"
        dev = engine.device
        if dev.type == "cuda":
            import torch
            idx = dev.index if dev.index is not None else torch.cuda.current_device()
            set_backend(torch.cuda.get_device_name(idx), "cuda", idx)
        else:
            set_backend(None, dev.type)
        fused = bool(engine.paged and dev.type == "cuda"
                     and getattr(cfg, "attn_impl", "auto") != "plain")
        return CostModel(
            dim=cfg.dim, hidden_dim=cfg.hidden_dim, n_layers=cfg.n_layers,
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
            vocab_size=cfg.vocab_size, weight_codec=codec,
            weight_el_bytes=el, kv_codec=kv_codec, kv_el_bytes=kv_el,
            tp=engine.tp, paged=bool(engine.paged),
            page_size=getattr(engine, "kv_page_size", 0) or 0,
            n_experts=getattr(cfg, "n_experts", 0) or 0,
            n_active_experts=getattr(cfg, "n_active_experts", 0) or 0,
            fused=fused)
    except Exception:
        return None


def reset() -> None:
    """Test isolation: clear the tracker and the cached peaks and card."""
    global _peaks_cache, _card_cache
    TRACKER.reset()
    with _lock:
        _peaks_cache = None
        _card_cache = None
