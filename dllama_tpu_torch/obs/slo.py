"""Declarative latency/error SLOs with rolling multi-window burn rates —
a copy of ``dllama_tpu/obs/slo.py``.

An operator states targets once (``--slo
"ttft_p95=1500ms,itl_p99=120ms,error_rate=0.5%"`` or ``DLLAMA_SLO``) and
the engine turns the registry's already-recorded histograms and counters
into the standard SRE question: *how fast is the error budget burning?*

Grammar::

    spec      := objective ("," objective)*
    objective := METRIC "_p" QUANTILE "=" DURATION      # latency
               | "error_rate" "=" PERCENT               # availability
    METRIC    := "ttft" | "itl" | "queue_wait" | "duration" | "step"
    DURATION  := number ["ms" | "s"]                    # bare => ms
    PERCENT   := number ["%"]                           # bare => fraction

Burn-rate math (Google SRE workbook, multiwindow): a latency objective
``ttft_p95=1500ms`` allows 5% of requests to exceed 1.5 s.  Over each
rolling window the engine computes ``bad/total`` from deltas of the
histogram's cumulative counts and divides by the allowed fraction::

    burn(window) = (bad_in_window / total_in_window) / (1 - quantile)

``burn == 1.0`` spends the budget exactly as fast as the objective
permits; ``burn >= 1.0`` on *all* windows is **violating** (the long
window proves sustained damage, the short window clears quickly after
recovery — the same fast-recall/fast-reset pairing production alerting
uses); ``>= 1.0`` on only some windows is **at-risk**; otherwise **ok**.
Thresholds resolve to the nearest histogram bucket boundary at or above
the target (fixed buckets make the window deltas O(1)); the resolved
boundary is reported so the approximation is visible.  Windows default
to 5m/1h and come from ``DLLAMA_SLO_WINDOWS`` (e.g. ``"3s,12s"``).

Exposition: ``slo_burn_rate{objective,window}`` gauges,
``slo_violations_total{objective}`` counters (bumped on the transition
into violating, so the count is scrape-rate independent), a verdict
block in ``GET /health``, and :meth:`SloEngine.summary_line` printed when
the server stops.
"""

from __future__ import annotations

import bisect
import os
import re
import threading
import time
from collections import deque

from . import metrics as obs_metrics
from .log import get_logger

_log = get_logger("obs.slo")

DEFAULT_WINDOWS = "5m,1h"

#: latency metric name -> (histogram handle, seconds per histogram unit)
_LATENCY_METRICS = {
    "ttft": (lambda: obs_metrics.TTFT, 1.0),
    "itl": (lambda: obs_metrics.INTER_TOKEN, 1.0),
    "queue_wait": (lambda: obs_metrics.QUEUE_WAIT, 1.0),
    "duration": (lambda: obs_metrics.REQUEST_DURATION, 1.0),
    "step": (lambda: obs_metrics.ENGINE_GENERATION_MS, 1e-3),
}

_OBJ_RE = re.compile(r"^([a-z_]+)_p(\d{1,2}(?:\.\d+)?)$")


def _parse_duration_s(text: str, *, where: str) -> float:
    m = re.fullmatch(r"\s*([0-9]*\.?[0-9]+)\s*(ms|s)?\s*", text)
    if not m or float(m.group(1)) <= 0:
        raise ValueError(f"bad duration {text!r} in {where!r} "
                         f"(want e.g. 1500ms or 1.5s)")
    v = float(m.group(1))
    return v if m.group(2) == "s" else v / 1e3


def parse_windows(spec: str) -> list[tuple[str, float]]:
    """``"5m,1h"`` -> ``[("5m", 300.0), ("1h", 3600.0)]`` (ascending)."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        m = re.fullmatch(r"([0-9]*\.?[0-9]+)(s|m|h)", part)
        if not m:
            raise ValueError(f"bad SLO window {part!r} (want e.g. 5m, 1h, 30s)")
        scale = {"s": 1.0, "m": 60.0, "h": 3600.0}[m.group(2)]
        secs = float(m.group(1)) * scale
        if secs <= 0:
            raise ValueError(f"bad SLO window {part!r}: must be positive")
        out.append((part, secs))
    if not out:
        raise ValueError("empty SLO window spec")
    out.sort(key=lambda w: w[1])
    return out


class Objective:
    """One parsed objective bound to its registry metric."""

    def __init__(self, key: str, *, kind: str, allowed: float,
                 target_display: str, hist=None, threshold=None):
        self.key = key
        self.kind = kind                      # "latency" | "error_rate"
        self.allowed = allowed                # allowed bad fraction
        self.target_display = target_display
        self.hist = hist
        self.threshold = threshold            # in histogram units
        self.boundary = None                  # resolved bucket upper
        self._boundary_idx = None
        if hist is not None:
            i = bisect.bisect_left(hist.uppers, threshold)
            self._boundary_idx = i
            self.boundary = (hist.uppers[i] if i < len(hist.uppers)
                             else float("inf"))
            if self.boundary == float("inf"):
                _log.warning(
                    "slo objective %s: target %s is beyond the largest "
                    "%s bucket — only +Inf observations count as bad",
                    key, target_display, hist.name)

    def counts(self) -> tuple[float, float]:
        """Current cumulative ``(bad, total)`` for this objective."""
        if self.kind == "error_rate":
            bad = obs_metrics.SERVER_ERRORS.value
            total = bad + obs_metrics.REQUESTS_SERVED.value
            return float(bad), float(total)
        cum, _, count = self.hist.snapshot()
        i = self._boundary_idx
        good = cum[i] if i < len(self.hist.uppers) else count
        return float(count - good), float(count)


def parse_slo(spec: str) -> list[Objective]:
    """Parse the ``--slo`` grammar; raises ``ValueError`` with a message
    naming the offending objective (the CLI surfaces it verbatim)."""
    objectives = []
    seen = set()
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"bad SLO objective {part!r}: want name=target")
        name, _, target = part.partition("=")
        name, target = name.strip(), target.strip()
        if name in seen:
            raise ValueError(f"duplicate SLO objective {name!r}")
        seen.add(name)
        if name == "error_rate":
            m = re.fullmatch(r"([0-9]*\.?[0-9]+)\s*(%)?", target)
            if not m:
                raise ValueError(f"bad error_rate target {target!r} "
                                 f"(want e.g. 0.5% or 0.005)")
            frac = float(m.group(1)) / (100.0 if m.group(2) else 1.0)
            if not 0 < frac < 1:
                raise ValueError(f"error_rate target {target!r} must be in "
                                 f"(0, 100%)")
            objectives.append(Objective(
                name, kind="error_rate", allowed=frac,
                target_display=f"{frac * 100:g}%"))
            continue
        m = _OBJ_RE.match(name)
        if not m or m.group(1) not in _LATENCY_METRICS:
            known = ", ".join(sorted(_LATENCY_METRICS))
            raise ValueError(
                f"unknown SLO objective {name!r} (want <metric>_p<q> with "
                f"metric in {{{known}}}, or error_rate)")
        metric, q = m.group(1), float(m.group(2))
        if not 0 < q < 100:
            raise ValueError(f"bad quantile in {name!r}: must be in (0, 100)")
        hist_fn, unit_s = _LATENCY_METRICS[metric]
        hist = hist_fn()
        threshold = _parse_duration_s(target, where=part) / unit_s
        objectives.append(Objective(
            name, kind="latency", allowed=1.0 - q / 100.0,
            target_display=target, hist=hist, threshold=threshold))
    if not objectives:
        raise ValueError("empty SLO spec")
    return objectives


class SloEngine:
    """Rolling multi-window burn-rate evaluation over registry metrics.

    Snapshots of each objective's cumulative ``(bad, total)`` are kept in
    a time-stamped deque; a window's burn is computed from the delta
    between now and the newest snapshot at least that old (a partially
    filled window uses the oldest snapshot — early traffic is judged
    against the traffic actually seen, not diluted by imagined history).
    """

    def __init__(self, objectives: list[Objective],
                 windows: list[tuple[str, float]] | None = None):
        if not objectives:
            raise ValueError("SloEngine needs at least one objective")
        self.objectives = objectives
        self.windows = windows or parse_windows(DEFAULT_WINDOWS)
        self._lock = threading.Lock()
        self._samples: deque = deque()
        self._min_spacing = max(0.2, self.windows[0][1] / 50.0)
        self._verdicts = {o.key: "ok" for o in objectives}
        self._max_age = self.windows[-1][1] * 1.2 + 60.0

    @classmethod
    def from_spec(cls, spec: str, windows_spec: str | None = None
                  ) -> "SloEngine":
        ws = windows_spec or os.environ.get("DLLAMA_SLO_WINDOWS",
                                            DEFAULT_WINDOWS)
        return cls(parse_slo(spec), parse_windows(ws))

    @property
    def spec_display(self) -> str:
        return ",".join(f"{o.key}={o.target_display}"
                        for o in self.objectives)

    def evaluate(self, now: float | None = None) -> dict:
        """Compute burns, update gauges/counters, return the verdict
        block served in ``/health``.  ``now`` is ``time.monotonic()``
        unless a test injects simulated time."""
        if now is None:
            now = time.monotonic()
        current = {o.key: o.counts() for o in self.objectives}
        with self._lock:
            if not self._samples or \
                    now - self._samples[-1][0] >= self._min_spacing:
                self._samples.append((now, current))
            while self._samples and now - self._samples[0][0] > self._max_age:
                self._samples.popleft()
            samples = list(self._samples)

        out_objs = {}
        worst = "ok"
        for o in self.objectives:
            bad_now, total_now = current[o.key]
            burns = {}
            for label, secs in self.windows:
                base = None
                for t, snap in reversed(samples):
                    if t <= now - secs:
                        base = snap.get(o.key)
                        break
                if base is None and samples:
                    t0, snap0 = samples[0]
                    # the oldest sample IS "now" on the very first call:
                    # no history yet, judge the cumulative totals directly
                    base = (0.0, 0.0) if t0 >= now else snap0.get(o.key)
                if base is None:
                    base = (0.0, 0.0)
                d_bad = max(bad_now - base[0], 0.0)
                d_total = max(total_now - base[1], 0.0)
                burn = (d_bad / d_total) / o.allowed if d_total > 0 else 0.0
                burn = round(burn, 4)
                burns[label] = burn
                obs_metrics.SLO_BURN_RATE.set(o.key, label, burn)
            if all(b >= 1.0 for b in burns.values()):
                verdict = "violating"
            elif any(b >= 1.0 for b in burns.values()):
                verdict = "at_risk"
            else:
                verdict = "ok"
            with self._lock:
                if verdict == "violating" and \
                        self._verdicts[o.key] != "violating":
                    obs_metrics.SLO_VIOLATIONS.inc(o.key)
                    _log.warning("slo objective %s VIOLATING: burn %s "
                                 "(target %s)", o.key, burns,
                                 o.target_display)
                self._verdicts[o.key] = verdict
            entry = {"target": o.target_display, "verdict": verdict,
                     "burn": burns}
            if o.boundary is not None:
                entry["resolved_boundary"] = o.boundary
            out_objs[o.key] = entry
            rank = {"ok": 0, "at_risk": 1, "violating": 2}
            if rank[verdict] > rank[worst]:
                worst = verdict
        return {"status": worst,
                "windows": [label for label, _ in self.windows],
                "objectives": out_objs}

    def summary_line(self) -> str:
        """End-of-run one-liner, printed when the server stops."""
        res = self.evaluate()
        viol = obs_metrics.SLO_VIOLATIONS.json_value()
        parts = []
        for key, entry in res["objectives"].items():
            burns = "/".join(f"{entry['burn'][w]:g}" for w in res["windows"])
            parts.append(f"{key}<={entry['target']} burn {burns} "
                         f"[{entry['verdict']}]")
        wins = "/".join(res["windows"])
        tail = f"; violations {viol}" if viol else ""
        return (f"slo: {res['status'].upper()} over {wins} — "
                + "; ".join(parts) + tail)
