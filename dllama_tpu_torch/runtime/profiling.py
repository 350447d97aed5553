"""Profiler-derived compute-versus-collective attribution — the port of
``dllama_tpu/runtime/profiling.py`` on ``torch.profiler``.

The reference splits a token's time into I (inference) and T (transfer)
by wall-clock accounting in its scheduler.  Here the inter-rank hops are
kernel 4 (``tp_allreduce``) launches inside the step, so the split comes
from a profiler trace: :func:`traced_op_times` runs a few engine steps
under ``torch.profiler`` and sums device time by kernel name (on a card:
the CUDA kernels' self device time, replayed CUDA graphs' kernels
included; on the CPU: each op's self CPU time), and
:func:`split_op_times` classifies the names into collective and compute.
:func:`profile_decode_steps` traces an engine's decode steps for the two
callers, the CLI's ``inference --profile-split`` / ``--profile-ops`` and
the server's ``POST /debug/profile``.  Profiling is an opt-in
diagnostic; ``torch.profiler`` is imported inside the call.
"""

from __future__ import annotations

import re
from typing import Callable

# collective kernels: kernel 4 (tp_allreduce_kernel<...>) and NCCL's, with
# the JAX package's HLO collective names kept for its traces' names
_COLLECTIVE = re.compile(
    r"all-reduce|all-gather|reduce-scatter|collective-permute|all-to-all"
    r"|allreduce|allgather|reducescatter|alltoall|nccl",
    re.IGNORECASE)


def traced_op_times(step: Callable[[], None], steps: int = 1,
                    device: str | None = None) -> dict[str, float] | None:
    """Trace ``steps`` calls of ``step()`` under ``torch.profiler`` and
    return ``{name: ms}`` summed over the calls: each CUDA kernel's self
    device time when ``device`` is ``"cuda"`` (default: ``cuda`` when a card
    is there), else each op's self CPU time.  None when the trace holds no
    time (a card whose kernels the profiler did not see), never an empty
    table."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    acts = [ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        for _ in range(steps):
            step()
        if device == "cuda":
            torch.cuda.synchronize()
    times: dict[str, float] = {}
    for e in prof.key_averages():
        if device == "cuda":
            us = getattr(e, "self_device_time_total", 0) or 0
            if e.device_type != DeviceType.CUDA:
                continue
        else:
            us = e.self_cpu_time_total or 0
        if us > 0:
            times[e.key] = times.get(e.key, 0.0) + us / 1e3
    return times or None


def split_op_times(times: dict[str, float]) -> tuple[float, float]:
    """Classify per-op times into ``(compute_ms, collective_ms)`` — the one
    home of the I/T classification (the CLI's ``--profile-split`` and
    ``POST /debug/profile``)."""
    compute = sum(ms for op, ms in times.items() if not _COLLECTIVE.search(op))
    collective = sum(ms for op, ms in times.items() if _COLLECTIVE.search(op))
    return compute, collective


def summarize_split(times: dict[str, float], steps: int = 1) -> dict:
    """Per-step compute/collective summary of a per-op times dict."""
    compute_ms, collective_ms = split_op_times(times)
    compute_ms /= steps
    collective_ms /= steps
    total = compute_ms + collective_ms
    return {
        "compute_ms": compute_ms,
        "collective_ms": collective_ms,
        "collective_pct": 100.0 * collective_ms / total if total > 0 else 0.0,
    }


def top_ops(times: dict[str, float], k: int = 10,
            steps: int = 1) -> list[tuple[str, float]]:
    """The top-``k`` ops by time as ``(name, per-step ms)``."""
    ranked = sorted(times.items(), key=lambda kv: -kv[1])[:k]
    return [(op, ms / steps) for op, ms in ranked]


def profiled_split(step: Callable[[], None], steps: int = 3,
                   device: str | None = None) -> dict | None:
    """Trace ``steps`` calls of ``step()`` and attribute their time:
    ``{"compute_ms", "collective_ms", "collective_pct"}`` a step (summed
    over every rank's card), or None when the trace holds no time."""
    times = traced_op_times(step, steps, device)
    if times is None:
        return None
    return summarize_split(times, steps)


def profile_decode_steps(engine, steps: int = 3) -> tuple[dict[str, float] | None, str]:
    """Trace ``steps`` single-token greedy decode steps of a batch engine
    (``Engine.decode``: graph replays when its graphs are on) from its
    position, and return ``(times, how)``: :func:`traced_op_times` of the
    steps and how they ran.  The same steps run once before the trace, so
    every graph key is captured outside it; the position is restored
    after (the profiled steps' KV sits past the live prefix, as an aborted
    generation's).  Should the trace show no kernel from inside the
    replays (only the host-side copies and fills around them), the steps
    are traced again with the graphs off, and ``how`` says so.  A context
    with no room for the steps is reset first."""
    import numpy as np
    if engine.pos + 2 * steps + 1 > engine.seq_len:
        engine.reset()
    pos0 = engine.pos
    tok = np.ones((engine.batch,), np.int64)

    def step():
        engine.decode(tok, 1, temperature=0.0, topp=0.9)

    def traced():
        engine.pos = pos0
        return traced_op_times(step, steps, engine.device.type)

    try:
        for _ in range(steps):
            step()
        times = traced()
        if engine.graphs is None:
            return times, "eager steps"
        # a replay that the profiler saw shows the step's dozens of kernels
        if times is not None and len(times) > 4:
            return times, "graph replays"
        saved, engine.graphs = engine.graphs, None
        try:
            times = traced()
        finally:
            engine.graphs = saved
        return times, "eager steps (the profiler saw no kernel inside the graph replays)"
    finally:
        engine.pos = pos0
