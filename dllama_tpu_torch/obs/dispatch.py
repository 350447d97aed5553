"""The kernel-dispatch ledger: which body of which matmul kernel ran how
often — the port's counterpart of ``dllama_tpu/obs/dispatch.py``.

The JAX package records a matmul's path where its call site is traced
(``pallas-fused``, ``pallas-blocked``, ``xla-dequant``, ``dense``) and
every degrade off the fast path.  The port has no degrade path (a CUDA
tensor launches its kernel or raises; only a CPU tensor takes the plain
version), and every kernel wrapper already counts its launches.  So the
``matmul_dispatch{codec, path}`` family is read from those counters
(:func:`sync`, at each ``/metrics`` scrape): ``codec`` ``q40`` or ``q8``,
``path`` the body that ran — ``gemv`` (the decode body), ``mma`` (the
tensor-core body), ``blocked-gemv`` and ``blocked-mma`` (kernel 3's), or
``plain`` (the plain PyTorch version, on the CPU).  Counts are launches,
one a call, where the JAX package counts compiled call sites.

So the JAX ledger's degrade flag and reasons (in ``/health`` and the
flight records) have no counterpart here.
"""

from __future__ import annotations

import threading

from ..ops import q8, q40
from . import metrics as obs_metrics

_lock = threading.Lock()
_seen: dict[tuple[str, str], int] = {}  # (codec, path) -> launches last synced

_PATHS = {"mma": "mma", "blocked": "blocked-gemv", "blocked-mma": "blocked-mma"}


def launches() -> dict[tuple[str, str], int]:
    """``{(codec, path): calls}`` from the kernels' counters now."""
    out: dict[tuple[str, str], int] = {}
    for codec, mod in (("q40", q40), ("q8", q8)):
        c = mod.counters()
        for key, n in c["launches_by_shape"].items():
            path = _PATHS.get(key[0], "gemv") if isinstance(key[0], str) else "gemv"
            out[(codec, path)] = out.get((codec, path), 0) + n
        if c["plain_calls"]:
            out[(codec, "plain")] = c["plain_calls"]
    return out


def sync() -> None:
    """Advance ``matmul_dispatch`` to the counters.  A counter reset (the
    kernels' ``reset_counters``) restarts that path from 0: its new count
    is added whole, so the family only ever grows."""
    with _lock:
        for key, n in launches().items():
            prev = _seen.get(key, 0)
            delta = n - prev if n >= prev else n
            if delta:
                obs_metrics.MATMUL_DISPATCH.inc(*key, n=delta)
            _seen[key] = n

