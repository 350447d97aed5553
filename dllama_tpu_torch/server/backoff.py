"""Retry-After jitter — a copy of ``dllama_tpu/server/backoff.py``.

Every 429/503 the fleet emits carries a Retry-After; if all of them say
the same number, every backed-off client retries in the same instant and
stampedes the replica that was trying to recover.  Jittering the hint
±25% (uniform) desynchronizes the herd while keeping the expected
backoff unchanged.
"""

from __future__ import annotations

import random

JITTER_FRAC = 0.25


def jittered_retry_after(seconds: float | int | str,
                         rng: random.Random | None = None) -> str:
    """Return a Retry-After header value: ``seconds`` with ±25% uniform
    jitter, rounded to a whole second, floored at 1 (the header is
    delta-seconds; 0 would mean "retry immediately", defeating the
    backoff)."""
    try:
        base = float(seconds)
    except (TypeError, ValueError):
        base = 1.0
    base = max(1.0, base)
    draw = (rng or random).uniform(1.0 - JITTER_FRAC, 1.0 + JITTER_FRAC)
    return str(max(1, int(round(base * draw))))
