"""Artifact validation errors and the integrity counters — the part of
``dllama_tpu/io/integrity.py`` that engine snapshots need.

:class:`ArtifactError` is what a corrupt or mismatched model, tokenizer
or snapshot raises; the counters are registry counters
(:mod:`..obs.metrics`), so ``/metrics`` reads the same numbers in both
formats.  Checksum manifests and ``--verify-weights`` are not ported.
"""

from __future__ import annotations


class ArtifactError(ValueError):
    """A model, tokenizer or snapshot artifact failed validation.  The
    message names the file, the field, and where known the byte offset and
    the expected and found values."""

    def __init__(self, path, field: str, message: str, *,
                 offset: int | None = None, expected=None, got=None):
        self.path = str(path) if path is not None else None
        self.field = field
        self.offset = offset
        self.expected = expected
        self.got = got
        loc = f" at byte {offset}" if offset is not None else ""
        detail = ""
        if expected is not None or got is not None:
            detail = f" (expected {expected!r}, got {got!r})"
        where = f"{self.path}: " if self.path else ""
        super().__init__(f"{where}{field}{loc}: {message}{detail}")


# the counters this package bumps (the JAX package's checksum and
# numeric-fault counters arrive with their features)
_INTEGRITY_KEYS = ("snapshot_restores",)


def _counter(name: str):
    from ..obs import metrics
    return metrics.REGISTRY.counter(name)


def bump_counter(name: str, n: int = 1) -> None:
    _counter(name).inc(n)


def counters() -> dict:
    """The process-global integrity counters."""
    return {k: _counter(k).value for k in _INTEGRITY_KEYS}


def reset_counters() -> None:
    """Zero the integrity counters (test isolation)."""
    for k in _INTEGRITY_KEYS:
        _counter(k).reset()
