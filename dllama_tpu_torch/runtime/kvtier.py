"""KV memory tiering: the host-RAM spill pool and the victim order — a
copy of ``dllama_tpu/runtime/kvtier.py``.

Under ``--kv-reserve optimistic`` the scheduler admits a request with only
``ceil((prompt + spill_headroom)/page)`` pages and grows its slot page by
page; a grow that finds the pool empty reclaims through radix eviction,
then by spilling the idle-longest neighbour's pages here, and pages them
back in when pages free.

* :class:`HostPagePool` — a bytes-bounded ``key -> {name: ndarray}``
  store.  ``put`` refuses rather than grows past ``--kv-host-pool-mb``: a
  spill that cannot be stored leaves the victim resident and the
  scheduler falls back to preemption, so over-commit degrades to
  queueing, never to lost bytes.  On the card the arrays it holds are
  numpy views of pinned host buffers (``Engine.read_pool_pages_async``
  copies into them on a side stream), so a page-in copies from pinned
  memory.
* :func:`rank_victims` — idle-longest slot first, slot index as the
  tie-break, so a run's spill pattern is a pure function of scheduler
  state.

The copies themselves are the engine's (``read_pool_pages_async``,
``write_pool_pages``).
"""

from __future__ import annotations

import threading

import numpy as np

from ..obs import metrics as obs_metrics


def arrays_nbytes(arrays: dict) -> int:
    """Total payload bytes of one spill record's array dict."""
    return sum(int(np.asanyarray(a).nbytes) for a in arrays.values())


class HostPagePool:
    """Bytes-bounded ``key -> {name: ndarray}`` store for spilled KV.

    One record per spilled slot (the slot's whole resident working set
    moves together — pages page back in as a unit when the slot rejoins
    the dispatch).  The capacity check happens *before* the put, so a
    refused spill leaves the pool untouched and the caller's pages still
    resident; ``capacity_bytes <= 0`` disables spilling entirely (every
    put refuses), which is the ``--kv-host-pool-mb 0`` escape hatch.
    """

    def __init__(self, capacity_bytes: int):
        self.capacity_bytes = int(capacity_bytes)
        self._lock = threading.Lock()
        self._records: dict = {}
        self._bytes = 0

    # -- capacity ----------------------------------------------------------
    @property
    def bytes_used(self) -> int:
        with self._lock:
            return self._bytes

    def would_fit(self, nbytes: int) -> bool:
        with self._lock:
            return self._bytes + int(nbytes) <= self.capacity_bytes

    # -- records -----------------------------------------------------------
    def put(self, key, arrays: dict, meta: dict | None = None) -> bool:
        """Store one spill record; returns False (pool unchanged) when it
        would not fit or the key is already present (a double spill of
        the same slot is a caller bug surfaced as a refusal, not silent
        clobbering of bytes a resume still needs)."""
        nbytes = arrays_nbytes(arrays)
        with self._lock:
            if key in self._records:
                return False
            if self._bytes + nbytes > self.capacity_bytes:
                return False
            self._records[key] = ({k: np.asanyarray(v) for k, v in
                                   arrays.items()}, dict(meta or {}), nbytes)
            self._bytes += nbytes
        obs_metrics.KV_HOST_POOL_BYTES.set(self.bytes_used)
        return True

    def get(self, key):
        """Peek a record without removing it: ``(arrays, meta)`` or None."""
        with self._lock:
            rec = self._records.get(key)
            return (rec[0], rec[1]) if rec is not None else None

    def pop(self, key):
        """Remove and return ``(arrays, meta)`` or None."""
        with self._lock:
            rec = self._records.pop(key, None)
            if rec is not None:
                self._bytes -= rec[2]
        if rec is not None:
            obs_metrics.KV_HOST_POOL_BYTES.set(self.bytes_used)
            return rec[0], rec[1]
        return None

    def drop(self, key) -> None:
        self.pop(key)

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self._bytes = 0
        obs_metrics.KV_HOST_POOL_BYTES.set(0)

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._records


def rank_victims(candidates) -> list:
    """Order spill candidates: idle-longest first, index tie-break.

    ``candidates`` is an iterable of ``(slot_idx, last_activity)`` where
    ``last_activity`` is the slot's monotonic clock of its most recent
    dispatch participation (``_Slot.active_at``).  The oldest clock — the
    slot that
    has gone longest without producing — is the cheapest to stall, so it
    spills first.  Ties (same clock, e.g. slots admitted in the same
    dispatch) break by ascending slot index, keeping the order a pure
    function of scheduler state.
    """
    return [idx for idx, _ in
            sorted(candidates, key=lambda c: (c[1], c[0]))]
