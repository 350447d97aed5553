"""The event journal: bounded, monotonically-sequenced lifecycle events
— a copy of ``dllama_tpu/obs/events.py``.

* ``emit(kind, **fields)`` appends ``{"seq", "ts", "kind", ...fields}``:
  ``seq`` is a process-monotonic cursor, ``ts`` wall-clock seconds.
* ``snapshot(since=N)`` returns only the events after cursor ``N`` (served
  at ``/debug/events``, ``?since=<seq>``), so a poller tails the journal.
* ``configure(capacity=..., log_path=...)`` applies ``--event-buffer``
  (``DLLAMA_EVENT_BUFFER``, default 2048) and ``--event-log``: every event
  is also appended to that file as one JSON line.

Kinds (``KINDS``): ``spawn``, ``death``, ``respawn``, ``quarantine``
(the pod supervisor, router/pod.py), ``eject``, ``readmit`` (the
router's registry), ``handoff``, ``resume`` (the router and the
scheduler), ``preempt`` (the scheduler); ``retire`` (the registry's
admission fence), ``scale`` and ``reshape`` (the elastic pod's controller,
router/elastic.py).
Stdlib only, one small lock an append, a process-global journal
(``JOURNAL``).
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque

from . import metrics
from .log import get_logger
from .trace import parse_buffer_env

_log = get_logger("obs.events")

DEFAULT_CAPACITY = 2048

#: the canonical kinds (the JAX package's list)
KINDS = ("spawn", "death", "respawn", "quarantine", "eject", "readmit",
         "retire", "scale", "reshape", "handoff", "resume", "preempt")


def _capacity() -> int:
    return parse_buffer_env("DLLAMA_EVENT_BUFFER", DEFAULT_CAPACITY)


class EventJournal:
    """Lock + ring of structured events with a monotonic sequence."""

    def __init__(self, capacity: int | None = None):
        self._lock = threading.Lock()
        self._events = deque(maxlen=capacity or _capacity())
        self._seq = 0
        self._log_file = None
        self._log_path = None
        self._log_failed = False

    # -- configuration ---------------------------------------------------

    def resize(self, capacity: int) -> None:
        with self._lock:
            self._events = deque(self._events, maxlen=max(1, int(capacity)))

    @property
    def capacity(self) -> int:
        return self._events.maxlen or 0

    def set_log_path(self, path: str | None) -> None:
        """Persist every future event as a JSONL line to ``path`` (append
        mode — restarts extend, never truncate).  ``None`` turns it off."""
        with self._lock:
            if self._log_file is not None:
                try:
                    self._log_file.close()
                except OSError:
                    pass
                self._log_file = None
            self._log_path = path
            self._log_failed = False
            if path:
                try:
                    self._log_file = open(path, "a", encoding="utf-8")
                except OSError as e:
                    self._log_failed = True
                    _log.warning("--event-log %s unwritable: %s (journal "
                                 "stays in-memory only)", path, e)

    # -- the hot path ----------------------------------------------------

    def emit(self, kind: str, **fields) -> dict:
        """Append one event; returns the stored record (with seq/ts)."""
        ev = {"kind": kind, "ts": round(time.time(), 6)}
        ev.update({k: v for k, v in fields.items() if v is not None})
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            self._events.append(ev)
            f = self._log_file
            if f is not None:
                try:
                    f.write(json.dumps(ev, sort_keys=True) + "\n")
                    f.flush()
                except (OSError, ValueError):
                    # one warning, then stop trying: a full disk must not
                    # turn every supervisor action into a log storm
                    if not self._log_failed:
                        self._log_failed = True
                        _log.warning("--event-log %s write failed; further "
                                     "events stay in-memory only",
                                     self._log_path)
                    self._log_file = None
        metrics.POD_EVENTS.inc(kind)
        return ev

    # -- readers ---------------------------------------------------------

    def snapshot(self, since: int | None = None) -> dict:
        """Events after cursor ``since`` (all retained ones when None),
        plus the cursor to pass on the next poll and how much of the
        ring's history has already scrolled off."""
        with self._lock:
            events = [dict(e) for e in self._events
                      if since is None or e["seq"] > since]
            next_seq = self._seq
            oldest = self._events[0]["seq"] if self._events else next_seq + 1
        return {"events": events, "next_seq": next_seq,
                "oldest_seq": oldest, "capacity": self.capacity}

    def clear(self) -> None:
        with self._lock:
            self._events.clear()


#: THE process-global journal.
JOURNAL = EventJournal()


def emit(kind: str, **fields) -> dict:
    return JOURNAL.emit(kind, **fields)


def snapshot(since: int | None = None) -> dict:
    return JOURNAL.snapshot(since)


def configure(capacity: int | None = None, log_path: str | None = None) -> None:
    """Apply CLI choices (``--event-buffer`` sizing via env is already
    read at import; ``--event-log`` persistence) after import."""
    if capacity is not None:
        JOURNAL.resize(capacity)
    if log_path is not None:
        JOURNAL.set_log_path(log_path)


def clear() -> None:
    JOURNAL.clear()
