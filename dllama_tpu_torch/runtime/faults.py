"""Deterministic fault injection for the serving path — the port of
``dllama_tpu/runtime/faults.py`` (the same grammar, registry and points).

A process-global registry of named **fault points** compiled into the hot
paths, each a no-op until a test (or the ``DLLAMA_FAULTS`` environment
variable) arms it.  ``fire()`` takes any name; the points instrumented in
this package, each where the JAX package fires it:

* ``server.read_body``   — before the API handler reads a request body
  (server/api.py ``_read_body``); ``raise:TimeoutError`` is a stalled
  client (408).
* ``server.emit_delta``  — before each streamed delta (server/api.py
  ``_sse_emitter``); ``disconnect`` is a client gone mid-stream.
* ``engine.device_step`` — at every blocking edge of a device step
  (runtime/engine.py ``Engine._sync``: the batch-1 forward's sync, the
  decode-chunk and slot-dispatch landings); ``delay`` is a slow or hung
  step (with ``step_timeout``: :class:`StepTimeout`), ``nan`` poisons
  the host-fetched logits.
* ``io.read_tensor``     — on every ``MFile.raw`` tensor read
  (io/mfile.py); ``corrupt`` flips a byte of the returned buffer, the
  stand-in for storage corruption a checksum manifest must catch.
* ``spec.propose``       — in the speculative proposer (runtime/spec.py)
  before drafts are returned; ``corrupt`` swaps every slot's drafts for
  adversarial tokens (the reject-storm worst case).
* ``engine.numeric``     — at the engine's logits guard (runtime/
  engine.py, ``--numeric-checks``); ``nan`` poisons the checked logits.
* ``kv.spill``           — in the scheduler's KV tiering
  (``_spill_slot_locked``) before a slot's pages move to the host pool;
  ``delay`` is a slow drain, a ``raise`` abandons the spill and the grow
  ladder falls back to preemption (never wrong bytes).
* ``sched.host_fanout``  — in the slot scheduler's token fanout after a
  dispatch lands; ``delay`` widens the host gap.
* ``pod.respawn``        — in the serve-pod supervisor (router/pod.py)
  before a dead or hung replica is respawned; a raise counts as another
  death in the crash-loop window.

* ``distributed.initialize``— before ``torch.distributed.init_process_group``
  (parallel/distributed.py ``init_distributed``); a ``raise:ConnectionError``
  here is the coordinator not being up yet, which the init retries with
  backoff.

Spec grammar (``DLLAMA_FAULTS`` or :meth:`FaultRegistry.install`)::

    spec     := entry ("," entry)*
    entry    := point "=" action [":" arg] ["@" skip] ["x" times]
    action   := "delay" | "raise" | "disconnect" | "nan" | "corrupt"

* ``delay:SECONDS``  — sleep that long at the point.
* ``raise:ExcName[:message]`` — raise the named exception (one of
  ``ConnectionError, TimeoutError, BrokenPipeError, ConnectionResetError,
  OSError, RuntimeError, ValueError``; default :class:`FaultInjected`).
* ``disconnect``     — raise ``BrokenPipeError`` (a dead peer).
* ``nan``            — ask the call site to poison its value.
* ``corrupt``        — ask the call site to corrupt its value.
* ``@skip``          — stay dormant for the first ``skip`` hits.
* ``xtimes``         — fire at most ``times`` times, then go dormant.

Example: ``DLLAMA_FAULTS="engine.device_step=delay:0.5@2x3"`` sleeps
500 ms on device-step hits 3, 4 and 5 only.  Hit counters, not
randomness, decide when a fault fires; the registry is thread-safe.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass

from ..obs.log import get_logger

_log = get_logger("runtime.faults")


class FaultInjected(RuntimeError):
    """Default exception for a ``raise`` action with no exception name."""


#: exceptions a ``raise:`` action may name — the set the serving paths
#: classify (connection-ish retried/mapped, the rest surfaced as bugs)
_EXCEPTIONS: dict[str, type[BaseException]] = {
    "ConnectionError": ConnectionError,
    "TimeoutError": TimeoutError,
    "socket.timeout": TimeoutError,  # alias since 3.10
    "BrokenPipeError": BrokenPipeError,
    "ConnectionResetError": ConnectionResetError,
    "OSError": OSError,
    "RuntimeError": RuntimeError,
    "ValueError": ValueError,
    "FaultInjected": FaultInjected,
}

_ACTIONS = ("delay", "raise", "disconnect", "nan", "corrupt")


@dataclass
class Fault:
    """One armed fault: where, what, and its deterministic firing window."""
    point: str
    action: str
    arg: str | None = None
    skip: int = 0            # dormant for the first `skip` hits
    times: int | None = None  # fire at most this many times (None = forever)
    hits: int = 0
    fired: int = 0

    def should_fire(self) -> bool:
        if self.hits <= self.skip:
            return False
        return self.times is None or self.fired < self.times

    def perform(self) -> str | None:
        """Execute the side effect; returns the action name for call sites
        that transform values (``nan``) rather than raise/sleep."""
        if self.action == "delay":
            time.sleep(float(self.arg or 0.0))
            return None
        if self.action == "raise":
            name, _, msg = (self.arg or "FaultInjected").partition(":")
            exc = _EXCEPTIONS.get(name, FaultInjected)
            raise exc(msg or f"injected fault at {self.point}")
        if self.action == "disconnect":
            raise BrokenPipeError(f"injected disconnect at {self.point}")
        return self.action  # "nan": the call site applies it


def parse_spec(spec: str) -> list[Fault]:
    """Parse the ``DLLAMA_FAULTS`` grammar into :class:`Fault` objects.

    Raises ``ValueError`` with the offending entry on any malformed spec —
    a silently dropped fault would make a drill pass vacuously.
    """
    import re
    pat = re.compile(r"^(?P<point>[\w.]+)=(?P<action>[a-z]+)"
                     r"(?::(?P<arg>.+?))?(?:@(?P<skip>\d+))?"
                     r"(?:x(?P<times>\d+))?$")
    faults = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        m = pat.match(entry)
        if not m:
            raise ValueError(
                f"bad fault entry {entry!r}: expected "
                "point=action[:arg][@skip][xtimes]")
        action, arg = m["action"], m["arg"]
        skip = int(m["skip"] or 0)
        times = int(m["times"]) if m["times"] else None
        if action not in _ACTIONS:
            raise ValueError(
                f"bad fault entry {entry!r}: unknown action {action!r} "
                f"(expected one of {', '.join(_ACTIONS)})")
        if action == "raise" and arg:
            name = arg.partition(":")[0]
            if name not in _EXCEPTIONS:
                raise ValueError(
                    f"bad fault entry {entry!r}: unknown exception {name!r}")
        faults.append(Fault(m["point"], action, arg, skip, times))
    return faults


class FaultRegistry:
    """Process-global, test-controllable set of armed faults."""

    def __init__(self):
        self._lock = threading.Lock()
        self._faults: list[Fault] = []

    # -- arming ---------------------------------------------------------
    def install(self, spec: str | Fault | list[Fault]) -> None:
        """Arm faults from a spec string, one Fault, or a list (additive)."""
        if isinstance(spec, str):
            new = parse_spec(spec)
        elif isinstance(spec, Fault):
            new = [spec]
        else:
            new = list(spec)
        with self._lock:
            self._faults.extend(new)

    def install_env(self, env: dict | None = None) -> bool:
        """Arm from ``DLLAMA_FAULTS`` if set; returns True when it was."""
        spec = (env or os.environ).get("DLLAMA_FAULTS", "")
        if not spec:
            return False
        self.install(spec)
        return True

    def clear(self) -> None:
        with self._lock:
            self._faults.clear()

    def active(self) -> bool:
        with self._lock:
            return bool(self._faults)

    def snapshot(self) -> list[Fault]:
        with self._lock:
            return [Fault(f.point, f.action, f.arg, f.skip, f.times,
                          f.hits, f.fired) for f in self._faults]

    # -- the hot-path hook ----------------------------------------------
    def fire(self, point: str) -> list[str]:
        """Hit ``point``: every armed fault there advances its counter and,
        if inside its firing window, performs its action.  Raising actions
        raise from here; the returned list carries value-transform actions
        (``nan``) for the call site.  A registry with nothing armed is a
        single locked list check — cheap enough for per-chunk paths.
        """
        due = []
        with self._lock:
            if not self._faults:
                return []
            for f in self._faults:
                if f.point != point:
                    continue
                f.hits += 1
                if f.should_fire():
                    f.fired += 1
                    due.append(f)
        actions = []
        for f in due:  # perform outside the lock: delay/raise must not block
            _log.info("fault_fired", extra={
                "point": f.point, "action": f.action, "arg": f.arg,
                "fired": f.fired})
            a = f.perform()  # other points, and raise escapes here
            if a is not None:
                actions.append(a)
        return actions


#: THE process-global registry every instrumented call site fires into.
#: ``DLLAMA_FAULTS`` arms it at import so the same spec drives a live
#: server (``python -m dllama_tpu_torch.server.api``), the CLI, and the
#: tests.
FAULTS = FaultRegistry()
FAULTS.install_env()


class injected:
    """``with injected("point=action"):`` — arm for a block, then disarm.

    ``__exit__`` clears the WHOLE registry rather than only what it armed:
    test isolation wants a clean slate, and tests never arm faults they
    don't own.
    """

    def __init__(self, spec: str):
        self.spec = spec

    def __enter__(self) -> FaultRegistry:
        FAULTS.install(self.spec)
        return FAULTS

    def __exit__(self, *exc) -> None:
        FAULTS.clear()
