"""Structured logging with a contextvar-carried request ID — a copy of
``dllama_tpu/obs/log.py``.

The port logs through one root logger (``dllama_tpu_torch``) configured
here: either human-readable lines or JSON lines (one object per record),
selected by ``--log-format``/``--log-level`` or the ``DLLAMA_LOG`` env
var (``json``, ``debug``, or combined ``json:debug``).

The request ID set at accept time (server/api.py) rides a
:data:`contextvars.ContextVar`, so every record logged on the request's
thread — server handler, scheduler admission, engine step —
carries the same ID with zero plumbing through call signatures.  It is
stamped via :func:`logging.setLogRecordFactory` (not a handler filter:
filters on an ancestor logger do not apply to propagated records), which
means call sites must never pass ``request_id`` through ``extra=``.

With ``--log-format json``, ``grep <request_id> server.log`` reconstructs
the request's lifecycle (accept → queue → slot join → retire → finish).
"""

from __future__ import annotations

import contextvars
import json
import logging
import os
import sys
import time
import uuid

#: the per-request correlation ID; ``None`` outside a request context.
request_id_var: contextvars.ContextVar = contextvars.ContextVar(
    "dllama_torch_request_id", default=None)

ROOT = "dllama_tpu_torch"


def get_logger(name: str) -> logging.Logger:
    """Child of the ``dllama_tpu_torch`` root (``get_logger("server.api")``
    → ``dllama_tpu_torch.server.api``)."""
    return logging.getLogger(f"{ROOT}.{name}")


def new_request_id() -> str:
    return uuid.uuid4().hex[:16]


def set_request_id(rid) -> None:
    request_id_var.set(rid)


def current_request_id():
    return request_id_var.get()


# -- record factory: stamp the contextvar on EVERY record ------------------

_base_factory = None


def _factory(*args, **kwargs):
    record = _base_factory(*args, **kwargs)
    # an id stamped by a factory installed before this one (another
    # package's, in a process that runs both) is kept when ours is unset
    record.request_id = request_id_var.get() or getattr(record, "request_id", None)
    return record


def _install_factory() -> None:
    global _base_factory
    if _base_factory is None:
        _base_factory = logging.getLogRecordFactory()
        logging.setLogRecordFactory(_factory)


_install_factory()


# -- formatters ------------------------------------------------------------

#: LogRecord attributes that are plumbing, not user-supplied ``extra=``.
_RESERVED = set(vars(logging.LogRecord("", 0, "", 0, "", (), None))) | {
    "request_id", "message", "asctime", "taskName"}


def _request_id(record: logging.LogRecord):
    """The record's request id; where a factory installed after ours
    cleared it (another package's, in a process that runs both), the
    logging thread's own (handlers format on the thread that logs)."""
    return getattr(record, "request_id", None) or request_id_var.get()


def _extras(record: logging.LogRecord) -> dict:
    return {k: v for k, v in vars(record).items() if k not in _RESERVED}


class JsonFormatter(logging.Formatter):
    """One JSON object per line; ``event`` is the log message, extra
    keyword fields ride alongside it at the top level."""

    def format(self, record: logging.LogRecord) -> str:
        out = {"ts": round(record.created, 6),
               "level": record.levelname,
               "logger": record.name,
               "event": record.getMessage()}
        rid = _request_id(record)
        if rid:
            out["request_id"] = rid
        out.update(_extras(record))
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, default=str)


class HumanFormatter(logging.Formatter):
    """``HH:MM:SS LEVEL logger [rid] event k=v ...`` — the terminal view."""

    def format(self, record: logging.LogRecord) -> str:
        ts = time.strftime("%H:%M:%S", time.localtime(record.created))
        rid = _request_id(record)
        rid_part = f" [{rid}]" if rid else ""
        parts = [f"{ts} {record.levelname:<7} {record.name}{rid_part} "
                 f"{record.getMessage()}"]
        parts += [f"{k}={v}" for k, v in _extras(record).items()]
        line = " ".join(parts)
        if record.exc_info:
            line += "\n" + self.formatException(record.exc_info)
        return line


# -- configuration ---------------------------------------------------------

_TAG = "_dllama_torch_obs_handler"

_FORMATS = {"json", "human"}
_LEVELS = {"debug", "info", "warning", "error", "critical"}


def _parse_env(spec: str):
    """``DLLAMA_LOG="json:debug"`` (either part optional, any order)."""
    fmt = level = None
    for part in spec.replace(",", ":").split(":"):
        part = part.strip().lower()
        if not part:
            continue
        if part in _FORMATS:
            fmt = part
        elif part in _LEVELS:
            level = part
    return fmt, level


def configure(log_format=None, log_level=None, *, stream=None,
              force: bool = False) -> logging.Logger:
    """Configure the ``dllama_tpu_torch`` root logger (idempotent unless ``force``).

    Precedence: explicit args (CLI flags) > ``DLLAMA_LOG`` env > defaults
    (``human`` / ``info``)."""
    env_fmt, env_level = _parse_env(os.environ.get("DLLAMA_LOG", ""))
    fmt = (log_format or env_fmt or "human").lower()
    level = (log_level or env_level or "info").upper()

    root = logging.getLogger(ROOT)
    ours = [h for h in root.handlers if getattr(h, _TAG, False)]
    if ours and not force:
        root.setLevel(level)
        return root
    for h in ours:
        root.removeHandler(h)

    handler = logging.StreamHandler(stream or sys.stderr)
    handler.setFormatter(JsonFormatter() if fmt == "json" else HumanFormatter())
    setattr(handler, _TAG, True)
    root.addHandler(handler)
    root.setLevel(level)
    root.propagate = False
    return root
