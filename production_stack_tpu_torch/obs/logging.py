"""Structured, correlated logging: one JSON object a line.

A copy of the JAX package's ``obs/logging.py``. ``configure_logging("json")``
swaps every ``init_logger`` handler to :class:`JsonLineFormatter`, which
adds to each record the request identity the tracing layer carries:

- ``trace_id`` and ``request_id``, bound by the engine server's HTTP
  handler for the request it serves (``bind_log_context``), so one grep
  joins a router log line, an engine log line and the
  ``/debug/requests`` timeline on one id;
- ``tenant``, the router-stamped ``X-PST-Tenant``;
- ``component`` and ``engine_id``, the process identity set once at
  start.

Field contract: ``ts`` (epoch seconds), ``level``, ``logger``, ``msg``,
``component``, ``engine_id`` and, when a request context is bound,
``trace_id``, ``request_id``, ``tenant``; ``exc`` carries a traceback.

INFO and below pass through a token bucket per logger; the drops are
counted in ``pst_log_dropped_total`` (:data:`LOG_REGISTRY`, which the
server's ``/metrics`` renders). WARNING and above are never dropped.

The context lives in a ``contextvars.ContextVar``: each HTTP handler
thread starts from an empty context, so a binding never leaks from one
request to the next.
"""

from __future__ import annotations

import contextvars
import json
import logging
import threading
import time
from typing import Dict, Optional

from .. import logging_utils
from .prometheus_text import Registry

JSON = "json"
TEXT = "text"
LOG_FORMATS = (JSON, TEXT)

# Steady-state serving never drops a line at this rate; a storm of one
# line a token cannot flood stdout.
DEFAULT_SAMPLE_RATE = 200.0   # records/sec per logger
DEFAULT_SAMPLE_BURST = 400

# The log profile is process-wide, and so is its drop counter.
LOG_REGISTRY = Registry()
log_dropped_total = LOG_REGISTRY.counter(
    "pst_log_dropped",
    "Log records dropped by the structured-logging hot-path sampler "
    "(INFO and below only; WARNING+ is never sampled)",
    ["component", "logger"])

_LOG_CONTEXT: "contextvars.ContextVar[Optional[Dict[str, str]]]" = (
    contextvars.ContextVar("pst_log_context", default=None)
)

# Process identity (component, engine_id): merged into every JSON record.
_IDENTITY: Dict[str, str] = {}


def bind_log_context(**fields) -> contextvars.Token:
    """Bind per-request correlation fields in the current context; the
    token restores the previous binding (``unbind_log_context``). Falsy
    values are skipped."""
    merged = dict(_LOG_CONTEXT.get() or {})
    merged.update({k: str(v) for k, v in fields.items() if v})
    return _LOG_CONTEXT.set(merged)


def unbind_log_context(token: contextvars.Token) -> None:
    _LOG_CONTEXT.reset(token)


def set_log_identity(**fields) -> None:
    """Set (or extend) the identity merged into every record."""
    _IDENTITY.update({k: str(v) for k, v in fields.items() if v})


class JsonLineFormatter(logging.Formatter):
    """One JSON object a line, with the field contract above."""

    def format(self, record: logging.LogRecord) -> str:
        out: Dict[str, object] = {
            "ts": round(record.created, 3),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        out.update(_IDENTITY)
        ctx = _LOG_CONTEXT.get()
        if ctx:
            out.update(ctx)
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, default=str)


class _SamplingFilter(logging.Filter):
    """A token bucket per logger over INFO-and-below records; WARNING+
    always passes. Drops are counted, never silent."""

    def __init__(self, rate: float, burst: int) -> None:
        super().__init__()
        self.rate = max(float(rate), 0.001)
        self.burst = max(int(burst), 1)
        self._lock = threading.Lock()
        # logger name -> [tokens, last refill (monotonic)]
        self._buckets: Dict[str, list] = {}

    def filter(self, record: logging.LogRecord) -> bool:
        if record.levelno >= logging.WARNING:
            return True
        now = time.monotonic()
        with self._lock:
            b = self._buckets.get(record.name)
            if b is None:
                b = self._buckets[record.name] = [float(self.burst), now]
            tokens, last = b
            tokens = min(tokens + (now - last) * self.rate, float(self.burst))
            if tokens >= 1.0:
                b[0], b[1] = tokens - 1.0, now
                return True
            b[0], b[1] = tokens, now
        log_dropped_total.labels(
            component=_IDENTITY.get("component", "unknown"),
            logger=record.name,
        ).inc()
        return False


def configure_logging(
    fmt: str = TEXT,
    component: Optional[str] = None,
    sample_rate: float = DEFAULT_SAMPLE_RATE,
    sample_burst: int = DEFAULT_SAMPLE_BURST,
    **identity,
) -> None:
    """Install a log profile process-wide: ``"json"`` (JSON lines and the
    sampler) or ``"text"`` (the colored default). ``component`` and the
    ``identity`` keywords (``engine_id=...``) ride every record."""
    if fmt not in LOG_FORMATS:
        raise ValueError(f"unknown log format {fmt!r} (expected json|text)")
    if component:
        set_log_identity(component=component)
    set_log_identity(**identity)
    if fmt == JSON:
        logging_utils.apply_log_profile(
            formatter_factory=lambda stream: JsonLineFormatter(),
            record_filter=_SamplingFilter(sample_rate, sample_burst),
        )
    else:
        logging_utils.apply_log_profile()
