"""Colored, leveled logging (a copy of the JAX package's logging_utils).

Per-level ANSI colors on a terminal, INFO and below to stdout, WARNING and
above to stderr; idempotent handler install. ``apply_log_profile`` swaps
the formatter (and a record filter) on every logger made here, existing
and later: ``obs/logging.py`` installs its JSON lines through it.
"""

from __future__ import annotations

import logging
import sys

_COLORS = {
    logging.DEBUG: "\033[36m",     # cyan
    logging.INFO: "\033[32m",      # green
    logging.WARNING: "\033[33m",   # yellow
    logging.ERROR: "\033[31m",     # red
    logging.CRITICAL: "\033[1;31m",  # bold red
}
_RESET = "\033[0m"

_FMT = "[%(asctime)s] %(levelname)s %(name)s: %(message)s"
_DATEFMT = "%H:%M:%S"


class _ColorFormatter(logging.Formatter):
    def __init__(self, fmt: str, datefmt: str, stream) -> None:
        super().__init__(fmt, datefmt)
        self._stream = stream

    def format(self, record: logging.LogRecord) -> str:
        base = super().format(record)
        color = _COLORS.get(record.levelno, "")
        if color and self._stream.isatty():
            return f"{color}{base}{_RESET}"
        return base


class _BelowWarning(logging.Filter):
    def filter(self, record: logging.LogRecord) -> bool:
        return record.levelno < logging.WARNING


# The structured-logging profile (obs/logging.py installs it): a factory
# of the formatter for a stream (None: the colored text default) and an
# optional record filter (the hot-path sampler), applied to every logger
# init_logger configured, existing and later.
_FORMATTER_FACTORY = None
_RECORD_FILTER = None


def _make_formatter(stream) -> logging.Formatter:
    if _FORMATTER_FACTORY is not None:
        return _FORMATTER_FACTORY(stream)
    return _ColorFormatter(_FMT, _DATEFMT, stream)


def apply_log_profile(formatter_factory=None, record_filter=None) -> None:
    """Swap the formatter (and optional filter) on every logger this
    module configured, and remember both for loggers made later. With no
    arguments the colored text default is restored."""
    global _FORMATTER_FACTORY, _RECORD_FILTER
    old_filter = _RECORD_FILTER
    _FORMATTER_FACTORY = formatter_factory
    _RECORD_FILTER = record_filter
    for logger in list(logging.Logger.manager.loggerDict.values()):
        if not getattr(logger, "_pst_configured", False):
            continue
        if old_filter is not None:
            logger.removeFilter(old_filter)
        if record_filter is not None:
            logger.addFilter(record_filter)
        for handler in logger.handlers:
            stream = getattr(handler, "stream", sys.stdout)
            handler.setFormatter(_make_formatter(stream))


def init_logger(name: str, level: int = logging.INFO) -> logging.Logger:
    """Return a logger with colored stdout/stderr split handlers."""
    logger = logging.getLogger(name)
    if getattr(logger, "_pst_configured", False):
        logger.setLevel(level)
        return logger
    logger.setLevel(level)
    logger.propagate = False

    out = logging.StreamHandler(sys.stdout)
    out.addFilter(_BelowWarning())
    out.setFormatter(_make_formatter(sys.stdout))
    err = logging.StreamHandler(sys.stderr)
    err.setLevel(logging.WARNING)
    err.setFormatter(_make_formatter(sys.stderr))

    logger.addHandler(out)
    logger.addHandler(err)
    if _RECORD_FILTER is not None:
        logger.addFilter(_RECORD_FILTER)
    logger._pst_configured = True  # type: ignore[attr-defined]
    return logger
