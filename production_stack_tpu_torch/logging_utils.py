"""Colored, leveled logging (a copy of the JAX package's logging_utils).

Per-level ANSI colors on a terminal, INFO and below to stdout, WARNING and
above to stderr; idempotent handler install.
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
    out.setFormatter(_ColorFormatter(_FMT, _DATEFMT, sys.stdout))
    err = logging.StreamHandler(sys.stderr)
    err.setLevel(logging.WARNING)
    err.setFormatter(_ColorFormatter(_FMT, _DATEFMT, sys.stderr))

    logger.addHandler(out)
    logger.addHandler(err)
    logger._pst_configured = True  # type: ignore[attr-defined]
    return logger
