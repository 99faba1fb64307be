"""End-to-end request deadlines, the engine's side.

A copy of ``Deadline``, ``parse_deadline`` and the two header names of
the JAX package's ``resilience/deadline.py``; the router's side (latency
tracking, hedging, attempt budgets) is not ported.

Wire contract:

- ``X-PST-Deadline-Ms`` carries the remaining budget in milliseconds as a
  *relative* value (like gRPC's ``grpc-timeout``), so clocks across hops
  never need to agree. The engine converts it to a monotonic deadline on
  arrival.
- ``X-PST-Deadline-Exceeded: 1`` tags every 504 produced by a deadline
  shed, so the router tells a budget shed from an engine failure.

Deadlines ride ``time.monotonic()``: wall-clock steps must never extend
or shrink a budget.
"""

from __future__ import annotations

import math
import time
from typing import Optional

DEADLINE_HEADER = "X-PST-Deadline-Ms"
DEADLINE_EXCEEDED_HEADER = "X-PST-Deadline-Exceeded"


class Deadline:
    """A monotonic deadline derived from a millisecond budget."""

    __slots__ = ("expires_at",)

    def __init__(self, budget_ms: float, now: Optional[float] = None):
        now = now if now is not None else time.monotonic()
        self.expires_at = now + budget_ms / 1000.0

    def remaining_s(self, now: Optional[float] = None) -> float:
        now = now if now is not None else time.monotonic()
        return self.expires_at - now

    def remaining_ms(self, now: Optional[float] = None) -> float:
        return self.remaining_s(now) * 1000.0

    def expired(self, now: Optional[float] = None) -> bool:
        return self.remaining_s(now) <= 0.0

    def header_value(self, now: Optional[float] = None) -> str:
        """Remaining budget for downstream propagation. Ceil, not floor: a
        live deadline must never serialize to ``0``, which the next hop
        would shed on arrival."""
        return str(max(0, math.ceil(self.remaining_ms(now))))


def parse_deadline(
    headers, default_ms: float = 0.0, now: Optional[float] = None
) -> Optional[Deadline]:
    """Deadline from ``X-PST-Deadline-Ms`` (falling back to ``default_ms``;
    ``None`` when neither applies). ``headers`` is any mapping with
    ``get`` and ``items``: the ``http.server`` request headers (an
    ``email.message.Message``, case-insensitive) or a plain dict of any
    casing. Malformed or negative values are ignored: a bad budget from
    one client must not turn into request failures."""
    raw = headers.get(DEADLINE_HEADER)
    if raw is None:  # a plain dict may carry another casing
        lk = DEADLINE_HEADER.lower()
        for k, v in headers.items():
            if k.lower() == lk:
                raw = v
                break
    if raw is not None:
        try:
            budget = float(raw)
            if budget >= 0:
                return Deadline(budget, now)
        except (TypeError, ValueError):
            pass
    if default_ms and default_ms > 0:
        return Deadline(default_ms, now)
    return None
