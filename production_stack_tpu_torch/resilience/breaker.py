"""Per-shard circuit breakers for the sharded remote-KV client.

A copy of the JAX package's ``resilience/breaker.py`` ``CircuitBreaker``,
trimmed to what the sharded KV client uses (no router registry, no
Prometheus gauges). Classic three-state breaker:

- CLOSED: calls flow; ``failure_threshold`` consecutive failures trip the
  breaker OPEN.
- OPEN: the shard is skipped. After ``recovery_time`` seconds the
  breaker turns HALF_OPEN.
- HALF_OPEN: up to ``half_open_probes`` calls go through as probes. One
  success closes the breaker; one failure re-opens it (and restarts the
  recovery clock).

Not thread-safe on its own: the sharded client guards every breaker
touch with one lock.
"""

from __future__ import annotations

import enum
import time
from typing import List, Optional

from ..logging_utils import init_logger

logger = init_logger(__name__)


class BreakerState(enum.Enum):
    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"


class CircuitBreaker:
    def __init__(
        self,
        url: str,
        failure_threshold: int = 5,
        recovery_time: float = 10.0,
        half_open_probes: int = 1,
    ):
        self.url = url
        self.failure_threshold = max(1, failure_threshold)
        self.recovery_time = recovery_time
        self.half_open_probes = max(1, half_open_probes)
        self.state = BreakerState.CLOSED
        self.consecutive_failures = 0
        self.opened_at: Optional[float] = None
        # HALF_OPEN probe reservations (timestamps); each expires after
        # recovery_time, so a reservation never used cannot wedge it.
        self._probes: List[float] = []

    def _transition(self, state: BreakerState, now: float) -> None:
        if state is self.state:
            return
        logger.info("breaker %s: %s -> %s", self.url, self.state.value,
                    state.value)
        self.state = state
        if state is BreakerState.OPEN:
            self.opened_at = now
            self._probes.clear()
        elif state is BreakerState.CLOSED:
            self.consecutive_failures = 0
            self.opened_at = None
            self._probes.clear()

    def _maybe_half_open(self, now: float) -> None:
        if (self.state is BreakerState.OPEN and self.opened_at is not None
                and now - self.opened_at >= self.recovery_time):
            self._transition(BreakerState.HALF_OPEN, now)

    def current_state(self, now: Optional[float] = None) -> BreakerState:
        """Effective state (OPEN turns HALF_OPEN once the recovery window
        has passed) without reserving a probe slot."""
        self._maybe_half_open(now if now is not None else time.time())
        return self.state

    def _free_probe_slot(self, now: float) -> bool:
        ttl = max(self.recovery_time, 1.0)
        self._probes = [t for t in self._probes if now - t < ttl]
        return len(self._probes) < self.half_open_probes

    def allows(self, now: Optional[float] = None) -> bool:
        """May a call go to this shard now? In HALF_OPEN each True
        reserves one probe slot."""
        now = now if now is not None else time.time()
        self._maybe_half_open(now)
        if self.state is BreakerState.CLOSED:
            return True
        if self.state is BreakerState.HALF_OPEN and self._free_probe_slot(now):
            self._probes.append(now)
            return True
        return False

    def record_success(self, now: Optional[float] = None) -> None:
        now = now if now is not None else time.time()
        self.consecutive_failures = 0
        if self.state is not BreakerState.CLOSED:
            self._transition(BreakerState.CLOSED, now)

    def record_failure(self, now: Optional[float] = None) -> None:
        now = now if now is not None else time.time()
        self._maybe_half_open(now)
        if self.state is BreakerState.HALF_OPEN:
            self._transition(BreakerState.OPEN, now)
            return
        self.consecutive_failures += 1
        if (self.state is BreakerState.CLOSED
                and self.consecutive_failures >= self.failure_threshold):
            self._transition(BreakerState.OPEN, now)
