"""Tenant-fair admission order, the engine's side.

A copy of ``DeficitScheduler`` and ``MAX_ADHOC_TENANTS`` of the JAX
package's ``resilience/tenancy.py``. The router derives a request's
tenant and tier at admission and stamps them on the upstream hop as
``X-PST-Tenant`` and ``X-PST-Tenant-Class``; the engine's scheduler
admits its waiting queue by tier first (interactive before batch) and,
within a tier, by deficit round robin across tenants.
"""

from __future__ import annotations

from typing import Dict, Optional

# Ad-hoc tenants (names seen on the wire with no configured spec) are
# tracked in bounded tables: a flood of unique tenant names must cost
# O(cap), never O(traffic history).
MAX_ADHOC_TENANTS = 1024


class DeficitScheduler:
    """Engine-side DRR over tenant classes: the scheduler's ready-queue
    ordering. ``charge`` is called when a tenant's sequence is admitted,
    ``pick`` chooses which of the currently waiting tenants admits next.
    Weights default to 1.0."""

    def __init__(self, quantum: float = 1.0) -> None:
        self.quantum = max(quantum, 1e-9)
        self._credit: Dict[str, float] = {}

    # Credit clamp: the DRR lag bound. Without it a tenant charged while
    # running solo (no contested pick) would bank unbounded debt and be
    # starved for O(history) admissions when a competitor appears.
    CREDIT_BOUND = 4.0

    def pick(self, candidates: Dict[str, float]) -> Optional[str]:
        """Choose among ``{tenant: weight}`` waiting classes: the tenant
        with the highest deficit-per-weight debt is served next; deficits
        grow by quantum × weight per pick so long-run admissions track
        weights. A single candidate short-circuits."""
        if not candidates:
            return None
        if len(candidates) == 1:
            return next(iter(candidates))
        for t, w in candidates.items():
            self._credit[t] = min(
                self._credit.get(t, 0.0) + self.quantum * max(w, 1e-6),
                self.CREDIT_BOUND,
            )
        # Highest credit wins; ties break by name (deterministic, and fair
        # over time because the loser keeps its credit).
        return max(candidates, key=lambda t: (self._credit.get(t, 0.0), t))

    def charge(self, tenant: str) -> None:
        self._credit[tenant] = max(
            self._credit.get(tenant, 0.0) - 1.0, -self.CREDIT_BOUND
        )
        # Forget long-idle tenants opportunistically.
        if len(self._credit) > MAX_ADHOC_TENANTS:
            self._credit = {
                t: d for t, d in self._credit.items() if abs(d) > 1e-9
            }
