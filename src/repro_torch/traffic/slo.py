"""SLO classes: the traffic layer's contract with the runtime manager.

An :class:`SLOClass` states what a request stream needs (an end-to-end
deadline), how important it is (arbitration priority), and what to do
when the machine can't keep up (drop policy).  It maps onto the runtime
layer's :class:`~repro_torch.runtime.governor.Constraints` by reserving part of
the deadline for queueing: the arbiter plans service time against
``service_frac * deadline`` so a request that waits a little still
replies in time.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.runtime.governor import Constraints

# Drop policies — what happens when the class's minimal feasible share
# cannot fit (admission) or a request is predicted to miss (shedding):
REJECT = "reject"     # admission-reject the whole class when infeasible
SHED = "shed"         # admit, but shed requests predicted to miss
DEGRADE = "degrade"   # never drop: relax the target and serve late
DROP_POLICIES = (REJECT, SHED, DEGRADE)


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """One request class with a service-level objective.

    ``deadline_ms`` bounds submit->reply; ``priority`` feeds the arbiter's
    water-filling (and preemption) order; ``drop_policy`` picks the
    overload behaviour above.  ``service_frac`` is the fraction of the
    deadline budgeted for pure service — the rest absorbs queueing.
    ``max_batch`` is the class's serving batch ceiling: the batching-aware
    service model amortises one bucket-sized forward over up to this many
    queued requests (mirrors ``DynamicServer(max_batch=...)``).
    """
    name: str
    deadline_ms: float
    priority: int = 0
    drop_policy: str = SHED
    min_accuracy: Optional[float] = None
    service_frac: float = 0.5
    degrade_factor: float = 4.0   # DEGRADE: relaxed-target multiplier
    max_batch: int = 8            # serving batch ceiling (bucket ladder top)

    def __post_init__(self):
        if self.deadline_ms <= 0:
            raise ValueError(f"{self.name}: deadline_ms must be > 0")
        if self.drop_policy not in DROP_POLICIES:
            raise ValueError(f"{self.name}: drop_policy "
                             f"{self.drop_policy!r} not in {DROP_POLICIES}")
        if not 0.0 < self.service_frac <= 1.0:
            raise ValueError(f"{self.name}: service_frac must be in (0, 1]")
        if self.max_batch < 1:
            raise ValueError(f"{self.name}: max_batch must be >= 1")

    @property
    def service_target_ms(self) -> float:
        """The latency target handed to the arbiter/governor."""
        return self.deadline_ms * self.service_frac

    @property
    def degraded_target_ms(self) -> float:
        """Fallback target when a DEGRADE class fails admission."""
        return self.service_target_ms * self.degrade_factor

    def constraints(self, *, chips_available: int,
                    power_budget_w: Optional[float] = None,
                    temperature_throttle: float = 1.0,
                    share: float = 1.0) -> Constraints:
        """This class's SLO phrased as single-workload Constraints."""
        return Constraints(target_latency_ms=self.service_target_ms,
                           chips_available=chips_available,
                           power_budget_w=power_budget_w,
                           min_accuracy=self.min_accuracy,
                           temperature_throttle=temperature_throttle,
                           priority=self.priority, share=share)
