"""Request reliability policies: retries, hedges, budget, brownout.

Chaos injection (:mod:`repro_torch.chaos.scenario`) exposes what the serving
stack was missing: a request caught in a failure simply resolved with
an error payload.  This module is the policy layer both drivers consume
(:func:`repro_torch.cluster.sim.simulate_cluster` ``reliability=`` and
:func:`repro_torch.traffic.driver.drive_live` ``reliability=``):

* :class:`RetryPolicy` — per-class: bounded attempts, exponential
  backoff, and DEADLINE-AWARE: a retry that cannot even be resubmitted
  before the request's SLO deadline is never scheduled (it would burn
  capacity to produce a guaranteed-late answer).
* :class:`RetryBudget` — cluster-level: total retries granted may never
  exceed ``burst + fraction × completed`` — a retry storm against a
  degraded fleet self-limits instead of melting the survivors.
* :class:`BrownoutPolicy` — graceful degradation: when the smoothed
  chaos pressure (failures+retries per outcome) of a class stays high,
  the arbiter pins it to its DEGRADE target
  (:meth:`repro_torch.runtime.arbiter.ResourceArbiter.set_brownout`) and
  shedding is suspended — serve degraded instead of dropping, the
  paper's degrade-don't-fail story under injected faults.
* Hedging (``RetryPolicy.hedge=True``) — an interactive-class request
  is enqueued on TWO distinct replicas; the first completion wins and
  the loser is accounted ``hedge_wasted``, never double-counted.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Per-class retry behaviour.  ``max_attempts`` counts the first
    try; ``backoff(k)`` is the wait before attempt ``k+1``."""
    max_attempts: int = 3
    backoff_s: float = 0.05
    backoff_mult: float = 2.0
    hedge: bool = False     # duplicate-submit to a second replica

    def backoff(self, attempts: int) -> float:
        """Backoff after ``attempts`` tries (exponential)."""
        return self.backoff_s * self.backoff_mult ** max(attempts - 1, 0)


@dataclasses.dataclass
class RetryBudget:
    """Cluster-level allowance: retries ≤ burst + fraction × goodput.

    Mutable counters — the drivers take a FRESH copy per run
    (:meth:`fresh`) so two runs from one config are independent and
    deterministic."""
    fraction: float = 0.1
    burst: int = 16
    granted: int = 0
    denied: int = 0

    def fresh(self) -> "RetryBudget":
        return RetryBudget(fraction=self.fraction, burst=self.burst)

    def allowance(self, completed: int) -> float:
        return self.burst + self.fraction * completed

    def allow(self, completed: int) -> bool:
        if self.granted + 1 <= self.allowance(completed):
            self.granted += 1
            return True
        self.denied += 1
        return False


@dataclasses.dataclass(frozen=True)
class BrownoutPolicy:
    """Enter/exit thresholds on the per-class chaos-pressure EWMA
    (failures+retries as a share of that epoch's outcomes)."""
    enter_pressure: float = 0.3
    exit_pressure: float = 0.05
    beta: float = 0.5           # EWMA smoothing per epoch


@dataclasses.dataclass
class Reliability:
    """The whole reliability layer, one object both drivers accept."""
    policies: Dict[str, RetryPolicy] = dataclasses.field(
        default_factory=dict)
    default: Optional[RetryPolicy] = dataclasses.field(
        default_factory=RetryPolicy)
    budget: RetryBudget = dataclasses.field(default_factory=RetryBudget)
    brownout: Optional[BrownoutPolicy] = dataclasses.field(
        default_factory=BrownoutPolicy)

    def policy_for(self, cls_name: str) -> Optional[RetryPolicy]:
        return self.policies.get(cls_name, self.default)
