"""Runtime governors: the paper's joint algorithm+hardware manager and the
baselines it is compared against.

* :class:`JointGovernor` — the paper's approach: pick the
  (sub-network, hardware state) pair that meets the current latency target
  under the current hardware constraints with maximum accuracy, breaking
  ties by minimum energy.  Hysteresis avoids oscillation.
* :class:`PerformanceGovernor` — Linux ``performance``: max frequency,
  fixed full network (hardware knob pinned, no algorithm knob).
* :class:`SchedutilGovernor` — Linux ``schedutil``-like: frequency tracks
  utilisation (latency/target), fixed full network.
* :class:`StaticPrunedGovernor` — platform-aware static pruning
  (NetAdapt-style [1]): a single subnet chosen offline for the worst-case
  hardware configuration, then never changed.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.pareto import OpPoint
from repro_torch.runtime import hwmodel as hm
from repro_torch.runtime.lut import LUT


@dataclasses.dataclass
class Constraints:
    target_latency_ms: float
    chips_available: int
    power_budget_w: Optional[float] = None
    min_accuracy: Optional[float] = None
    temperature_throttle: float = 1.0   # <1 caps the frequency ladder


class GovernorBase:
    name = "base"

    def select(self, c: Constraints) -> OpPoint:
        raise NotImplementedError


class JointGovernor(GovernorBase):
    """The paper's runtime resource manager."""

    name = "joint"

    def __init__(self, lut: LUT, *, hysteresis_acc: float = 0.15,
                 hysteresis_energy: float = 0.05):
        self.lut = lut
        self.current: Optional[OpPoint] = None
        self.h_acc = hysteresis_acc
        self.h_energy = hysteresis_energy

    def _feasible(self, c: Constraints):
        return self.lut.feasible(
            max_latency_ms=c.target_latency_ms,
            chips_available=c.chips_available,
            power_budget_w=c.power_budget_w,
            min_accuracy=c.min_accuracy,
            max_freq=c.temperature_throttle)

    def select(self, c: Constraints) -> OpPoint:
        feasible = self._feasible(c)
        if not feasible:
            # infeasible target: degrade gracefully to the fastest point
            # that still respects the thermal throttle and power grant
            choice = self.lut.fastest(c.chips_available,
                                      max_freq=c.temperature_throttle,
                                      power_budget_w=c.power_budget_w)
            self.current = choice
            return choice
        # max accuracy, tie-break min energy
        best = max(feasible, key=lambda p: (p.accuracy, -p.energy_mj))
        cur = self.current
        if cur is not None and cur in feasible:
            # hysteresis: only switch for a real improvement
            if (best.accuracy - cur.accuracy) < self.h_acc and \
               best.energy_mj > cur.energy_mj * (1 - self.h_energy):
                best = cur
        self.current = best
        return best


class PerformanceGovernor(GovernorBase):
    """Max frequency, full network — hardware-only policy."""

    name = "performance"

    def __init__(self, lut: LUT, full_spec):
        self.point_by_chips = {}
        for p in lut.points:
            if p.subnet == full_spec and p.hw_state.freq == 1.0:
                self.point_by_chips[p.hw_state.chips] = p

    def select(self, c: Constraints) -> OpPoint:
        chips = max((k for k in self.point_by_chips
                     if k <= c.chips_available),
                    default=min(self.point_by_chips))
        return self.point_by_chips[chips]


class SchedutilGovernor(GovernorBase):
    """Utilisation-tracking DVFS, full network (no algorithm knob)."""

    name = "schedutil"

    def __init__(self, lut: LUT, full_spec):
        self.points = [p for p in lut.points if p.subnet == full_spec]
        self.freq = 1.0

    def select(self, c: Constraints) -> OpPoint:
        cands = [p for p in self.points
                 if p.hw_state.chips <= c.chips_available]
        if not cands:
            cands = self.points
        # pick the lowest frequency that still meets the target; if none
        # meets it, run at max frequency (classic schedutil ramp)
        meeting = [p for p in cands if p.latency_ms <= c.target_latency_ms]
        if meeting:
            choice = min(meeting, key=lambda p: p.hw_state.freq)
        else:
            choice = max(cands, key=lambda p: p.hw_state.freq)
        self.freq = choice.hw_state.freq
        return choice


class StaticPrunedGovernor(GovernorBase):
    """NetAdapt-style static pruning: one subnet sized offline for the
    worst-case hardware state, max frequency forever."""

    name = "static-pruned"

    def __init__(self, lut: LUT, *, worst_case: Constraints):
        feas = lut.feasible(max_latency_ms=worst_case.target_latency_ms,
                            chips_available=worst_case.chips_available)
        feas = [p for p in feas if p.hw_state.freq == 1.0]
        if feas:
            self.point = max(feas, key=lambda p: p.accuracy)
        else:
            self.point = lut.fastest(worst_case.chips_available)
        # the deployed static model: same subnet regardless of conditions
        self.points_same_subnet = [p for p in lut.points
                                   if p.subnet == self.point.subnet
                                   and p.hw_state.freq == 1.0]

    def select(self, c: Constraints) -> OpPoint:
        cands = [p for p in self.points_same_subnet
                 if p.hw_state.chips <= c.chips_available] or [self.point]
        return max(cands, key=lambda p: p.hw_state.chips)
