"""Runtime monitoring + workload/hardware trace simulation.

The paper's management layer "monitors the dynamically changing algorithm
performance targets as well as hardware resources and constraints".  The
monitor tracks latency violations and integrated energy; the trace
simulator reproduces the paper's experimental conditions: phase-changing
latency targets [2], thermal throttling, and co-running applications
stealing compute.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional

from repro_torch.runtime.governor import Constraints


@dataclasses.dataclass
class StepLog:
    t: float
    target_ms: float
    latency_ms: float
    energy_mj: float
    accuracy: float
    subnet: str
    hw: str
    violated: bool


@dataclasses.dataclass
class Monitor:
    logs: List[StepLog] = dataclasses.field(default_factory=list)

    def record(self, t, c: Constraints, point, latency_ms=None):
        lat = latency_ms if latency_ms is not None else point.latency_ms
        self.logs.append(StepLog(
            t=t, target_ms=c.target_latency_ms, latency_ms=lat,
            energy_mj=point.energy_mj, accuracy=point.accuracy,
            subnet=point.subnet.name() if hasattr(point.subnet, "name")
            else str(point.subnet),
            hw=point.hw_state.name(), violated=lat > c.target_latency_ms))

    @property
    def total_energy_mj(self) -> float:
        return sum(l.energy_mj for l in self.logs)

    @property
    def violation_rate(self) -> float:
        return (sum(l.violated for l in self.logs) / len(self.logs)
                if self.logs else 0.0)

    @property
    def mean_latency_ms(self) -> float:
        return (sum(l.latency_ms for l in self.logs) / len(self.logs)
                if self.logs else 0.0)

    @property
    def mean_accuracy(self) -> float:
        return (sum(l.accuracy for l in self.logs) / len(self.logs)
                if self.logs else 0.0)

    def summary(self) -> dict:
        return {"steps": len(self.logs),
                "energy_mj": round(self.total_energy_mj, 2),
                "violation_rate": round(self.violation_rate, 4),
                "mean_latency_ms": round(self.mean_latency_ms, 3),
                "mean_accuracy": round(self.mean_accuracy, 3)}


def paper_trace(n_steps: int = 300, *, chips: int = 1,
                base_target_ms: float = 30.0, seed: int = 0
                ) -> Iterator[Constraints]:
    """The paper's runtime conditions as a deterministic trace:

    - three application phases with different latency targets [2],
    - a thermal-throttling window (frequency cap 0.7),
    - a co-running workload window (half the chips taken).
    """
    import numpy as np
    rng = np.random.default_rng(seed)
    for i in range(n_steps):
        phase = (i // 50) % 3
        target = base_target_ms * (1.0, 0.5, 2.0)[phase]
        target *= float(1.0 + 0.1 * rng.standard_normal())
        throttle = 0.7 if 120 <= i < 180 else 1.0
        avail = chips // 2 if 200 <= i < 260 else chips
        yield Constraints(target_latency_ms=max(target, 1.0),
                          chips_available=avail,
                          temperature_throttle=throttle)


def run_governor(governor, trace, monitor: Optional[Monitor] = None,
                 measure_fn=None) -> Monitor:
    """Drive a governor through a trace; optionally measure real latency."""
    mon = monitor or Monitor()
    for i, c in enumerate(trace):
        point = governor.select(c)
        lat = measure_fn(point) if measure_fn else None
        mon.record(float(i), c, point, latency_ms=lat)
    return mon
