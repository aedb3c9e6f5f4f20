"""Traffic layer: SLO-classed request streams over the runtime arbiter.

The paper's Fig. 1 stacks three layers; this package is the top one and
closes the loop with the other two:

* **application layer** — the paper's "multiple concurrent workloads"
  with "dynamically changing performance targets" become request
  *streams*: seeded arrival processes (:mod:`~repro_torch.traffic.arrivals` —
  Poisson, bursty ON-OFF, diurnal ramp, trace replay) tagged with an
  :class:`~repro_torch.traffic.slo.SLOClass` (deadline, priority, drop
  policy);
* **runtime resource management layer** — each class's SLO maps onto the
  :class:`~repro_torch.runtime.governor.Constraints` that the
  :class:`~repro_torch.runtime.arbiter.ResourceArbiter` water-fills; arriving
  load exercises the arbiter's admission control (an infeasible class is
  rejected at registration) and priority preemption (a high-priority
  arrival evicts lower-priority slices mid-cycle, not at the next
  constraint-clock tick);
* **hardware layer** — requests are ultimately served by
  :class:`~repro_torch.runtime.engine.DynamicServer` executables over the
  (chips x DVFS) states profiled in the LUTs: the port's ViT on the
  H100, its latency measured on the card.

The drivers (:mod:`~repro_torch.traffic.driver`) run the same classes either
through a deterministic virtual-time simulation (policy comparisons,
benchmarks) or against live servers (``launch/serve.py --trace``), and
report per-class p50/p95/p99 latency, goodput and drops in a
:class:`~repro_torch.traffic.driver.TrafficReport`.
"""
from repro_torch.traffic.arrivals import (diurnal, load_schedule, merge, onoff,
                                    poisson, replay, save_schedule)
from repro_torch.traffic.slo import (DEGRADE, DROP_POLICIES, REJECT, SHED,
                               SLOClass)
from repro_torch.traffic.driver import (BUCKETED_SERVICE, FIFO_POLICY,
                                  PADDED_SERVICE, SERVICE_MODELS, SLO_POLICY,
                                  ClassStats, TrafficReport, drive_live,
                                  simulate)
