"""Chaos injection + request reliability.

One seeded :class:`Scenario` drives BOTH timelines: the virtual-time
simulator (``simulate_cluster(chaos=...)``) and a live
:class:`ChaosController` thread perturbing a real cluster.  The
:class:`Reliability` layer (per-class retries with deadline-aware
exponential backoff, a cluster-level retry budget, hedged interactive
requests, brownout degradation) is what the injections exercise.

``ChaosController`` is imported lazily — it pulls in the cluster
front-end, which itself (via the simulator) depends on this package's
policy types.
"""
from repro_torch.chaos.engine import ChaosTimeline
from repro_torch.chaos.reliability import (BrownoutPolicy, Reliability,
                                     RetryBudget, RetryPolicy)
from repro_torch.chaos.scenario import (DEFAULT_LADDER, FAIL_STOP, KINDS,
                                  PARTITION, RACK_FAIL, SPOT_PREEMPT,
                                  STRAGGLER, THERMAL, WEDGE, Injection,
                                  Scenario, generate)

__all__ = [
    "BrownoutPolicy", "ChaosController", "ChaosTimeline", "DEFAULT_LADDER",
    "FAIL_STOP", "Injection", "KINDS", "PARTITION", "RACK_FAIL",
    "Reliability", "RetryBudget", "RetryPolicy", "SPOT_PREEMPT",
    "STRAGGLER", "Scenario", "THERMAL", "WEDGE", "generate",
]


def __getattr__(name):
    if name == "ChaosController":   # lazy: avoids a cluster import cycle
        from repro_torch.chaos.live import ChaosController
        return ChaosController
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
