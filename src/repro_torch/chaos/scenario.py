"""Seeded, deterministic fault-scenario vocabulary.

A :class:`Scenario` is a named, seeded tuple of :class:`Injection`s —
the shared chaos vocabulary BOTH timelines consume:
:func:`repro_torch.cluster.sim.simulate_cluster` schedules the injections in
virtual time, and the live :class:`repro_torch.chaos.live.ChaosController`
replays the same scenario against a real :class:`repro_torch.cluster.Cluster`
on the wall clock.  Because a scenario is plain data, the same seeded
correlated-failure day can be asserted bit-identical in simulation and
then rehearsed against real servers.

Injection kinds (the paper's "resources change under you", taken to
cluster scale):

* ``fail_stop``     — the node dies NOW; queued work resolves failed.
* ``wedge``         — silent stall: routable, accepts work, completes
  nothing — only the stall health check can see it.
* ``straggler``     — service slows ×``factor`` for ``duration_s``
  (thermal neighbour, noisy co-tenant, fabric retries).
* ``thermal``       — DVFS ladder degradation: the node's temperature
  throttle steps down ``ladder`` over ``duration_s`` then recovers —
  the paper's governor-throttling story as an injected fault.
* ``spot_preempt``  — preemption WITH notice: the node drains for
  ``notice_s`` (no new routes, queues serve out) and then fail-stops.
* ``rack_fail``     — correlated failure: every node in ``nodes``
  fail-stops at the same instant.
* ``partition``     — the router→node edge drops for ``duration_s``:
  no NEW routes reach the node, but it keeps serving what it has.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Sequence, Tuple

FAIL_STOP = "fail_stop"
WEDGE = "wedge"
STRAGGLER = "straggler"
THERMAL = "thermal"
SPOT_PREEMPT = "spot_preempt"
RACK_FAIL = "rack_fail"
PARTITION = "partition"
KINDS = (FAIL_STOP, WEDGE, STRAGGLER, THERMAL, SPOT_PREEMPT, RACK_FAIL,
         PARTITION)

# default DVFS ladder a thermal injection steps through (fractions of
# full frequency, mirroring the LUT's hw-state freq tiers)
DEFAULT_LADDER = (0.875, 0.75, 0.625, 0.5)


@dataclasses.dataclass(frozen=True)
class Injection:
    """One scheduled fault.  ``t`` is seconds from scenario start
    (virtual seconds in the sim; wall seconds / ``speed`` live)."""
    t: float
    kind: str
    node: Optional[str] = None          # target (all kinds but rack_fail)
    nodes: Tuple[str, ...] = ()         # rack_fail: the correlated set
    factor: float = 2.0                 # straggler: service slowdown ×k
    duration_s: float = 0.0             # straggler / thermal / partition
    notice_s: float = 0.0               # spot_preempt: drain window
    ladder: Tuple[float, ...] = DEFAULT_LADDER   # thermal: throttle steps

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown injection kind {self.kind!r} "
                             f"(not in {KINDS})")
        if self.kind == RACK_FAIL:
            if not self.nodes:
                raise ValueError("rack_fail needs a non-empty `nodes`")
        elif self.node is None:
            raise ValueError(f"{self.kind} needs a target `node`")

    def targets(self) -> Tuple[str, ...]:
        return self.nodes if self.kind == RACK_FAIL else (self.node,)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A named, ordered fault schedule (plain data, fully seeded)."""
    name: str = "scenario"
    seed: int = 0
    injections: Tuple[Injection, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "injections",
                           tuple(sorted(self.injections,
                                        key=lambda i: (i.t, i.kind))))

    def summary(self) -> List[Tuple[float, str, str]]:
        """``(t, kind, node)`` per target — what reports embed."""
        out = []
        for inj in self.injections:
            for nn in inj.targets():
                out.append((inj.t, inj.kind, nn))
        return out


def generate(seed: int, horizon_s: float, node_names: Sequence[str], *,
             racks: Optional[Dict[str, Sequence[str]]] = None,
             n_faults: int = 4,
             kinds: Sequence[str] = (STRAGGLER, THERMAL, WEDGE,
                                     SPOT_PREEMPT, PARTITION, RACK_FAIL,
                                     FAIL_STOP),
             name: str = "generated") -> Scenario:
    """Seeded random scenario: ``n_faults`` injections drawn uniformly
    over ``kinds``/``node_names``/[0, horizon_s).  Same seed ⇒ same
    scenario ⇒ (through the deterministic simulator) bit-identical
    reports — the chaos determinism tests run exactly this."""
    rng = random.Random(seed)
    racks = dict(racks or {})
    injections: List[Injection] = []
    for _ in range(n_faults):
        kind = rng.choice(list(kinds))
        t = round(rng.uniform(0.0, horizon_s), 3)
        if kind == RACK_FAIL and racks:
            rack = rng.choice(sorted(racks))
            injections.append(Injection(t=t, kind=kind,
                                        nodes=tuple(racks[rack])))
            continue
        if kind == RACK_FAIL:
            kind = FAIL_STOP   # no rack map: degrade to a single failure
        nn = rng.choice(list(node_names))
        injections.append(Injection(
            t=t, kind=kind, node=nn,
            factor=round(rng.uniform(1.5, 4.0), 2),
            duration_s=round(rng.uniform(0.5, horizon_s / 2), 3),
            notice_s=round(rng.uniform(0.2, 2.0), 3)))
    return Scenario(name=f"{name}-{seed}", seed=seed,
                    injections=tuple(injections))
