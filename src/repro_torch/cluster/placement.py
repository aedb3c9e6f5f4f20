"""Cluster-wide placement engine: the node-level objective, one level up.

:mod:`repro_torch.runtime.waterfill` holds the arbiter's min-share +
backlog-first-surplus objective as a level-agnostic solver; this module runs the SAME objective over nodes
instead of chip slices — the hierarchical resource manager of Xun et al.
(arXiv:2105.03608), with the switching-cost awareness of Dynamic-OFA
(arXiv:2105.03596): a reconfiguration is only worth its price.

Four pure planners, all deterministic (the simulator scripts them with
``rebalance_at``/``scale_at``; the live front-end runs them on a
``rebalance_interval_s`` thread):

* :func:`solve_placement` — fresh global K-replica solve.  Pass 1 gives
  every class, in priority order, ONE replica on the node where its
  minimal feasible share is smallest (the solver's own min-share key);
  pass 2+ pours the surplus back, backlog-first, adding replicas on
  further nodes until nothing fits or the replica cap is reached.
  Per-node budgets reserve only equal-or-higher-priority shares —
  lower-priority tenants are preemptable, exactly the single-node
  admission rule — so with ``replicas=None`` and uniform headroom the
  solve reproduces today's replicate-everywhere placement.
* :func:`plan_rebalance` — diff the fresh solve against the current
  placements and price every proposed change with its REAL cost:
  :func:`migration_cost` charges a new replica the bucket-ladder
  warmup (calibrated latencies when a store is attached) plus the
  weight transfer, in seconds and joules (calibrated watts; the slice's
  modelled watts come from the port's H100 constants,
  ``runtime/hwmodel.py``).  A change
  is approved only when the backlog it can drain over the rebalance
  horizon beats ``hysteresis`` times its cost — steady load diffs to
  nothing, so the no-flapping guarantee is structural, not tuned.
* :func:`plan_preemptions` — cross-node preemption: a backlogged
  high-priority class evicts the lowest-priority co-located replica
  that still has another routable home, so the hot class gets the
  whole node and the victim's traffic reroutes (wired through the
  arbiter's existing ``export_tenant``/``preempt`` machinery by the
  callers).
* :func:`plan_scaling` — autoscaling over the node pool: sustained
  backlog per chip spins a STANDBY node up; an idle cluster under a
  high energy price spins the smallest UP node down (never below
  ``min_nodes``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.cluster.node import STANDBY, UP, ClusterNode
from repro_torch.runtime import hwmodel as hm
from repro_torch.runtime import waterfill as wf
from repro_torch.runtime.lut import LUT, bucket_ladder, bucket_latency_ms

# priced-migration hysteresis: a change must promise this many times its
# cost in drained-backlog seconds before it is applied
DEFAULT_HYSTERESIS = 2.0
# modelled weight-transfer time for one replica's parameters (the image
# has no real NIC to measure; calibrated warmup dominates in practice)
DEFAULT_TRANSFER_S = 0.25
# autoscaler thresholds (backlog per chip, cluster-wide EWMA)
SCALE_UP_BACKLOG = 2.0
SCALE_DOWN_BACKLOG = 0.25
PRICE_HIGH = 1.0


@dataclasses.dataclass
class ClassSpec:
    """One SLO class, phrased for the placement planners."""
    name: str
    lut: LUT
    target_latency_ms: float
    priority: int = 0
    min_accuracy: Optional[float] = None
    backlog: float = 0.0          # cluster-wide queued requests
    max_batch: int = 8
    # DEGRADE (never-drop) classes: when NO node admits the strict
    # target, place best-effort everywhere at this relaxed target
    fallback_target_ms: Optional[float] = None


@dataclasses.dataclass
class PlacementPlan:
    """A fresh global solve: class -> replica nodes."""
    placements: Dict[str, List[str]]
    best_effort: List[str]         # classes placed via fallback_target_ms


@dataclasses.dataclass(frozen=True)
class MigrationCost:
    """What standing a replica up on a new node really costs."""
    seconds: float    # weight transfer + bucket-ladder warmup
    joules: float     # seconds x calibrated slice watts


@dataclasses.dataclass(frozen=True)
class Move:
    """One proposed placement change (add / remove / move)."""
    cls: str
    src: Optional[str]             # None => pure add (scale-out)
    dst: Optional[str]             # None => pure remove (scale-in)
    cost_s: float
    cost_j: float
    benefit_s: float               # backlog drained over the horizon

    @property
    def kind(self) -> str:
        if self.src and self.dst:
            return "move"
        return "add" if self.dst else "remove"


@dataclasses.dataclass
class RebalancePlan:
    """Fresh solve + the priced diff against the current placements."""
    target: PlacementPlan
    moves: List[Move]              # approved: benefit beats priced cost
    rejected: List[Move]           # priced out by hysteresis


@dataclasses.dataclass(frozen=True)
class Eviction:
    """Cross-node preemption: evict ``victim``'s replica on ``node`` so
    backlogged ``for_cls`` stops sharing the machine with it."""
    victim: str
    node: str
    for_cls: str


@dataclasses.dataclass
class ScalePlan:
    """One autoscaling step (at most one action per call — the caller's
    EWMA provides the 'sustained' hysteresis)."""
    spin_up: List[str]
    spin_down: List[str]


# --- demands (the solver's view of one class on one node) -------------------

def _planning_lut(lut: LUT, calibration) -> LUT:
    """Raw LUT, or point latencies re-estimated from measured buckets —
    the same blend the node arbiters plan with."""
    if calibration is None:
        return lut
    return LUT([dataclasses.replace(
        p, latency_ms=calibration.point_latency_ms(p.subnet, p.latency_ms))
        for p in lut.points])


def _power_scale(name: str, calibration) -> float:
    if calibration is None:
        return 1.0
    return max(1e-6, calibration.power_scale(name))


def _demand_on(spec: ClassSpec, node: ClusterNode, t: float,
               calibration) -> wf.Demand:
    """Phrase ``spec`` hosted on ``node`` as a solver demand — identical
    arithmetic to the arbiter's own demand construction."""
    g = node.g(t)
    scale = _power_scale(spec.name, calibration)
    lut = _planning_lut(spec.lut, calibration)

    def priced(p) -> wf.PricedPoint:
        base = hm.slice_power_w(p.hw_state)
        return wf.PricedPoint(units=p.hw_state.chips, cost=base * scale,
                              base_cost=base, latency_ms=p.latency_ms,
                              accuracy=p.accuracy, energy_mj=p.energy_mj,
                              payload=p)

    def feasible(chips_cap: int, power_cap: float):
        pts = lut.feasible(
            max_latency_ms=spec.target_latency_ms,
            chips_available=chips_cap,
            power_budget_w=(None if math.isinf(power_cap)
                            else power_cap / scale),
            min_accuracy=spec.min_accuracy,
            max_freq=g.temperature_throttle)
        return [priced(p) for p in pts]

    def candidates(chips_cap: int, power_cap: float):
        return [priced(p) for p in lut.points
                if p.hw_state.chips <= chips_cap
                and hm.slice_power_w(p.hw_state) * scale <= power_cap]

    return wf.Demand(name=spec.name, feasible=feasible,
                     candidates=candidates, priority=spec.priority,
                     backlog=spec.backlog)


@dataclasses.dataclass
class _NodeBudget:
    """Per-node capacity with priority-aware reservations: a query at
    priority p sees capacity minus equal-or-higher-priority shares only
    (lower-priority tenants are preemptable — the admission rule)."""
    chips: int
    power: float
    reserved: List[Tuple[int, int, float]] = dataclasses.field(
        default_factory=list)   # (priority, chips, priced_w)

    def caps(self, priority: int) -> Tuple[int, float]:
        chips = self.chips - sum(r[1] for r in self.reserved
                                 if r[0] >= priority)
        power = self.power - sum(r[2] for r in self.reserved
                                 if r[0] >= priority)
        return chips, power

    def reserve(self, priority: int, point: wf.PricedPoint):
        self.reserved.append((priority, point.units, point.cost))


# --- the fresh global solve -------------------------------------------------

def solve_placement(specs: Sequence[ClassSpec],
                    nodes: Sequence[ClusterNode], *, t: float = 0.0,
                    replicas: Optional[int] = None,
                    calibration=None) -> PlacementPlan:
    """Fresh K-replica placement: the waterfill objective over nodes.

    ``replicas=None`` means replicate on every node that fits (today's
    behaviour); an integer caps each class's replica count.  Only
    routable (UP) nodes are considered.
    """
    up = [n for n in nodes if n.routable]
    budgets = {n.name: _NodeBudget(
        chips=n.g(t).total_chips,
        power=(n.g(t).power_budget_w
               if n.g(t).power_budget_w is not None else math.inf))
        for n in up}
    demands = {(s.name, n.name): _demand_on(s, n, t, calibration)
               for s in specs for n in up}
    placements: Dict[str, List[str]] = {s.name: [] for s in specs}

    # pass 1: ONE replica per class, priority order (stable — ties by
    # spec order), on the node where its minimal share is smallest by
    # the solver's own min-share key; node ties go to node order.
    order = sorted(specs, key=lambda s: -s.priority)
    for s in order:
        best = None
        for n in up:
            chips_cap, power_cap = budgets[n.name].caps(s.priority)
            pt = wf.min_share_point(demands[(s.name, n.name)],
                                    chips_cap, power_cap)
            if pt is None:
                continue
            key = (pt.units, pt.base_cost, -pt.accuracy)
            if best is None or key < best[0]:
                best = (key, n.name, pt)
        if best is None:
            continue
        _, nn, pt = best
        budgets[nn].reserve(s.priority, pt)
        placements[s.name].append(nn)

    # pass 2+: surplus replicas, backlog-first (deepest backlog wins,
    # then priority), one new replica per class per pass, nodes in
    # order — until a full pass adds nothing or every class hit its cap.
    cap = len(up) if replicas is None else max(1, replicas)
    filling = sorted(order, key=lambda s: (-s.backlog, -s.priority))
    for _ in range(max(wf.MAX_FILL_PASSES, len(up))):
        changed = False
        for s in filling:
            if len(placements[s.name]) >= cap:
                continue
            hosted = set(placements[s.name])
            for n in up:
                if n.name in hosted:
                    continue
                chips_cap, power_cap = budgets[n.name].caps(s.priority)
                pt = wf.min_share_point(demands[(s.name, n.name)],
                                        chips_cap, power_cap)
                if pt is None:
                    continue
                budgets[n.name].reserve(s.priority, pt)
                placements[s.name].append(n.name)
                changed = True
                break
        if not changed:
            break

    # never-drop fallback: classes no node admits go best-effort
    # everywhere at their relaxed target (mirrors the DEGRADE path)
    best_effort = []
    for s in specs:
        if not placements[s.name] and s.fallback_target_ms is not None:
            placements[s.name] = [n.name for n in up]
            best_effort.append(s.name)
    return PlacementPlan(placements=placements, best_effort=best_effort)


# --- priced migrations ------------------------------------------------------

def migration_cost(spec: ClassSpec, *, calibration=None,
                   transfer_s: float = DEFAULT_TRANSFER_S) -> MigrationCost:
    """What a new replica of ``spec`` really costs before it serves.

    Warmup compiles/warms one batch per bucket of the class's ladder at
    its fastest point — calibrated per-bucket latencies when a store is
    attached — plus the weight transfer; joules price those seconds at
    the slice's calibrated watts.  This is the Dynamic-OFA lesson: a
    switch is only free in models that ignore it.
    """
    lut = _planning_lut(spec.lut, calibration)
    pt = min(lut.points, key=lambda p: (p.latency_ms, -p.accuracy))
    warm_ms = 0.0
    for b in bucket_ladder(spec.max_batch):
        warm_ms += bucket_latency_ms(pt.latency_ms, b, spec.max_batch,
                                     calibration=calibration, spec=pt.subnet)
    seconds = transfer_s + warm_ms / 1e3
    watts = hm.slice_power_w(pt.hw_state) * _power_scale(spec.name,
                                                         calibration)
    return MigrationCost(seconds=seconds, joules=seconds * watts)


def _service_s(spec: ClassSpec, calibration) -> float:
    """Per-request seconds at the class's fastest point (benefit unit)."""
    lut = _planning_lut(spec.lut, calibration)
    pt = min(lut.points, key=lambda p: (p.latency_ms, -p.accuracy))
    return pt.latency_ms / 1e3 / max(1, spec.max_batch)


def plan_rebalance(specs: Sequence[ClassSpec],
                   nodes: Sequence[ClusterNode],
                   current: Dict[str, Sequence[str]], *, t: float = 0.0,
                   horizon_s: float = 5.0,
                   hysteresis: float = DEFAULT_HYSTERESIS,
                   replicas: Optional[int] = None, calibration=None,
                   transfer_s: float = DEFAULT_TRANSFER_S) -> RebalancePlan:
    """Fresh solve, diffed against ``current``, every change priced.

    A proposed add/move is approved only when the backlog the new
    replica could drain over ``horizon_s`` exceeds ``hysteresis`` times
    its migration cost; an unpaired remove is approved only when the
    class keeps at least one replica.  Under steady load the fresh
    solve reproduces the current placements and the plan is empty —
    zero migrations, by construction.
    """
    plan = solve_placement(specs, nodes, t=t, replicas=replicas,
                           calibration=calibration)
    up_names = {n.name for n in nodes if n.routable}
    moves: List[Move] = []
    rejected: List[Move] = []
    for s in specs:
        cur = [nn for nn in current.get(s.name, ()) if nn in up_names]
        tgt = plan.placements[s.name]
        adds = [nn for nn in tgt if nn not in cur]
        removes = [nn for nn in cur if nn not in tgt]
        if not adds and not removes:
            continue
        cost = migration_cost(s, calibration=calibration,
                              transfer_s=transfer_s)
        # a new replica's worth: the queued work it could absorb within
        # the horizon, at the class's fastest per-request service time
        benefit_s = min(s.backlog * _service_s(s, calibration), horizon_s)
        # pair removes with adds into moves; leftovers are pure changes
        n_pairs = min(len(adds), len(removes))
        proposals = ([Move(cls=s.name, src=removes[i], dst=adds[i],
                           cost_s=cost.seconds, cost_j=cost.joules,
                           benefit_s=benefit_s) for i in range(n_pairs)]
                     + [Move(cls=s.name, src=None, dst=nn,
                             cost_s=cost.seconds, cost_j=cost.joules,
                             benefit_s=benefit_s)
                        for nn in adds[n_pairs:]]
                     + [Move(cls=s.name, src=nn, dst=None, cost_s=0.0,
                             cost_j=0.0, benefit_s=0.0)
                        for nn in removes[n_pairs:]])
        kept = len(cur)
        for mv in proposals:
            if mv.kind == "remove":
                # scale-in costs nothing but must never orphan the class
                if kept > 1:
                    moves.append(mv)
                    kept -= 1
                else:
                    rejected.append(mv)
            elif mv.benefit_s > hysteresis * mv.cost_s:
                moves.append(mv)
                if mv.kind == "add":
                    kept += 1
            else:
                rejected.append(mv)
    return RebalancePlan(target=plan, moves=moves, rejected=rejected)


# --- cross-node preemption --------------------------------------------------

def plan_preemptions(specs: Sequence[ClassSpec],
                     nodes: Sequence[ClusterNode],
                     placements: Dict[str, Sequence[str]], *,
                     min_backlog: float = 1.0,
                     node_backlog: Optional[
                         Callable[[str, str], float]] = None
                     ) -> List[Eviction]:
    """Which lower-priority replicas should a backlogged class evict?

    For every backlogged class (priority-desc), on every node it shares
    with a STRICTLY lower-priority class that still has another routable
    replica, evict the lowest-priority such victim — its traffic
    reroutes to its surviving replicas, the hot class keeps the node.
    ``node_backlog(cls, node)`` localises the trigger (defaults to the
    spec's cluster-wide backlog).
    """
    up_names = {n.name for n in nodes if n.routable}
    evicted = set()   # (cls, node) pairs already planned away

    def homes(cls: str) -> List[str]:
        return [nn for nn in placements.get(cls, ())
                if nn in up_names and (cls, nn) not in evicted]

    evictions: List[Eviction] = []
    for s in sorted(specs, key=lambda s: -s.priority):
        for nn in placements.get(s.name, ()):
            if nn not in up_names:
                continue
            pressure = (node_backlog(s.name, nn) if node_backlog is not None
                        else s.backlog)
            if pressure < min_backlog:
                continue
            victims = [v for v in specs
                       if v.priority < s.priority
                       and nn in homes(v.name) and len(homes(v.name)) > 1]
            if not victims:
                continue
            victim = min(victims, key=lambda v: v.priority)
            evictions.append(Eviction(victim=victim.name, node=nn,
                                      for_cls=s.name))
            evicted.add((victim.name, nn))
    return evictions


# --- autoscaling ------------------------------------------------------------

def plan_scaling(nodes: Sequence[ClusterNode], *, backlog_per_chip: float,
                 energy_price: float = 0.0, t: float = 0.0,
                 min_nodes: int = 1,
                 up_threshold: float = SCALE_UP_BACKLOG,
                 down_threshold: float = SCALE_DOWN_BACKLOG,
                 price_high: float = PRICE_HIGH) -> ScalePlan:
    """One autoscaling decision over the node pool.

    Sustained backlog (the caller passes an EWMA, not an instantaneous
    read) above ``up_threshold`` spins up the first STANDBY node; a
    cluster idling below ``down_threshold`` while the energy price is at
    or above ``price_high`` spins down the smallest UP node — never
    below ``min_nodes``.
    """
    up = [n for n in nodes if n.state == UP]
    standby = [n for n in nodes if n.state == STANDBY]
    if backlog_per_chip > up_threshold and standby:
        return ScalePlan(spin_up=[standby[0].name], spin_down=[])
    if (backlog_per_chip < down_threshold and energy_price >= price_high
            and len(up) > max(1, min_nodes)):
        victim = min(up, key=lambda n: (n.g(t).total_chips, n.name))
        return ScalePlan(spin_up=[], spin_down=[victim.name])
    return ScalePlan(spin_up=[], spin_down=[])
