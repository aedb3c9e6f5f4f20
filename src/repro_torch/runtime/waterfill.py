"""Level-agnostic water-filling solver (extracted from the arbiter).

The paper's runtime layer "monitors dynamically changing performance
targets as well as hardware resources and constraints, and tries to meet
them by tuning the algorithm and hardware at the same time" — and the
hierarchical framing of Xun et al. (arXiv:2105.03608) runs that SAME
decision at every level of the resource hierarchy.  Before this module,
our reproduction made the decision twice with two different brains:
:class:`~repro_torch.runtime.arbiter.ResourceArbiter` water-filled chips+watts
inside one node, while the cluster layer made ad-hoc all-or-nothing
placement calls above it.  This module is the one brain: the
water-filling core extracted out of the arbiter into pure functions over
``(demands, capacity, priced points)`` — no threads, no servers, no LUTs
— so the node-level arbiter and the cluster-level placement engine
(:mod:`repro_torch.cluster.placement`) solve the same objective.

The objective, verbatim from the arbiter (and kept bit-identical — the
reference's waterfill parity test replays the pre-extraction
algorithm against this one on seeded multi-tenant scenarios):

1. **min-share pass** — every demand, in priority order (ties by
   registration order), gets the *smallest* candidate under which a
   feasible point exists: minimal ``units`` (chips at node level, a
   replica's chip share at cluster level), then minimal un-priced cost,
   then maximal accuracy.  A demand with no feasible candidate falls
   back to its *fastest* best-effort candidate that fits the leftovers
   (target missed, marked infeasible).
2. **surplus passes** — pour the surplus back to a fixpoint.  Backlogged
   demands come FIRST (deepest backlog wins, then priority) and trade up
   to their *fastest* feasible candidate — surplus capacity drains
   backlog before it buys anyone accuracy.  Backlog-free demands spend
   surplus on strictly more accuracy, in priority order.

Costs are PRICED: the caller attaches whatever price multiplier its
level uses (the arbiter prices a slice's modelled watts by the tenant's
measured duty cycle; the placement engine prices a replica's watts the
same way).  The solver only ever adds and subtracts the numbers it is
given, so the caller's arithmetic — and therefore its allocations — are
unchanged by the extraction.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence

# Mirrors the arbiter's historical constants (imported back by it so the
# two can never drift).
MAX_FILL_PASSES = 8
# below this much pending work a demand counts as backlog-free (EWMAs
# decay geometrically and never exactly reach zero)
BACKLOG_MIN = 0.5


@dataclasses.dataclass(frozen=True)
class PricedPoint:
    """One candidate grant for one demand, priced for the solver.

    ``units`` is the indivisible capacity the grant consumes (chips for
    a node-level slice; a replica's chip share at cluster level);
    ``cost`` is what it charges the shared budget (priced watts —
    modelled slice power times the tenant's measured duty cycle);
    ``base_cost`` is the un-priced cost (modelled watts), which the
    min-share pass uses as its tie-break so pricing never changes WHICH
    minimal point is picked, only what it charges.  ``payload`` carries
    the caller's object through the solver untouched (an
    :class:`~repro_torch.core.pareto.OpPoint`; a ``(node, point)`` pair at
    cluster level).
    """
    units: int
    cost: float
    base_cost: float
    latency_ms: float
    accuracy: float
    energy_mj: float
    payload: object = None


@dataclasses.dataclass
class Demand:
    """One consumer of the shared capacity, at either level.

    ``feasible(units_cap, cost_cap)`` enumerates candidates meeting the
    demand's own target under the caps; ``candidates(units_cap,
    cost_cap)`` enumerates everything that merely fits (the best-effort
    pool).  Both receive the cost cap in PRICED units and must apply
    their own un-pricing internally (the arbiter divides its LUT power
    filter by the tenant's duty-cycle scale) — the solver never
    converts, it only budgets.
    """
    name: str
    feasible: Callable[[int, float], Sequence[PricedPoint]]
    candidates: Callable[[int, float], Sequence[PricedPoint]]
    priority: int = 0
    backlog: float = 0.0


@dataclasses.dataclass
class Grant:
    """The solver's verdict for one demand."""
    demand: str
    point: Optional[PricedPoint]   # None => starved (nothing fits)
    feasible: bool                 # meets its target within its grant

    @property
    def units(self) -> int:
        return self.point.units if self.point is not None else 0

    @property
    def cost(self) -> float:
        return self.point.cost if self.point is not None else 0.0


def priority_order(demands: Sequence[Demand]) -> List[Demand]:
    """Stable priority order: ties broken by input (registration) order."""
    return sorted(demands, key=lambda d: -d.priority)


def fill_order(demands: Sequence[Demand]) -> List[Demand]:
    """Surplus-pass order: deepest backlog first, then priority (stable)."""
    return sorted(demands, key=lambda d: (-d.backlog, -d.priority))


def min_share_point(d: Demand, units_cap: int,
                    cost_cap: float) -> Optional[PricedPoint]:
    """Feasible candidate with the smallest (units, base_cost), max
    accuracy — the minimal share the min-share pass reserves."""
    pts = d.feasible(units_cap, cost_cap)
    if not pts:
        return None
    return min(pts, key=lambda p: (p.units, p.base_cost, -p.accuracy))


def best_effort_point(d: Demand, units_cap: int,
                      cost_cap: float) -> Optional[PricedPoint]:
    """Fastest candidate that fits the leftovers (target missed)."""
    pts = d.candidates(units_cap, cost_cap)
    if not pts:
        return None
    return min(pts, key=lambda p: p.latency_ms)


def waterfill(demands: Sequence[Demand], units: int,
              cost: float = math.inf, *,
              backlog_min: float = BACKLOG_MIN,
              max_passes: int = MAX_FILL_PASSES) -> Dict[str, Grant]:
    """Divide ``(units, cost)`` among the demands — the one objective.

    Pure: repeated calls with equal inputs return equal grants, and the
    arithmetic (subtraction order, comparison keys, epsilons) replicates
    the pre-extraction arbiter exactly.
    """
    order = priority_order(demands)
    units_left = units
    cost_left = cost
    grants: Dict[str, Grant] = {}

    # pass 1: minimal feasible share, highest priority first.  cost_left
    # is tracked in PRICED units throughout.
    for d in order:
        point = min_share_point(d, units_left, cost_left)
        feasible = point is not None
        if point is None:
            point = best_effort_point(d, units_left, cost_left)
        units_left -= point.units if point else 0
        cost_left -= point.cost if point else 0.0
        grants[d.name] = Grant(demand=d.name, point=point, feasible=feasible)

    # pass 2+: water-fill the surplus to a fixpoint.  Backlogged demands
    # come FIRST (deepest backlog wins, then priority) and trade up to
    # their fastest feasible candidate; backlog-free demands spend
    # surplus on strictly more accuracy, in priority order.
    filling = fill_order(order)
    for _ in range(max_passes):
        changed = False
        for d in filling:
            cur = grants[d.name]
            cap_units = cur.units + units_left
            cap_cost = cur.cost + cost_left
            pts = d.feasible(cap_units, cap_cost)
            if not pts:
                continue
            if d.backlog >= backlog_min:
                # drain the queue: fastest feasible point, accuracy as
                # the tie-break
                best = min(pts, key=lambda p: (p.latency_ms, -p.accuracy))
                upgraded = (not cur.feasible
                            or cur.point is None
                            or best.latency_ms
                            < cur.point.latency_ms - 1e-12)
            else:
                best = max(pts, key=lambda p: (p.accuracy, -p.energy_mj))
                upgraded = (not cur.feasible
                            or cur.point is None
                            or best.accuracy > cur.point.accuracy + 1e-12)
            if not upgraded:
                continue
            units_left = cap_units - best.units
            cost_left = cap_cost - best.cost
            grants[d.name] = Grant(demand=d.name, point=best, feasible=True)
            changed = True
        if not changed:
            break
    return grants
