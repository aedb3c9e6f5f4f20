"""One serving node: a ResourceArbiter + its DynamicServers + lifecycle.

A :class:`ClusterNode` is exactly the single-device stack PRs 1-3 built
(water-filling arbiter, SLO-registered tenants, bucketed serving
engines), wrapped with what the cluster front-end needs:

* a **load signal** — the arbiter's summed queue-depth + arrival-rate
  EWMA backlog, normalised by the node's chip count, so the router can
  compare a busy small node against an idle big one;
* a **lifecycle state** — UP (routable), STANDBY (powered-off pool
  member the autoscaler can spin up), DRAINING (stop routing, keep
  serving until the queues empty), DRAINED (tenants migrated away), and
  DEAD (fail-stop: queued work resolves with error payloads);
* a **liveness signal** — :class:`StallDetector` turns the node's
  completion counters into a health verdict: completions flat while
  backlog is non-zero for K consecutive health epochs means the node is
  WEDGED (silently stuck — worker hung, device lost — without
  fail-stopping), and the health checker fails it over automatically
  instead of waiting for an operator's ``fail_at``/``drain``.

The same object backs both the live front-end (:mod:`.frontend`) and
the virtual-time simulator (:mod:`.sim`); ``g_fn(t)`` yields the node's
machine state at virtual/elapsed time ``t`` (heterogeneous clusters are
just nodes with different ``g_fn``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

from repro_torch.runtime.arbiter import (GlobalConstraints, Headroom,
                                   ResourceArbiter)
from repro_torch.runtime.engine import DynamicServer

# health-check default: epochs of flat completions (with backlog) before
# a node is declared wedged and failed over
HEALTH_EPOCHS = 3


@dataclasses.dataclass
class StallDetector:
    """Stall-based liveness: completions flat while backlog > 0.

    One :meth:`observe` per health epoch with the node's cumulative
    completion count and current backlog.  A healthy node under load
    moves its counter every epoch; a wedged one accepts work (backlog
    grows) but completes nothing.  K consecutive stalled epochs return
    True — the caller's cue to run the existing failover path
    (:meth:`repro_torch.cluster.frontend.Cluster.fail` live, the ``fail_at``
    machinery in :func:`repro_torch.cluster.sim.simulate_cluster`).
    Completions moving — or the backlog emptying — resets the streak.
    """
    epochs: int = HEALTH_EPOCHS
    _last_completed: Optional[int] = None
    _stalled: int = 0

    def observe(self, completed: int, backlog: float) -> bool:
        stalled = (self._last_completed is not None
                   and completed == self._last_completed
                   and backlog > 0)
        self._stalled = self._stalled + 1 if stalled else 0
        self._last_completed = completed
        return self._stalled >= self.epochs

    @property
    def stalled_epochs(self) -> int:
        return self._stalled

# lifecycle states
UP = "up"
STANDBY = "standby"     # powered-off pool member; the autoscaler's spare
DRAINING = "draining"   # no new routes; queues serve to empty
DRAINED = "drained"     # graceful exit complete, tenants migrated
DEAD = "dead"           # fail-stop: queued requests resolve with errors
NODE_STATES = (UP, STANDBY, DRAINING, DRAINED, DEAD)


@dataclasses.dataclass
class ClusterNode:
    """One arbiter-governed machine inside the cluster."""
    name: str
    g_fn: Callable[[float], GlobalConstraints]
    arbiter: ResourceArbiter = dataclasses.field(
        default_factory=ResourceArbiter)
    servers: Dict[str, DynamicServer] = dataclasses.field(
        default_factory=dict)
    state: str = UP
    health: StallDetector = dataclasses.field(default_factory=StallDetector)
    # chaos overlay on the hw state (repro_torch.chaos): a thermal injection
    # lowers the DVFS throttle (only low-frequency LUT points remain), a
    # straggler shrinks effective capacity.  1.0/1.0 = no perturbation;
    # g() applies them so the arbiter re-water-fills under the fault
    # without the node's g_fn knowing chaos exists.
    chaos_throttle: float = 1.0
    chaos_capacity: float = 1.0

    @property
    def routable(self) -> bool:
        """May the router send NEW traffic here?"""
        return self.state == UP

    @property
    def alive(self) -> bool:
        """Does the node still serve (routable or draining)?"""
        return self.state in (UP, DRAINING)

    def attach_obs(self, tracer=None, metrics=None):
        """Wire observability down the node's stack: the arbiter gets the
        tracer (ARBITRATE/PREEMPT decision spans labelled with this
        node's name) and every server records request span trees and
        engine counters.  The cluster front-end calls this on attach and
        again for servers placed later (:meth:`_place_on`)."""
        if tracer is not None:
            self.arbiter.tracer = tracer
            self.arbiter.trace_label = self.name
        for server in self.servers.values():
            if tracer is not None:
                server.tracer = tracer
                server.trace_node = self.name
            if metrics is not None:
                server.metrics = metrics

    def g(self, t: float = 0.0) -> GlobalConstraints:
        g = self.g_fn(t)
        if self.chaos_throttle < 1.0 or self.chaos_capacity < 1.0:
            g = dataclasses.replace(
                g,
                total_chips=max(1, int(g.total_chips * self.chaos_capacity)),
                temperature_throttle=min(g.temperature_throttle,
                                         self.chaos_throttle))
        return g

    def load(self, t: float = 0.0, extra_backlog: float = 0.0) -> float:
        """Backlog per chip — the router's comparison key.

        The numerator is the arbiter's summed per-tenant backlog (queue
        depth + arrival-rate EWMA, refreshed each arbitration) plus any
        ``extra_backlog`` the caller tracks between ticks (the simulator
        passes this-epoch arrivals); the denominator makes a half-full
        small node rank busier than a half-full big one, which is what
        lets power-of-two-choices exploit skewed capacity.
        """
        chips = max(1, self.g(t).total_chips)
        return (self.arbiter.total_backlog() + extra_backlog) / chips

    def headroom(self, t: float = 0.0) -> Headroom:
        """Unreserved capacity after tenant minimal shares (admission)."""
        return self.arbiter.headroom(self.g(t))

    def outstanding(self) -> int:
        """Unresolved futures across this node's servers (live drain)."""
        return sum(s.outstanding() for s in self.servers.values())

    def completed(self) -> int:
        """Cumulative requests answered across this node's servers — the
        liveness counter the health checker watches for stalls."""
        return sum(s.served for s in self.servers.values())

    def starved(self) -> bool:
        """Did the last arbitration deliberately park EVERY tenant?

        A fully starved node (thermal throttle, power dip, higher-priority
        tenants holding all chips) shows the same signature as a wedge —
        completions flat, futures outstanding — but it is the arbiter's
        own doing and recovers the moment conditions improve.  The health
        check must not kill it."""
        last = self.arbiter.last_allocations()
        return bool(last) and all(a.point is None for a in last.values())

    def check_health(self) -> bool:
        """One live health epoch: True when the node looks wedged
        (completions flat across K epochs while futures are outstanding).
        The front-end's health loop calls this and runs ``fail()``.

        Epochs where the arbiter parked every tenant
        (:meth:`starved`) report zero backlog to the detector, so a
        deliberate starvation resets the stall streak instead of
        counting toward a false-positive failover."""
        backlog = 0 if self.starved() else self.outstanding()
        return self.health.observe(self.completed(), backlog)
