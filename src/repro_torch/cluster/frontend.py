"""Live cluster front-end: N arbiter-governed nodes behind one router.

:class:`Cluster` composes :class:`~repro_torch.cluster.node.ClusterNode`s into
a single serving surface:

* **register** runs cluster-level admission (:func:`cluster_admission`)
  and places the class on every node that can host its minimal share —
  one DynamicServer replica per placement, built by the caller's
  ``make_server(node)`` factory;
* **submit** routes one request to a placement via the
  :class:`~repro_torch.cluster.router.ClusterRouter` (p2c by default) and
  returns the replica server's future — callers never see nodes;
* **drain** stops routing to a node, waits for its backlog to resolve,
  migrates its tenant registrations to surviving nodes (the arbiter's
  :meth:`export_tenant` hook), and stops it;
* **fail** is fail-stop: every queued request on the dead node resolves
  with an error payload (:meth:`DynamicServer.kill`) and orphaned
  classes are re-admitted elsewhere, so the class's share is
  re-arbitrated instead of lost;
* a **placement engine** (``rebalance_interval_s``) periodically re-runs
  the cluster-wide water-filling solve (:mod:`repro_torch.cluster.placement`)
  against the live placements: approved, migration-cost-priced changes
  move replicas through the arbiter's ``export_tenant`` hook, and
  cross-node preemptions evict lower-priority replicas co-located with
  a backlogged higher-priority class (``preempt`` lands the freed share
  mid-cycle);
* a **health checker** (``health_interval_s``) closes the liveness loop:
  each health epoch every UP node's cumulative completion counter is
  compared against its outstanding futures
  (:meth:`~repro_torch.cluster.node.ClusterNode.check_health`); a node whose
  completions stay flat for K epochs while work is outstanding is
  WEDGED — silently stuck, invisible to the router's load signal — and
  is failed over through the same :meth:`fail` path an operator would
  use, so no caller hangs on it.

Duck-types the ``arbiter`` argument of :func:`repro_torch.traffic.drive_live`
(``start``/``stop``/``summary``) and serves class ports that duck-type
its ``servers`` dict, so the existing live driver drives a whole
cluster unchanged.

Lock discipline (enforced by ``pytest --lock-check``, see
:mod:`repro_torch.analysis.locks`): the canonical project lock order is
``Cluster._admin_lock > Cluster._lock > ResourceArbiter._lock >
DynamicServer locks > Tracer/Metrics locks`` — an outer lock may be held
while taking any lock to its right, never the reverse.  ``_admin_lock``
serialises lifecycle work (register/drain/fail/rebalance) and nests
``_lock`` for the brief routing-state flips; ``_lock`` guards
``placements``/``_classes``/``unplaceable`` and the event logs, and is
held across router picks (which probe node arbiters — hence
arbiter locks sit BELOW it).  Arbiter/engine code never calls back into
the cluster, which is what keeps the order acyclic.  External readers
snapshot via :meth:`placements_snapshot` instead of touching
``placements`` raw.
"""
from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Callable, Deque, Dict, List, Optional, Sequence

from repro_torch.analysis.guards import guarded_by
from repro_torch.cluster import placement as pl
from repro_torch.cluster.admission import cluster_admission
from repro_torch.cluster.node import (DEAD, DRAINED, DRAINING, HEALTH_EPOCHS, UP,
                                ClusterNode)
from repro_torch.cluster.router import P2C, ClusterRouter
from repro_torch.obs import trace as obs
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.runtime.arbiter import AdmissionError
from repro_torch.runtime.engine import DynamicServer
from repro_torch.runtime.lut import LUT


class _ClassPort:
    """Submit-side view of one class: what drive_live treats as a server."""

    def __init__(self, cluster: "Cluster", name: str):
        self._cluster = cluster
        self._name = name

    def submit(self, x, links: Sequence[int] = ()) -> "queue.Queue":
        return self._cluster.submit(self._name, x, links=links)


def _dead_future(reason: str) -> "queue.Queue":
    fut: "queue.Queue" = queue.Queue(maxsize=1)
    fut.put({"y": None, "cancelled": True, "error": reason,
             "latency_ms": 0.0, "subnet": None})
    return fut


@guarded_by("_lock", "placements", "_classes", "unplaceable",
            "health_log", "migration_log", "preempt_log")
class Cluster:
    def __init__(self, nodes: Sequence[ClusterNode], *,
                 router: str = P2C, router_seed: int = 0,
                 health_interval_s: Optional[float] = None,
                 health_epochs: int = HEALTH_EPOCHS,
                 rebalance_interval_s: Optional[float] = None,
                 rebalance_hysteresis: float = pl.DEFAULT_HYSTERESIS,
                 replicas: Optional[int] = None,
                 tracer=None, metrics: Optional[MetricsRegistry] = None,
                 log_cap: int = 4096):
        if not nodes:
            raise ValueError("a cluster needs at least one node")
        names = [n.name for n in nodes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate node names: {names}")
        self.nodes: Dict[str, ClusterNode] = {n.name: n for n in nodes}
        # observability: ONE tracer spans the whole request path (route
        # at the front-end, queue→device inside each node's engine) and
        # ONE cluster registry holds router/migration/health counters
        # (node arbiters keep their own registries — tenant labels would
        # collide across nodes)
        self.tracer = tracer
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.router = ClusterRouter(router, seed=router_seed,
                                    metrics=self.metrics)
        for n in nodes:
            n.attach_obs(tracer, self.metrics)
        # stall-based health checking: None disables the checker thread
        self.health_interval_s = health_interval_s
        self.health_epochs = health_epochs
        # event logs are bounded (the engine's switch_log idiom): a long live run
        # keeps the newest log_cap entries and counts the rest
        self.log_cap = log_cap
        self.health_log: Deque[str] = collections.deque(  # guarded-by: _lock
            maxlen=log_cap)
        self.health_log_dropped = 0
        self._health_stop = threading.Event()
        self._health_thread: Optional[threading.Thread] = None
        # periodic cluster-wide rebalancing (the placement engine):
        # None disables the thread; rebalance() stays callable by hand
        self.rebalance_interval_s = rebalance_interval_s
        self.rebalance_hysteresis = rebalance_hysteresis
        self.replicas = replicas
        # (t, cls, src, dst)
        self.migration_log: Deque[tuple] = collections.deque(  # guarded-by: _lock
            maxlen=log_cap)
        self.migration_log_dropped = 0
        # (t, victim, node, for_cls)
        self.preempt_log: Deque[tuple] = collections.deque(  # guarded-by: _lock
            maxlen=log_cap)
        self.preempt_log_dropped = 0
        self._rebalance_stop = threading.Event()
        self._rebalance_thread: Optional[threading.Thread] = None
        # classes whose re-admission attempt found no feasible node —
        # reported in summary() and answered with explicit `no placement`
        # futures instead of a generic dead-future reason
        self.unplaceable: set = set()   # guarded-by: _lock
        for n in nodes:
            n.health.epochs = health_epochs
        # _lock guards the routing state (placements, router picks) and is
        # only ever held briefly; _admin_lock serialises lifecycle work
        # (register/drain/fail) whose slow parts — thread joins, server
        # construction/warmup — must NOT stall submits to healthy nodes
        self._lock = threading.RLock()
        self._admin_lock = threading.RLock()
        # class -> registration info needed to re-place it (migration)
        self._classes: Dict[str, dict] = {}          # guarded-by: _lock
        self.placements: Dict[str, List[str]] = {}   # guarded-by: _lock
        self._t0: Optional[float] = None

    # --- time / state -------------------------------------------------------

    def _now(self) -> float:
        return 0.0 if self._t0 is None else time.perf_counter() - self._t0

    def _routable(self, name: str) -> List[ClusterNode]:
        return [self.nodes[nn] for nn in self.placements.get(name, ())
                if self.nodes[nn].routable]

    # --- registration / admission -------------------------------------------

    def register(self, name: str, lut: LUT, target_latency_ms: float, *,
                 priority: int = 0, min_accuracy: Optional[float] = None,
                 make_server: Optional[
                     Callable[[ClusterNode], DynamicServer]] = None
                 ) -> List[str]:
        """Admit + place one class cluster-wide.

        Raises :class:`AdmissionError` when NO node's headroom fits the
        class's minimal share; otherwise registers a replica on every
        node that can host it and returns the placement list.
        """
        with self._admin_lock:
            with self._lock:
                if name in self._classes:
                    raise ValueError(f"class {name!r} already registered")
            info = dict(lut=lut, target_latency_ms=target_latency_ms,
                        priority=priority, min_accuracy=min_accuracy,
                        make_server=make_server)
            placed = cluster_admission(
                list(self.nodes.values()), lut, target_latency_ms,
                priority=priority, min_accuracy=min_accuracy, t=self._now())
            for nn in placed:
                self._place_on(name, info, self.nodes[nn])
            with self._lock:
                self._classes[name] = info
                self.placements[name] = list(placed)
            return list(placed)

    def _place_on(self, name: str, info: dict, node: ClusterNode):
        server = (info["make_server"](node) if info["make_server"] else None)
        node.arbiter.register(name, info["lut"], info["target_latency_ms"],
                              priority=info["priority"],
                              min_accuracy=info["min_accuracy"],
                              server=server)
        if server is not None:
            node.servers[name] = server
            node.attach_obs(self.tracer, self.metrics)

    def _readmit_orphans(self):
        """Re-place classes whose every replica died/drained away — the
        failed node's share is re-arbitrated on the survivors.  Caller
        holds _admin_lock; server construction runs outside the routing
        lock so healthy-node submits keep flowing.  A class NO survivor
        can host is recorded as unplaceable (``summary()`` reports it,
        submits resolve with an explicit `no placement` payload) instead
        of being silently retried."""
        with self._lock:
            orphans = [(name, info) for name, info in self._classes.items()
                       if not self.placements.get(name)]
        for name, info in orphans:
            try:
                placed = cluster_admission(
                    [n for n in self.nodes.values()
                     if name not in n.arbiter.tenants()],
                    info["lut"], info["target_latency_ms"],
                    priority=info["priority"],
                    min_accuracy=info["min_accuracy"], t=self._now())
            except AdmissionError:
                with self._lock:
                    self.unplaceable.add(name)
                continue
            for nn in placed:
                self._place_on(name, info, self.nodes[nn])
            with self._lock:
                self.placements[name] = list(placed)
                self.unplaceable.discard(name)

    # --- placement engine (periodic rebalancing + preemption) ---------------

    def placements_snapshot(self) -> Dict[str, List[str]]:
        """Locked copy of ``{class: [node, ...]}`` — what external readers
        (chaos controller, tooling) use instead of ``placements`` raw,
        which drain/fail/rebalance mutate concurrently."""
        with self._lock:
            return {name: list(p) for name, p in self.placements.items()}

    def _spec_of(self, name: str, info: dict) -> pl.ClassSpec:
        backlog = 0.0
        with self._lock:
            placed = list(self.placements.get(name, ()))
        for nn in placed:
            node = self.nodes[nn]
            if node.alive and name in node.arbiter.tenants():
                backlog += node.arbiter.backlog(name)
        return pl.ClassSpec(name=name, lut=info["lut"],
                            target_latency_ms=info["target_latency_ms"],
                            priority=info["priority"],
                            min_accuracy=info["min_accuracy"],
                            backlog=backlog)

    def rebalance(self) -> "pl.RebalancePlan":
        """One cluster-wide rebalance: fresh global solve over the same
        water-filling objective the node arbiters run, diffed against
        the live placements, every change priced with its real
        migration cost (hysteresis — steady load applies nothing).
        Approved moves register the replica on the destination and
        export it from the source through the arbiter's migration hook;
        cross-node preemptions evict lower-priority replicas wherever a
        backlogged higher-priority class shares its node."""
        with self._admin_lock:
            t = self._now()
            with self._lock:
                classes = dict(self._classes)
                current = {n: list(p) for n, p in self.placements.items()}
            specs = [self._spec_of(n, i) for n, i in classes.items()]
            up_nodes = [n for n in self.nodes.values() if n.routable]
            horizon = (self.rebalance_interval_s
                       if self.rebalance_interval_s else 5.0)
            plan = pl.plan_rebalance(specs, up_nodes, current, t=t,
                                     horizon_s=horizon,
                                     hysteresis=self.rebalance_hysteresis,
                                     replicas=self.replicas)
            t_plan = (time.perf_counter()
                      if self.tracer is not None else 0.0)
            for mv in plan.moves:
                info = classes[mv.cls]
                t_mv = (time.perf_counter()
                        if self.tracer is not None else 0.0)
                if mv.dst is not None:
                    self._place_on(mv.cls, info, self.nodes[mv.dst])
                    with self._lock:
                        if mv.dst not in self.placements[mv.cls]:
                            self.placements[mv.cls].append(mv.dst)
                if mv.src is not None:
                    self._retire_replica(mv.cls, mv.src)
                with self._lock:
                    if len(self.migration_log) == self.log_cap:
                        self.migration_log_dropped += 1  # deque evicts oldest
                    self.migration_log.append((t, mv.cls, mv.src, mv.dst))
                self.metrics.counter("cluster_migrations_total",
                                     cls=mv.cls).inc()
                if self.tracer is not None:
                    # the span covers the real move: destination server
                    # build/warmup through source drain + export
                    self.tracer.decision(
                        obs.MIGRATE, t_mv, time.perf_counter(),
                        cls=mv.cls, node=mv.dst, src=mv.src,
                        cost_s=mv.cost_s)
            evs = pl.plan_preemptions(specs, up_nodes, current)
            for ev in evs:
                t_ev = (time.perf_counter()
                        if self.tracer is not None else 0.0)
                self._retire_replica(ev.victim, ev.node)
                # the freed share lands NOW, not at the next clock tick
                node = self.nodes[ev.node]
                if ev.for_cls in node.arbiter.tenants():
                    node.arbiter.preempt(ev.for_cls, node.g(t))
                with self._lock:
                    if len(self.preempt_log) == self.log_cap:
                        self.preempt_log_dropped += 1   # deque evicts oldest
                    self.preempt_log.append(
                        (t, ev.victim, ev.node, ev.for_cls))
                self.metrics.counter("cluster_preemptions_total",
                                     cls=ev.victim).inc()
                if self.tracer is not None:
                    self.tracer.decision(
                        obs.PREEMPT, t_ev, time.perf_counter(),
                        cls=ev.victim, node=ev.node, for_cls=ev.for_cls)
            if self.tracer is not None:
                self.tracer.decision(
                    obs.REBALANCE, t_plan, time.perf_counter(),
                    moves=len(plan.moves), preemptions=len(evs))
            return plan

    def set_alert_pressure(self, name: str, pressure: float):
        """Forward a watchtower alert-pressure signal to every replica's
        arbiter: each node scales the class's backlog demand by
        ``1 + pressure`` in its next water-fill (0.0 clears it).  The
        live counterpart of the simulator's actuation hook — drive_live
        calls this as its watchtower evaluates."""
        with self._lock:
            placed = list(self.placements.get(name, ()))
        for nn in placed:
            node = self.nodes[nn]
            if node.alive and name in node.arbiter.tenants():
                node.arbiter.set_alert_pressure(name, pressure)

    def _retire_replica(self, name: str, node_name: str):
        """Take one replica out: stop routing to it, drain its queue,
        export the registration (server stays up until drained)."""
        node = self.nodes[node_name]
        with self._lock:
            if node_name in self.placements.get(name, ()):
                self.placements[name].remove(node_name)
        server = node.servers.pop(name, None)
        if server is not None:
            server.drain(timeout_s=5.0)
        if name in node.arbiter.tenants():
            node.arbiter.export_tenant(name)

    def _rebalance_loop(self):
        while not self._rebalance_stop.is_set():
            self._rebalance_stop.wait(self.rebalance_interval_s)
            if self._rebalance_stop.is_set():
                break
            self.rebalance()

    # --- request path -------------------------------------------------------

    def submit(self, name: str, x,
               links: Sequence[int] = ()) -> "queue.Queue":
        """Route one request.  ``links`` carries the trace_ids of prior
        attempts (a retried or hedged request's second try points at its
        first — the span-link idiom), recorded on the new span tree."""
        t_sub = time.perf_counter() if self.tracer is not None else 0.0
        with self._lock:
            cands = self._routable(name)
            node = self.router.pick(name, cands, t=self._now()) \
                if cands else None
            if node is None and name in self.unplaceable:
                # every replica died AND re-admission found no feasible
                # node: say so, not just "no routable node"
                return _dead_future(
                    f"class {name!r}: no placement — re-admission found "
                    f"no node able to host its minimal share")
        if node is None:
            return _dead_future(f"class {name!r}: no routable node")
        server = node.servers.get(name)
        if server is None:
            return _dead_future(f"class {name!r}: node {node.name} "
                                f"has no server replica")
        if self.tracer is not None:
            # begin the span tree HERE, under the SLO class, with the
            # router's pick as the route span; the engine appends the
            # queue→device children and finalizes at outputs-ready
            tid = self.tracer.begin_request(name, t=t_sub, node=node.name,
                                            links=links)
            t_route = time.perf_counter()
            self.tracer.add_span(tid, obs.ROUTE, t_sub, t_route,
                                 node=node.name)
            # the engine's queue span starts where the route span ends
            return server.submit(x, trace_id=tid, t_submit=t_route)
        return server.submit(x)

    def port(self, name: str) -> _ClassPort:
        return _ClassPort(self, name)

    def ports(self) -> Dict[str, _ClassPort]:
        """``{class: submit-proxy}`` — drive_live's ``servers`` dict."""
        with self._lock:
            names = list(self._classes)
        return {name: _ClassPort(self, name) for name in names}

    # --- lifecycle ----------------------------------------------------------

    def start(self, g_fn=None):
        """Start every node's constraint clock (``g_fn`` is accepted for
        drive_live compatibility; nodes use their own ``g_fn(t)``) and,
        when ``health_interval_s`` is set, the stall-based health
        checker."""
        self._t0 = time.perf_counter()
        for node in self.nodes.values():
            if node.alive:
                node.arbiter.start(lambda n=node: n.g(self._now()))
        if self.health_interval_s is not None:
            self._health_stop.clear()
            self._health_thread = threading.Thread(target=self._health_loop,
                                                   daemon=True)
            self._health_thread.start()
        if self.rebalance_interval_s is not None:
            self._rebalance_stop.clear()
            self._rebalance_thread = threading.Thread(
                target=self._rebalance_loop, daemon=True)
            self._rebalance_thread.start()

    def _health_loop(self):
        # Operator contract: health_epochs x health_interval_s must
        # exceed the node's worst-case single-batch time (a warmed
        # server's batch is milliseconds; an un-warmed cold compile can
        # legitimately stall completions for hundreds of ms and would —
        # correctly, from the detector's point of view — read as a wedge)
        while not self._health_stop.is_set():
            for node in list(self.nodes.values()):
                if node.state == UP and node.check_health():
                    # wedged: completions flat for K epochs with futures
                    # outstanding — run the SAME failover path an
                    # operator's fail() would (queued futures resolve
                    # with error payloads, classes re-admit elsewhere)
                    with self._lock:
                        if len(self.health_log) == self.log_cap:
                            self.health_log_dropped += 1  # deque evicts oldest
                        self.health_log.append(node.name)
                    self.metrics.counter("cluster_health_failed_total",
                                         node=node.name).inc()
                    t_fail = (time.perf_counter()
                              if self.tracer is not None else 0.0)
                    self.fail(node.name,
                              reason=f"health: node {node.name} wedged "
                                     f"(completions stalled "
                                     f"{node.health.stalled_epochs} epochs "
                                     f"with backlog)")
                    if self.tracer is not None:
                        self.tracer.decision(
                            obs.HEALTH_FAIL, t_fail, time.perf_counter(),
                            node=node.name)
            self._health_stop.wait(self.health_interval_s)

    def stop(self):
        self._health_stop.set()
        self._rebalance_stop.set()
        if self._health_thread is not None:
            self._health_thread.join(timeout=5)
            self._health_thread = None
        if self._rebalance_thread is not None:
            self._rebalance_thread.join(timeout=5)
            self._rebalance_thread = None
        for node in self.nodes.values():
            if node.alive:
                node.arbiter.stop()

    def drain(self, node_name: str, timeout_s: float = 30.0) -> bool:
        """Graceful node removal: stop routing, let the backlog resolve
        (each replica's :meth:`DynamicServer.drain`), migrate tenant
        registrations to survivors, stop the node."""
        node = self.nodes[node_name]
        with self._admin_lock:
            with self._lock:
                if node.state != UP:
                    return False
                node.state = DRAINING   # router skips it from here on
            deadline = time.perf_counter() + timeout_s
            drained = True
            for server in node.servers.values():
                # refuses racing submits, waits its backlog out, stops
                drained &= server.drain(
                    timeout_s=max(0.1, deadline - time.perf_counter()))
            for name in node.arbiter.tenants():
                # the servers are already stopped; export keeps the (now
                # empty) registration out of the arbiter's stop path
                node.arbiter.export_tenant(name)
                with self._lock:
                    if node_name in self.placements.get(name, ()):
                        self.placements[name].remove(node_name)
            node.arbiter.stop()
            with self._lock:
                node.state = DRAINED
            self._readmit_orphans()
        return drained

    def fail(self, node_name: str, reason: str = "node failed") -> None:
        """Fail-stop a node NOW: queued requests resolve with ``reason``
        error payloads; orphaned classes re-arbitrate elsewhere."""
        node = self.nodes[node_name]
        with self._admin_lock:
            with self._lock:
                if node.state == DEAD:
                    return
                node.state = DEAD       # router skips it immediately
                for name in list(self.placements):
                    if node_name in self.placements[name]:
                        self.placements[name].remove(node_name)
            # slow half (thread joins) runs outside the routing lock
            for server in node.servers.values():
                server.kill(reason)
            node.arbiter.stop()
            self._readmit_orphans()

    # --- accounting ---------------------------------------------------------

    def summary(self) -> dict:
        with self._lock:
            # snapshot routing state; node/arbiter summaries run unlocked
            # below (they take arbiter locks — below _lock in the order)
            snap = {
                "placements": {n: list(p)
                               for n, p in self.placements.items()},
                "health_failed": list(self.health_log),
                "unplaceable": sorted(self.unplaceable),
                "migrations": list(self.migration_log),
                "preempted": list(self.preempt_log),
                "log_dropped": {"health": self.health_log_dropped,
                                "migrations": self.migration_log_dropped,
                                "preempted": self.preempt_log_dropped},
            }
        return {
            "router": self.router.policy,
            "routed": self.router.routed_counts(),
            "nodes": {nn: {"state": node.state,
                           "arbiter": node.arbiter.summary()}
                      for nn, node in self.nodes.items()},
            **snap,
        }
