"""Deterministic virtual-time cluster simulation.

Mirrors :func:`repro_torch.traffic.driver.simulate` — the same constraint-clock
epochs, SLO policies, batching-aware service model and per-class
accounting — but over N :class:`ClusterNode`s with a
:class:`ClusterRouter` in front:

* each arrival is routed (p2c / least-loaded / round-robin) among the
  routable nodes of its class's placement set, using the per-node
  backlog-per-chip signal the arbiters already track;
* every node runs its OWN real :class:`ResourceArbiter` — per-node
  admission, water-filling, preemption and set_active are all exercised,
  exactly as in the single-node simulator;
* node lifecycle is scriptable: ``drain_at`` stops routing to a node and
  migrates its tenants once its queues empty; ``fail_at`` is fail-stop —
  queued requests resolve as ``failed`` and orphaned classes re-admit on
  the survivors (share re-arbitrated elsewhere); ``wedge_at`` is the
  SILENT failure mode fail-stop can't model — the node keeps accepting
  routed work but completes nothing (hung worker, lost device);
* **stall-based health checking** (``health_epochs=K``): each epoch
  every up node's completion counter is run through its
  :class:`~repro_torch.cluster.node.StallDetector`; completions flat while its
  queues are non-empty for K epochs auto-fails the node through the SAME
  failover path as ``fail_at`` — queued requests resolve as ``failed``,
  orphaned classes re-admit on survivors — replacing operator-only
  lifecycle scripting with measurement-driven liveness;
* the **placement engine** is scriptable the same way: ``rebalance_at``
  runs the cluster-wide rebalancer (fresh global water-filling solve,
  every change priced with its real migration cost, cross-node
  preemption), ``scale_at`` runs the autoscaler over a STANDBY node
  pool (``energy_price_fn`` prices spin-downs), and
  ``placement_mode="first_fit"`` scripts the static baseline the
  placement engine is measured against;
* a warmed :class:`repro_torch.runtime.telemetry.CalibrationStore`
  (``calibration=``) makes the replay predict with MEASURED numbers:
  every node's arbiter water-fills on calibrated latencies/watts and
  batches are priced by measured per-bucket EWMAs (see
  :func:`repro_torch.traffic.driver.simulate`).

Everything is seeded (arrival streams + router rng), so one trace under
two routing policies — or the same trace twice — is an exact,
reproducible comparison: the determinism tests assert identical routing
``decisions`` and :class:`ClusterReport` summaries across runs.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import math
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from repro_torch.chaos.engine import (DRAIN as CHAOS_DRAIN, FAIL as CHAOS_FAIL,
                                WEDGE_ON as CHAOS_WEDGE, ChaosTimeline)
from repro_torch.chaos.reliability import Reliability
from repro_torch.chaos.scenario import Scenario
from repro_torch.cluster import placement as pl
from repro_torch.cluster.node import (DEAD, DRAINED, DRAINING, STANDBY, UP,
                                ClusterNode, StallDetector)
from repro_torch.cluster.router import P2C, ClusterRouter
from repro_torch.obs import trace as obs
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.runtime.lut import LUT
from repro_torch.traffic import arrivals as arr
from repro_torch.traffic.driver import (BUCKETED_SERVICE, POLICIES, SERVICE_MODELS,
                                  SLO_POLICY, FIFO_POLICY, ClassStats,
                                  _service_ms)
from repro_torch.traffic.slo import DEGRADE, SHED, SLOClass


# initial placement modes
REPLICATE = "replicate"   # a replica on every node that admits the class
FIRST_FIT = "first_fit"   # one replica, on the first node that admits it
PLACEMENT_MODES = (REPLICATE, FIRST_FIT)

# smoothing for the autoscaler's sustained-backlog signal
_SCALE_BETA = 0.5


@dataclasses.dataclass(frozen=True)
class _Req:
    """One queued attempt.  ``t`` is when THIS attempt entered the system
    (its queue-position / batching key); ``t0`` is the original arrival —
    latency and the retry deadline are always measured from ``t0``, so a
    retried request can never be counted good past its real SLO.
    ``gid`` groups hedge copies (-1 = unhedged); ``first_rid`` carries the
    first failed attempt's trace_id so a retry's span tree links back."""
    t: float
    t0: float
    attempts: int = 1
    gid: int = -1
    first_rid: int = -1


@dataclasses.dataclass
class ClusterReport:
    """One cluster run: per-class stats + per-node view + routing log."""
    policy: str
    router: str
    classes: Dict[str, ClassStats]
    nodes: Dict[str, dict]
    decisions: List[Tuple[float, str, str]]
    routed: dict = dataclasses.field(default_factory=dict)
    # (virtual second, node) pairs auto-failed by the stall health check
    health_failed: List[Tuple[float, str]] = dataclasses.field(
        default_factory=list)
    # placement-engine activity (rebalance_at / scale_at scripting)
    migrations: List[Tuple[float, str, Optional[str], Optional[str]]] = \
        dataclasses.field(default_factory=list)   # (t, cls, src, dst)
    preempted: List[Tuple[float, str, str, str]] = \
        dataclasses.field(default_factory=list)   # (t, victim, node, for)
    scale_events: List[Tuple[float, str, str]] = \
        dataclasses.field(default_factory=list)   # (t, "up"/"down", node)
    # classes whose re-admission attempt found NO feasible node (they had
    # been admitted, then lost every replica): no silent retry
    unplaceable: List[str] = dataclasses.field(default_factory=list)
    decisions_dropped: int = 0
    # events evicted from the capped logs above (switch_log idiom)
    log_dropped: Dict[str, int] = dataclasses.field(default_factory=dict)
    # modelled serving energy per class (sum of dispatched batches'
    # OpPoint.energy_mj) + warmup energy paid for migrations/spin-ups —
    # a "no higher energy" comparison prices migrations honestly
    energy_mj: Dict[str, float] = dataclasses.field(default_factory=dict)
    migration_energy_mj: float = 0.0
    # chaos scenario activity: (t, kind, node) per applied injection,
    # in scenario order — part of the determinism contract
    injections: List[Tuple[float, str, str]] = dataclasses.field(
        default_factory=list)
    # brownout transitions: (t, cls, "enter"/"exit")
    brownouts: List[Tuple[float, str, str]] = dataclasses.field(
        default_factory=list)
    # SLO watchtower alerts fired during the run (rising edges), in
    # firing order — typed repro_torch.obs.health.Alert records
    alerts: List = dataclasses.field(default_factory=list)
    # reliability accounting: retries granted by the cluster budget, and
    # the ones turned away (past-deadline / budget-exhausted / attempt cap)
    retry_granted: int = 0
    retry_denied: Dict[str, int] = dataclasses.field(default_factory=dict)
    # the run's observability handles (``decompose_latency(report)``
    # reads .tracer); excluded from summary() — not plain data
    tracer: Optional[object] = None
    metrics: Optional[MetricsRegistry] = None

    @property
    def total_goodput(self) -> int:
        return sum(s.good for s in self.classes.values())

    @property
    def total_energy_mj(self) -> float:
        return sum(self.energy_mj.values()) + self.migration_energy_mj

    @property
    def total_dropped(self) -> int:
        return sum(s.dropped for s in self.classes.values())

    @property
    def total_failed(self) -> int:
        return sum(s.failed for s in self.classes.values())

    def summary(self) -> dict:
        return {"policy": self.policy, "router": self.router,
                "total_goodput": self.total_goodput,
                "total_dropped": self.total_dropped,
                "total_failed": self.total_failed,
                "classes": {n: s.summary()
                            for n, s in self.classes.items()},
                "routed": self.routed,
                "health_failed": list(self.health_failed),
                "migrations": list(self.migrations),
                "preempted": list(self.preempted),
                "scale_events": list(self.scale_events),
                "unplaceable": list(self.unplaceable),
                "injections": list(self.injections),
                "brownouts": list(self.brownouts),
                "alerts": [[round(a.t, 6), a.cls, a.window, a.severity]
                           for a in self.alerts],
                "retry_granted": self.retry_granted,
                "retry_denied": dict(self.retry_denied),
                "log_dropped": dict(self.log_dropped),
                "energy_mj": {n: round(e, 2)
                              for n, e in self.energy_mj.items()},
                "migration_energy_mj": round(self.migration_energy_mj, 2),
                "nodes": self.nodes}


def simulate_cluster(classes: Sequence[SLOClass], luts: Dict[str, LUT],
                     streams: Dict[str, Sequence[float]],
                     nodes: Sequence[ClusterNode], *,
                     router: str = P2C, router_seed: int = 0,
                     interval_s: float = 0.1, policy: str = SLO_POLICY,
                     service_model: str = BUCKETED_SERVICE,
                     max_drain_s: float = 120.0,
                     fail_at: Optional[Dict[str, float]] = None,
                     drain_at: Optional[Dict[str, float]] = None,
                     wedge_at: Optional[Dict[str, float]] = None,
                     chaos: Optional[Scenario] = None,
                     reliability: Optional[Reliability] = None,
                     watchtower=None,
                     health_epochs: Optional[int] = None,
                     calibration=None,
                     placement_mode: str = REPLICATE,
                     rebalance_at: Sequence[float] = (),
                     scale_at: Sequence[float] = (),
                     rebalance_horizon_s: Optional[float] = None,
                     hysteresis: float = pl.DEFAULT_HYSTERESIS,
                     replicas: Optional[int] = None,
                     energy_price_fn=None,
                     min_nodes: int = 1,
                     tracer=None,
                     metrics: Optional[MetricsRegistry] = None,
                     log_cap: int = 4096
                     ) -> ClusterReport:
    """Run one seeded trace through the cluster in virtual time.

    ``nodes`` must be freshly-built (their arbiters get the class
    registrations).  ``fail_at``/``drain_at`` map node names to the
    virtual second their lifecycle event lands (processed on the next
    epoch boundary; a failing node stops COMPLETING batches at the exact
    fail instant — work that would finish after it is left queued and
    resolves as ``failed``).

    ``wedge_at`` silently wedges a node: it stays routable and keeps
    accepting work, but completes nothing from that instant on — the
    failure mode only measurement can see.  With ``health_epochs=K`` the
    stall-based health check watches every node's completion counters
    and auto-fails a wedged node after K flat epochs with backlog,
    driving the same failover path as ``fail_at`` (queued requests
    resolve ``failed``, orphaned classes re-admit on survivors).

    ``calibration`` threads a warmed measurement store through every
    node's arbiter and the batch service model.

    ``chaos`` (a :class:`repro_torch.chaos.Scenario`) schedules deterministic
    fault injections in virtual time.  Its fail-stop family (node fail,
    silent wedge, spot preemption = drain notice then fail, correlated
    rack failure) is MERGED into the ``fail_at``/``drain_at``/
    ``wedge_at`` scripting above, so chaos rides the exact failover
    machinery operators script by hand; its continuous overlays are
    polled each epoch — a straggler multiplies the node's batch service
    time by ``factor``, a thermal injection walks the node's DVFS
    throttle down a ladder (the arbiter re-water-fills over the
    low-frequency LUT points), and a partition hides the router→node
    edge (the node keeps serving its queue; new routes avoid it).

    ``reliability`` (a :class:`repro_torch.chaos.Reliability`) turns on the
    request-reliability layer: a FAILED attempt is re-routed through the
    router after its class's exponential backoff — capped by the
    policy's attempt limit, by the cluster-wide retry budget
    (``burst + fraction × completed``), and by the request's own
    deadline (a retry that cannot be resubmitted before the SLO deadline
    is never scheduled).  Classes with ``hedge=True`` enqueue each
    accepted arrival on TWO distinct replicas; the first completion
    wins, the loser counts ``hedge_wasted``.  Sustained chaos pressure
    (failures+retries per outcome, EWMA-smoothed) flips a class into
    BROWNOUT: every replica's arbiter pins it to its DEGRADE target and
    shedding is suspended — serve degraded instead of dropping — until
    the pressure decays below the exit threshold.  Retried requests'
    span trees link to their first failed attempt (``links=``).

    ``watchtower`` (a :class:`repro_torch.obs.Watchtower`) closes the
    monitor→diagnose→actuate loop: each epoch's per-class outcomes
    (late completions, drops, failures) feed its burn-rate monitors,
    fired alerts land on ``report.alerts`` with attribution, and —
    when it ``actuate``\\ s — an active fast-burn alert (a) scales the
    class's backlog in every hosting arbiter via ``set_alert_pressure``
    and (b) browns the class out BEFORE the failure-pressure EWMA
    would (the EWMA only sees failures/retries; the alert also sees
    late completions, so a pure latency fault like a thermal throttle
    actuates epochs earlier).  ``rebalance_on_alert`` additionally
    runs the cluster rebalancer on each rising-edge alert.

    The **placement engine** is scripted the same way lifecycle
    is: ``rebalance_at`` lists the virtual seconds the cluster-wide
    rebalancer runs — a fresh :func:`repro_torch.cluster.placement
    .solve_placement` diffed against the live placements, every change
    priced with its real migration cost and applied only when its
    amortised benefit over ``rebalance_horizon_s`` beats
    ``hysteresis`` x cost (steady load ⇒ empty diff ⇒ zero migrations).
    A migrated/added replica WARMS first: its router weight is 0 and it
    cannot serve until ``t + cost_s``.  Cross-node preemptions run at
    the same instants.  ``scale_at`` lists when the autoscaler looks at
    its sustained-backlog EWMA: spin-up wakes a STANDBY node (replicas
    admitted + warmed onto it), spin-down parks an idle UP node back to
    STANDBY when ``energy_price_fn(t)`` is high — never below
    ``min_nodes``.  ``placement_mode="first_fit"`` scripts the static
    baseline the placement benchmark beats: one replica per class on
    the first admitting node.

    ``tracer`` (a :class:`repro_torch.obs.Tracer`) records the SAME span
    schema the live stack emits, in VIRTUAL time: per-request trees
    (route → queue [→ warming] → collect → stack → dispatch → device →
    complete; host-side stages are zero-width points — the analytic
    service model folds them into the batch) plus per-epoch ARBITRATE
    and scripted REBALANCE / MIGRATE / PREEMPT / SCALE / HEALTH_FAIL
    decision spans.  ``metrics`` feeds the report's energy/completions
    accounting through a :class:`repro_torch.obs.MetricsRegistry` (one is
    created per run when None); the report keeps its public shape, read
    back from the registry, and carries both handles.
    """
    assert policy in POLICIES, policy
    assert service_model in SERVICE_MODELS, service_model
    assert placement_mode in PLACEMENT_MODES, placement_mode
    by_class = {c.name: c for c in classes}
    stats = {c.name: ClassStats() for c in classes}
    nodes = list(nodes)
    by_node = {n.name: n for n in nodes}
    rtr = ClusterRouter(router, seed=router_seed)
    fail_at = dict(fail_at or {})
    drain_at = dict(drain_at or {})
    wedge_at = dict(wedge_at or {})
    wedged = {n.name: False for n in nodes}

    # --- chaos: compile the scenario onto the scripting machinery -----------
    timeline = (ChaosTimeline(chaos, [n.name for n in nodes])
                if chaos is not None else None)
    chaos_due: List[Tuple[float, str, str]] = []
    if timeline is not None:
        # the fail-stop family becomes fail_at/drain_at/wedge_at entries
        # (earliest wins when an operator scripted the same node), so
        # injected faults take the exact failover path scripted ones do
        lifecycle_of = {CHAOS_FAIL: fail_at, CHAOS_DRAIN: drain_at,
                        CHAOS_WEDGE: wedge_at}
        for tc, action, nn in timeline.lifecycle():
            target = lifecycle_of[action]
            target[nn] = min(target.get(nn, math.inf), tc)
        chaos_due = sorted(chaos.summary())

    # --- reliability layer state --------------------------------------------
    rel = reliability
    budget = rel.budget.fresh() if rel is not None else None
    retry_heap: List[Tuple[float, int, str, _Req]] = []
    retry_seq = 0
    retry_denied = {"deadline": 0, "budget": 0, "attempts": 0}
    hedge_groups: Dict[int, dict] = {}
    next_gid = 0
    brown_on = {c.name: False for c in classes}
    brown_p = {c.name: 0.0 for c in classes}
    # alert-driven degrade (watchtower): relaxes the arbiter target like
    # brown_on but does NOT suspend the shed check — tracked separately
    # so the two brownout paths can overlap without fighting
    wt_brown = {c.name: False for c in classes}
    brownouts: List[Tuple[float, str, str]] = []
    injections: List[Tuple[float, str, str]] = []
    # per-run accounting lives in a metrics registry (the report reads
    # it back into its public dict shapes); counter handles are held in
    # dicts so the hot loop pays one attribute bump, no lookups
    m = metrics if metrics is not None else MetricsRegistry()
    completions = {n.name: m.counter("sim_completions_total", node=n.name)
                   for n in nodes}   # liveness counters
    # per-class latency histogram: buckets carry exemplar trace ids so
    # a fired alert links straight to retained p99 traces
    lat_hist = {c.name: m.histogram("cluster_request_ms", cls=c.name)
                for c in classes}
    # --- SLO watchtower -----------------------------------------------------
    wt = watchtower
    run_alerts: List = []
    if wt is not None:
        if wt.tracer is None:
            wt.tracer = tracer
        if wt.registry is None:
            wt.registry = m
        if chaos is not None:
            # note every scheduled injection up front (attribution only
            # considers ones whose time has passed) — durations matter
            # for deciding whether a transient fault is still a suspect
            for inj in chaos.injections:
                for nn2 in (inj.targets() if hasattr(inj, "targets")
                            else ((inj.node,) if inj.node else ())):
                    wt.note_injection(inj.t, inj.kind, nn2,
                                      duration_s=inj.duration_s)
    health = {n.name: StallDetector(epochs=health_epochs or 0)
              for n in nodes} if health_epochs else {}
    # event logs are bounded like the front-end's (switch_log idiom:
    # capped deque + dropped counter); report shapes stay plain lists
    health_failed: Deque[Tuple[float, str]] = collections.deque(
        maxlen=log_cap)
    log_dropped = {"health": 0, "migrations": 0, "preempted": 0,
                   "scale_events": 0}

    def log_event(log: Deque, key: str, item) -> None:
        if len(log) == log.maxlen:
            log_dropped[key] += 1   # deque evicts the oldest
        log.append(item)
    if calibration is not None:
        for node in nodes:
            if node.arbiter.calibration is None:
                node.arbiter.calibration = calibration

    # --- cluster admission + placement (mirrors _register_classes) ---------
    placements: Dict[str, List[str]] = {}
    # how each class registers on a node — the rebalancer/autoscaler
    # re-place classes mid-trace with the SAME registration
    reg_info: Dict[str, dict] = {}
    for c in classes:
        placed: List[str] = []
        reg_info[c.name] = dict(target=c.service_target_ms,
                                priority=c.priority,
                                min_accuracy=c.min_accuracy)
        for node in nodes:
            if not node.routable:
                continue   # STANDBY pool members join via scale_at only
            if policy == FIFO_POLICY:
                node.arbiter.register(c.name, luts[c.name],
                                      c.service_target_ms, priority=0)
                placed.append(node.name)
                continue
            if placed and placement_mode == FIRST_FIT:
                break
            ok = node.arbiter.admission_check(
                luts[c.name], c.service_target_ms, node.g(0.0),
                priority=c.priority, min_accuracy=c.min_accuracy)
            if ok is not None:
                node.arbiter.register(c.name, luts[c.name],
                                      c.service_target_ms,
                                      priority=c.priority,
                                      min_accuracy=c.min_accuracy)
                placed.append(node.name)
        if not placed and policy == SLO_POLICY and c.drop_policy == DEGRADE:
            # never drop: serve best-effort everywhere at the relaxed target
            reg_info[c.name] = dict(target=c.degraded_target_ms,
                                    priority=c.priority, min_accuracy=None)
            for node in nodes:
                if not node.routable:
                    continue
                node.arbiter.register(c.name, luts[c.name],
                                      c.degraded_target_ms,
                                      priority=c.priority)
                placed.append(node.name)
        placements[c.name] = placed
    # distinguishes "admission never placed it" (rejected) from "its
    # placements died mid-trace and nobody re-admitted it" (dropped)
    admitted0 = {cn: bool(p) for cn, p in placements.items()}
    # orphaned classes whose re-admission attempt found no feasible node
    # (reported, not silently retried)
    unplaceable: set = set()

    def readmit_orphans():
        """A class whose every placement died/drained re-arbitrates its
        share on whichever survivors can host its minimal share; one
        that fits NOWHERE is reported as unplaceable."""
        if policy != SLO_POLICY:
            return
        for c in classes:
            if placements[c.name]:
                unplaceable.discard(c.name)
                continue
            for node in nodes:
                if not node.routable or c.name in node.arbiter.tenants():
                    continue
                ok = node.arbiter.admission_check(
                    luts[c.name], c.service_target_ms, node.g(t),
                    priority=c.priority, min_accuracy=c.min_accuracy)
                if ok is not None:
                    node.arbiter.register(c.name, luts[c.name],
                                          c.service_target_ms,
                                          priority=c.priority,
                                          min_accuracy=c.min_accuracy)
                    placements[c.name].append(node.name)
            if placements[c.name]:
                unplaceable.discard(c.name)
            elif admitted0[c.name]:
                unplaceable.add(c.name)

    events = arr.merge({n: ts for n, ts in streams.items()})
    queues = {n.name: {c.name: collections.deque()  # repro: allow-unbounded(per-class work queue, drained every epoch; depth IS the backlog signal)
                       for c in classes}
              for n in nodes}
    busy_until = {n.name: {c.name: 0.0 for c in classes} for n in nodes}
    arrived_epoch = {n.name: {c.name: 0 for c in classes} for n in nodes}
    last_arrival = events[-1][0] if events else 0.0

    def svc_of(allocs):
        # granted OpPoints: the calibrated service model keys measured
        # bucket columns by the point's subnet spec
        return {n: a.point for n, a in allocs.items()}

    def resolve_failure(cn: str, it: _Req, tf: float, nn: Optional[str]):
        """One attempt just died at ``tf`` (fail-stop, lost route).

        Outcomes, in order: absorbed by a live hedge sibling (nothing is
        terminal while a copy is still in flight; a copy outlived by its
        winner counts ``hedge_wasted``); RETRIED — re-enqueued through
        the router after the class's backoff, if the attempt cap, the
        request's own deadline, and the cluster retry budget all allow;
        otherwise terminally ``failed``."""
        nonlocal retry_seq
        st = stats[cn]
        if it.gid >= 0:
            grp = hedge_groups[it.gid]
            grp["live"] -= 1
            if grp["done"]:
                st.hedge_wasted += 1
                return
            if grp["live"] > 0:
                return   # sibling still in flight: not terminal yet
            # last copy of an unresolved group: fall through (retryable)
        first_rid = it.first_rid
        if rel is not None:
            pol = rel.policy_for(cn)
            c = by_class[cn]
            if pol is None or it.attempts >= pol.max_attempts:
                retry_denied["attempts"] += 1
            else:
                t_retry = tf + pol.backoff(it.attempts)
                if t_retry > it.t0 + c.deadline_ms / 1e3:
                    # deadline-aware: a retry that cannot even resubmit
                    # before the SLO deadline is guaranteed-late work
                    retry_denied["deadline"] += 1
                elif not budget.allow(sum(s.completed
                                          for s in stats.values())):
                    retry_denied["budget"] += 1
                else:
                    if tracer is not None and first_rid < 0:
                        # record the failed attempt as its own span tree
                        # so the retry's span link points at something
                        first_rid = tracer.request(
                            cn, it.t, tf, node=nn, spans=[
                                (obs.ROUTE, it.t, it.t, None),
                                (obs.QUEUE, it.t, tf, None)])
                    st.retried += 1
                    retry_seq += 1
                    heapq.heappush(
                        retry_heap,
                        (t_retry, retry_seq, cn,
                         dataclasses.replace(it, t=t_retry,
                                             attempts=it.attempts + 1,
                                             gid=-1, first_rid=first_rid)))
                    return
        st.failed += 1   # error payloads, not lost

    def fail_node(nn: str, tf: float):
        """Fail-stop one node: queued work resolves as failed (or enters
        the retry path when a reliability layer runs), placements shrink,
        orphans re-admit — shared by ``fail_at`` scripting, chaos
        injections and the stall health check."""
        by_node[nn].state = DEAD
        for cn, q in queues[nn].items():
            for it in q:
                resolve_failure(cn, it, tf, nn)
            q.clear()
            busy_until[nn][cn] = 0.0
        for cn in placements:
            if nn in placements[cn]:
                placements[cn].remove(nn)
        readmit_orphans()

    # --- placement engine (rebalance_at / scale_at scripting) ---------------
    rebalance_due = sorted(rebalance_at)
    scale_due = sorted(scale_at)
    horizon_s = (rebalance_horizon_s if rebalance_horizon_s is not None
                 else (rebalance_due[1] - rebalance_due[0]
                       if len(rebalance_due) > 1 else 5.0))
    migrations: Deque[Tuple[float, str, Optional[str], Optional[str]]] = \
        collections.deque(maxlen=log_cap)
    preempted: Deque[Tuple[float, str, str, str]] = \
        collections.deque(maxlen=log_cap)
    scale_events: Deque[Tuple[float, str, str]] = \
        collections.deque(maxlen=log_cap)
    warming: List[Tuple[float, str, str]] = []   # (warm_t, cls, node)
    # make-before-break: (warm_t, cls, src, dst) retires deferred until
    # the destination replica's warmup lands
    pending_retires: List[Tuple[float, str, str, str]] = []
    # (node, cls) -> latest warmup end: attributes a routed request's
    # wait behind a migrating replica to a WARMING span, not queueing
    warm_until: Dict[Tuple[str, str], float] = {}
    scale_ewma = 0.0   # sustained cluster backlog per chip
    energy = {c.name: m.counter("sim_energy_mj_total", cls=c.name)
              for c in classes}
    mig_energy = m.counter("sim_migration_energy_mj_total")

    def spec_of(c) -> pl.ClassSpec:
        return pl.ClassSpec(
            name=c.name, lut=luts[c.name],
            target_latency_ms=reg_info[c.name]["target"],
            priority=reg_info[c.name]["priority"],
            min_accuracy=reg_info[c.name]["min_accuracy"],
            backlog=float(sum(len(queues[n.name][c.name])
                              for n in nodes if n.alive)),
            max_batch=c.max_batch,
            fallback_target_ms=(c.degraded_target_ms
                                if c.drop_policy == DEGRADE else None))

    def start_replica(cn: str, nn: str, t0: float, warm_s: float):
        """Register + WARM a replica: weight 0 and no serving until the
        weights have transferred and its buckets are compiled."""
        node = by_node[nn]
        if cn not in node.arbiter.tenants():
            node.arbiter.register(cn, luts[cn], reg_info[cn]["target"],
                                  priority=reg_info[cn]["priority"],
                                  min_accuracy=reg_info[cn]["min_accuracy"])
            if brown_on.get(cn) or wt_brown.get(cn):
                # class is browned out: the new replica serves the same
                # degraded target its siblings were pinned to
                node.arbiter.set_brownout(cn,
                                          by_class[cn].degraded_target_ms)
        if nn not in placements[cn]:
            placements[cn].append(nn)
        warm_t = t0 + warm_s
        busy_until[nn][cn] = max(busy_until[nn][cn], warm_t)
        warm_until[(nn, cn)] = max(warm_until.get((nn, cn), 0.0), warm_t)
        rtr.set_weight(cn, nn, 0.0)
        warming.append((warm_t, cn, nn))
        unplaceable.discard(cn)

    def retire_replica(cn: str, nn: str, dst: Optional[str]):
        """Export one replica's registration and re-route its queue to
        ``dst`` (or the first surviving placement), arrival order kept."""
        node = by_node[nn]
        if cn in node.arbiter.tenants():
            node.arbiter.export_tenant(cn)
        if nn in placements[cn]:
            placements[cn].remove(nn)
        q = queues[nn][cn]
        if q:
            home = dst or (placements[cn][0] if placements[cn] else None)
            if home is None:
                if rel is not None:
                    # homeless work enters the retry path (ambient epoch
                    # time — retire only ever runs inside the main loop)
                    for it in q:
                        resolve_failure(cn, it, t, nn)
                else:
                    stats[cn].dropped += len(q)
            else:
                moved = []
                for it in q:
                    if tracer is not None and it.first_rid < 0:
                        # preemption span link (ROADMAP follow-up a):
                        # record the preempted attempt's truncated tree
                        # (routed at it.t, queued on nn until the cut)
                        # so the second service attempt links back to it
                        frid = tracer.request(
                            cn, it.t, t, node=nn, spans=[
                                (obs.ROUTE, it.t, it.t, None),
                                (obs.QUEUE, it.t, t, None)])
                        it = dataclasses.replace(it, first_rid=frid)
                    moved.append(it)
                queues[home][cn] = collections.deque(  # repro: allow-unbounded(rebuilds an existing drained work queue; size bounded by its contents)
                    sorted(list(queues[home][cn]) + moved,
                           key=lambda r: (r.t, r.t0)))
            q.clear()
        busy_until[nn][cn] = 0.0
        warm_until.pop((nn, cn), None)

    def run_rebalance(tr: float):
        """One cluster-wide rebalance: fresh solve, priced diff, apply."""
        specs = [spec_of(c) for c in classes]
        up_nodes = [n for n in nodes if n.routable]
        plan = pl.plan_rebalance(specs, up_nodes, placements, t=tr,
                                 horizon_s=horizon_s,
                                 hysteresis=hysteresis, replicas=replicas,
                                 calibration=calibration)
        for mv in plan.moves:
            if mv.dst is not None:
                start_replica(mv.cls, mv.dst, tr, mv.cost_s)
                mig_energy.inc(mv.cost_j * 1e3)
            if mv.src is not None:
                if mv.dst is not None:
                    # make-before-break: the source keeps serving (and
                    # stays routable) until the destination's priced
                    # warmup lands — retiring it now would strand its
                    # queue behind a replica that cannot serve yet
                    pending_retires.append((tr + mv.cost_s, mv.cls,
                                            mv.src, mv.dst))
                else:
                    retire_replica(mv.cls, mv.src, None)
            log_event(migrations, "migrations", (tr, mv.cls, mv.src, mv.dst))
            m.counter("cluster_migrations_total", cls=mv.cls).inc()
            if tracer is not None:
                # the span covers the priced warmup: dst serves at
                # tr + cost_s, exactly when the router weight clears
                tracer.decision(obs.MIGRATE, tr, tr + mv.cost_s,
                                cls=mv.cls, node=mv.dst, src=mv.src,
                                cost_s=mv.cost_s)
        # cross-node preemption: a backlogged high-priority class evicts
        # the lowest-priority co-located replica that has another home
        evs = pl.plan_preemptions(
            specs, up_nodes, placements,
            node_backlog=lambda c, n2: float(len(queues[n2][c])))
        for ev in evs:
            retire_replica(ev.victim, ev.node, None)
            log_event(preempted, "preempted",
                      (tr, ev.victim, ev.node, ev.for_cls))
            m.counter("cluster_preemptions_total", cls=ev.victim).inc()
            if tracer is not None:
                tracer.decision(obs.PREEMPT, tr, tr, cls=ev.victim,
                                node=ev.node, for_cls=ev.for_cls)
        if tracer is not None:
            tracer.decision(obs.REBALANCE, tr, tr, moves=len(plan.moves),
                            preemptions=len(evs))

    def run_scaling(ts: float):
        """One autoscaler step over the node pool."""
        price = energy_price_fn(ts) if energy_price_fn is not None else 0.0
        plan = pl.plan_scaling(nodes, backlog_per_chip=scale_ewma,
                               energy_price=price, t=ts,
                               min_nodes=min_nodes)
        for nn in plan.spin_up:
            node = by_node[nn]
            node.state = UP
            log_event(scale_events, "scale_events", (ts, "up", nn))
            if tracer is not None:
                tracer.decision(obs.SCALE, ts, ts, node=nn,
                                direction="up")
            for c in classes:
                ok = node.arbiter.admission_check(
                    luts[c.name], reg_info[c.name]["target"], node.g(ts),
                    priority=reg_info[c.name]["priority"],
                    min_accuracy=reg_info[c.name]["min_accuracy"])
                if ok is not None:
                    cost = pl.migration_cost(spec_of(c),
                                             calibration=calibration)
                    start_replica(c.name, nn, ts, cost.seconds)
                    mig_energy.inc(cost.joules * 1e3)
        for nn in plan.spin_down:
            node = by_node[nn]
            # only an actually-idle node parks: queued or in-flight work
            # defers the spin-down to the next scale_at instant
            if any(queues[nn].values()) or any(
                    b > ts for b in busy_until[nn].values()):
                continue
            for cn in list(node.arbiter.tenants()):
                retire_replica(cn, nn, None)
            node.state = STANDBY
            log_event(scale_events, "scale_events", (ts, "down", nn))
            if tracer is not None:
                tracer.decision(obs.SCALE, ts, ts, node=nn,
                                direction="down")
            readmit_orphans()

    ei = 0
    t = 0.0
    while True:
        alive = [n for n in nodes if n.alive]
        backlog = ei < len(events) or bool(retry_heap) or any(
            q for n in alive for q in queues[n.name].values())
        in_flight = any(b > t for n in alive
                        for b in busy_until[n.name].values())
        if not backlog and not in_flight:
            break
        if t > last_arrival + max_drain_s:
            break   # safety: leftover queues flushed as dropped below

        # --- lifecycle events (epoch boundary) ------------------------------
        while chaos_due and chaos_due[0][0] <= t:
            # injection becomes visible this boundary: log it (scenario
            # timestamps — part of the determinism contract) + CHAOS span
            tc, kind, nn = chaos_due.pop(0)
            injections.append((tc, kind, nn))
            m.counter("chaos_injections_total", kind=kind).inc()
            if tracer is not None:
                tracer.decision(obs.CHAOS, t, t, node=nn, kind=kind)
        for nn, td in drain_at.items():
            if by_node[nn].state == UP and t >= td:
                by_node[nn].state = DRAINING
        for nn, tw in wedge_at.items():
            # silent stall: stays routable, stops completing — only the
            # health check (or the drain-horizon safety) can end this
            if by_node[nn].alive and t >= tw:
                wedged[nn] = True
        for nn, tf in fail_at.items():
            if by_node[nn].state != DEAD and t >= tf:
                fail_node(nn, t)
        for node in nodes:
            nn = node.name
            if node.state == DRAINING and not any(
                    queues[nn].values()) and not any(
                    b > t for b in busy_until[nn].values()):
                # queues emptied: migrate the registrations off the node
                node.state = DRAINED
                for cn in node.arbiter.tenants():
                    node.arbiter.export_tenant(cn)
                    if nn in placements.get(cn, ()):
                        placements[cn].remove(nn)
                readmit_orphans()

        # --- placement engine (epoch boundary) ------------------------------
        while warming and min(w[0] for w in warming) <= t:
            # warmed replicas rejoin the rotation
            done_w = [w for w in warming if w[0] <= t]
            for _, cn, nn in done_w:
                rtr.set_weight(cn, nn, None)
            warming = [w for w in warming if w[0] > t]
        if pending_retires:
            # make-before-break back half: the destination is warm (its
            # router weight just cleared above) — NOW retire the source,
            # re-homing its backlog onto the serving destination.  A
            # destination that died (or was preempted away) meanwhile
            # falls back to any surviving placement; a source already
            # gone needs nothing.
            due_r = [p for p in pending_retires if p[0] <= t]
            pending_retires = [p for p in pending_retires if p[0] > t]
            for _, cn, src, dst in due_r:
                if src not in placements.get(cn, ()):
                    continue
                dest = (dst if dst in placements.get(cn, ())
                        and by_node[dst].alive else None)
                retire_replica(cn, src, dest)
        up_chips = sum(n.g(t).total_chips for n in nodes if n.state == UP)
        backlog_now = sum(len(q) for n in nodes if n.alive
                          for q in queues[n.name].values())
        scale_ewma = (_SCALE_BETA * scale_ewma + (1.0 - _SCALE_BETA)
                      * (backlog_now / max(1, up_chips)))
        while scale_due and scale_due[0] <= t:
            scale_due.pop(0)
            run_scaling(t)
        while rebalance_due and rebalance_due[0] <= t:
            rebalance_due.pop(0)
            run_rebalance(t)

        # --- chaos continuous overlays (polled each epoch) ------------------
        if timeline is not None:
            for node in nodes:
                # thermal ladder → DVFS throttle: the node's arbiter
                # re-water-fills over the low-frequency LUT points
                node.chaos_throttle = timeline.throttle(node.name, t)

        # --- per-node arbitration with backlog signals ----------------------
        allocs: Dict[str, dict] = {}
        svc: Dict[str, dict] = {}
        for node in nodes:
            if not node.alive:
                continue
            nn = node.name
            for cn in node.arbiter.tenants():
                q = queues[nn][cn]
                node.arbiter.set_active(
                    cn, bool(q) or busy_until[nn][cn] > t,
                    queue_depth=len(q),
                    arrival_rate_rps=arrived_epoch[nn][cn] / interval_s)
                arrived_epoch[nn][cn] = 0
            allocs[nn] = node.arbiter.tick(node.g(t))
            svc[nn] = svc_of(allocs[nn])
            if tracer is not None:
                tracer.decision(
                    obs.ARBITRATE, t, t, node=nn,
                    tenants=len(allocs[nn]),
                    granted=sum(a.chips for a in allocs[nn].values()))
        t_next = t + interval_s
        # epoch-start outcome snapshot: brownout pressure is computed
        # from THIS epoch's deltas at the end of the epoch
        if rel is not None and rel.brownout is not None:
            brown_snap = {cn: (stats[cn].failed + stats[cn].retried,
                               stats[cn].completed + stats[cn].failed
                               + stats[cn].dropped + stats[cn].retried)
                          for cn in stats}
        if wt is not None:
            wt_snap = {cn: (stats[cn].good, stats[cn].completed,
                            stats[cn].dropped, stats[cn].failed)
                       for cn in stats}

        def route_candidates(cn: str, ta: float):
            """Routable placements minus chaos-partitioned edges."""
            cands = [by_node[x] for x in placements[cn]]
            if timeline is not None:
                cands = [nd for nd in cands
                         if not timeline.partitioned(nd.name, ta)]
            return cands

        def load_at(ta: float):
            return lambda nd: nd.load(
                ta, extra_backlog=sum(arrived_epoch[nd.name].values()))

        # --- re-route retries that came due (reliability layer) -------------
        while retry_heap and retry_heap[0][0] < t_next:
            t_r, _, cn, it = heapq.heappop(retry_heap)
            cands = route_candidates(cn, t_r)
            node = rtr.pick(cn, cands, t=t_r, load_fn=load_at(t_r)) \
                if cands else None
            if node is None:
                # nowhere to go *right now* — treat as one more failed
                # attempt (may back off again if attempts/deadline allow)
                resolve_failure(cn, it, t_r, None)
                continue
            arrived_epoch[node.name][cn] += 1
            queues[node.name][cn].append(it)

        # --- route + admit/shed this epoch's arrivals -----------------------
        while ei < len(events) and events[ei][0] < t_next:
            ta, cn = events[ei]
            ei += 1
            c = by_class[cn]
            st = stats[cn]
            st.submitted += 1
            if not placements[cn]:
                if admitted0[cn]:
                    st.dropped += 1   # lost its nodes to failures/drains
                else:
                    st.rejected += 1  # admission never placed the class
                continue
            cands = route_candidates(cn, ta)
            node = rtr.pick(cn, cands, t=ta, load_fn=load_at(ta)) \
                if cands else None
            if node is None:
                if rel is not None:
                    # no reachable replica (all partitioned/warming):
                    # the reliability layer may retry once edges heal
                    resolve_failure(cn, _Req(t=ta, t0=ta), ta, None)
                else:
                    st.dropped += 1   # placements exist but none routable
                continue
            nn = node.name
            arrived_epoch[nn][cn] += 1
            if policy == SLO_POLICY and svc[nn].get(cn) is None:
                # arrival for a class holding no slice on its node:
                # preempt NOW, mid-cycle, exactly as the single-node path
                node.arbiter.preempt(cn, node.g(ta))
                allocs[nn] = node.arbiter.last_allocations()
                svc[nn] = svc_of(allocs[nn])
            if (policy == SLO_POLICY and c.drop_policy == SHED
                    and not brown_on[cn]
                    and svc[nn].get(cn) is not None):
                q_len = len(queues[nn][cn])
                occ = min(q_len + 1, c.max_batch)
                pt = svc[nn][cn]
                lm = (timeline.latency_mult(nn, ta)
                      if timeline is not None else 1.0)
                batch_ms = lm * _service_ms(pt.latency_ms, occ, c.max_batch,
                                            service_model, spec=pt.subnet,
                                            calibration=calibration)
                n_batches = math.ceil((q_len + 1) / c.max_batch)
                eta_ms = (max(0.0, busy_until[nn][cn] - ta) * 1e3
                          + n_batches * batch_ms)
                if eta_ms > c.deadline_ms:
                    st.dropped += 1   # predicted miss: shed on arrival
                    continue
            it = _Req(t=ta, t0=ta)
            pol = rel.policy_for(cn) if rel is not None else None
            if pol is not None and pol.hedge and len(cands) > 1:
                # hedged request: a SECOND copy on a distinct replica
                # that holds a slice; first completion wins, the loser
                # counts hedge_wasted (submitted counted ONCE)
                others = [nd for nd in cands if nd.name != nn]
                second = rtr.pick(cn, others, t=ta, load_fn=load_at(ta))
                if second is not None \
                        and svc.get(second.name, {}).get(cn) is not None:
                    gid = next_gid
                    next_gid += 1
                    hedge_groups[gid] = {"live": 2, "done": False}
                    it = _Req(t=ta, t0=ta, gid=gid)
                    queues[second.name][cn].append(it)
                    arrived_epoch[second.name][cn] += 1
            queues[nn][cn].append(it)

        # --- serve each node's queues in batches ----------------------------
        for node in nodes:
            if not node.alive or wedged[node.name]:
                continue   # wedged: accepts routes, completes nothing
            nn = node.name
            dies = fail_at.get(nn, math.inf)
            lm = (timeline.latency_mult(nn, t)
                  if timeline is not None else 1.0)   # straggler slowdown
            for cn, q in queues[nn].items():
                pt = svc.get(nn, {}).get(cn)
                if pt is None:
                    continue   # starved this epoch; queue waits
                c = by_class[cn]
                st = stats[cn]
                while q:
                    start = max(q[0].t, busy_until[nn][cn], t)
                    if start >= t_next:
                        break
                    k = 0
                    for item in q:
                        if item.t <= start and k < c.max_batch:
                            k += 1
                        else:
                            break
                    k = max(k, 1)
                    done = start + lm * _service_ms(
                        pt.latency_ms, k, c.max_batch, service_model,
                        spec=pt.subnet, calibration=calibration) / 1e3
                    if done > dies:
                        break   # the node dies first: fail_at errors these
                    busy_until[nn][cn] = done
                    st.batches += 1
                    st.batch_occupancy += k
                    energy[cn].inc(pt.energy_mj)
                    completions[nn].inc(k)
                    if tracer is not None:
                        dev_attrs = {
                            "bucket": k, "n": k,
                            "subnet": (pt.subnet.name()
                                       if hasattr(pt.subnet, "name")
                                       else str(pt.subnet))}
                        warm_t = warm_until.get((nn, cn), 0.0)
                    for _ in range(k):
                        it = q.popleft()
                        if it.gid >= 0:
                            grp = hedge_groups[it.gid]
                            grp["live"] -= 1
                            if grp["done"]:
                                # sibling answered first: this copy paid
                                # for a batch slot and nothing else
                                st.hedge_wasted += 1
                                continue
                            grp["done"] = True
                        lat_ms = (done - it.t0) * 1e3
                        st.completed += 1
                        st.latencies_ms.append(lat_ms)
                        if lat_ms <= c.deadline_ms:
                            st.good += 1
                        if tracer is None:
                            lat_hist[cn].observe(lat_ms)
                            continue
                        # virtual-time span tree, same schema as live:
                        # host-side stages are zero-width points at batch
                        # start (the analytic service model folds them
                        # into `device`); a wait behind a migrating
                        # replica's warmup is WARMING, the rest QUEUE —
                        # the components still partition [it.t, done].
                        # A retry's tree starts at ITS OWN submit time
                        # and links to the first failed attempt's tree.
                        w1 = min(start, warm_t)
                        spans = [(obs.ROUTE, it.t, it.t, None)]
                        if w1 > it.t:
                            spans.append((obs.WARMING, it.t, w1, None))
                            spans.append((obs.QUEUE, w1, start, None))
                        else:
                            spans.append((obs.QUEUE, it.t, start, None))
                        spans.extend([
                            (obs.COLLECT, start, start, None),
                            (obs.STACK, start, start, None),
                            (obs.DISPATCH, start, start, None),
                            (obs.DEVICE, start, done, dev_attrs),
                            (obs.COMPLETE, done, done, None)])
                        rid = tracer.request(cn, it.t, done, node=nn,
                                             spans=spans,
                                             links=([it.first_rid]
                                                    if it.first_rid >= 0
                                                    else ()))
                        lat_hist[cn].observe(lat_ms, exemplar=rid)

        # --- stall-based health check (end of epoch) ------------------------
        for node in nodes:
            nn = node.name
            if nn not in health or node.state != UP:
                continue
            backlog_n = sum(len(q) for q in queues[nn].values())
            if health[nn].observe(int(completions[nn].value), backlog_n):
                # completions flat for K epochs with queued work: the
                # node is wedged — auto-fail it over, exactly the path
                # an operator-scripted fail_at would take
                log_event(health_failed, "health", (t_next, nn))
                if tracer is not None:
                    tracer.decision(obs.HEALTH_FAIL, t_next, t_next,
                                    node=nn)
                fail_node(nn, t_next)

        # --- brownout: degrade under sustained chaos pressure ---------------
        if rel is not None and rel.brownout is not None:
            bp = rel.brownout
            for cn, st in stats.items():
                bad = (st.failed + st.retried) - brown_snap[cn][0]
                total = (st.completed + st.failed + st.dropped
                         + st.retried) - brown_snap[cn][1]
                frac = bad / total if total else 0.0
                brown_p[cn] = bp.beta * brown_p[cn] + (1 - bp.beta) * frac
                if not brown_on[cn] and brown_p[cn] >= bp.enter_pressure:
                    # serve degraded instead of dropping: every replica's
                    # arbiter pins the class to its DEGRADE target and
                    # the shed check is suspended (see arrivals above)
                    brown_on[cn] = True
                    brownouts.append((t_next, cn, "enter"))
                    m.counter("cluster_brownouts_total", cls=cn).inc()
                    for nn2 in placements[cn]:
                        if cn in by_node[nn2].arbiter.tenants():
                            by_node[nn2].arbiter.set_brownout(
                                cn, by_class[cn].degraded_target_ms)
                    if tracer is not None:
                        tracer.decision(obs.BROWNOUT, t_next, t_next,
                                        cls=cn, direction="enter")
                elif brown_on[cn] and brown_p[cn] <= bp.exit_pressure:
                    brown_on[cn] = False
                    brownouts.append((t_next, cn, "exit"))
                    if not wt_brown[cn]:
                        # watchtower still burning: its alert owns the
                        # degraded target until it clears
                        for nn2 in placements[cn]:
                            if cn in by_node[nn2].arbiter.tenants():
                                by_node[nn2].arbiter.set_brownout(cn, None)
                    if tracer is not None:
                        tracer.decision(obs.BROWNOUT, t_next, t_next,
                                        cls=cn, direction="exit")

        # --- SLO watchtower: feed outcomes, evaluate, actuate ---------------
        if wt is not None:
            for cn, st in stats.items():
                g0, c0, d0, f0 = wt_snap[cn]
                d_good = st.good - g0
                bad = ((st.completed - c0) - d_good
                       + (st.dropped - d0) + (st.failed - f0))
                # every epoch samples (zeros keep the window clock
                # honest: no-traffic epochs burn nothing)
                wt.observe(t_next, cn, good=d_good, bad=bad)
            alerts_new = wt.evaluate(t_next)
            run_alerts.extend(alerts_new)
            if wt.actuate:
                for cn in stats:
                    p = wt.pressure(cn)
                    for nn2 in placements[cn]:
                        by_node[nn2].arbiter.set_alert_pressure(cn, p)
                    c = by_class[cn]
                    if (wt.active(cn) and not wt_brown[cn]
                            and c.degraded_target_ms > c.service_target_ms):
                        # alert-driven early degrade: the fast burn sees
                        # LATE completions, which the failure-pressure
                        # EWMA is blind to — a pure latency fault relaxes
                        # the arbiter's quality target here, epochs
                        # before (or entirely without) the reactive
                        # path; the shed check stays ON (only the EWMA
                        # brownout suspends admission control)
                        wt_brown[cn] = True
                        brownouts.append((t_next, cn, "enter"))
                        m.counter("cluster_brownouts_total", cls=cn).inc()
                        if not brown_on[cn]:
                            for nn2 in placements[cn]:
                                if cn in by_node[nn2].arbiter.tenants():
                                    by_node[nn2].arbiter.set_brownout(
                                        cn, c.degraded_target_ms)
                        if tracer is not None:
                            tracer.decision(obs.BROWNOUT, t_next, t_next,
                                            cls=cn, direction="enter")
                    elif wt_brown[cn] and not wt.active(cn):
                        wt_brown[cn] = False
                        brownouts.append((t_next, cn, "exit"))
                        if not brown_on[cn]:
                            for nn2 in placements[cn]:
                                if cn in by_node[nn2].arbiter.tenants():
                                    by_node[nn2].arbiter.set_brownout(
                                        cn, None)
                        if tracer is not None:
                            tracer.decision(obs.BROWNOUT, t_next, t_next,
                                            cls=cn, direction="exit")
                if getattr(wt, "rebalance_on_alert", False) and alerts_new:
                    # alert pressure reaches the placement layer too: a
                    # rising-edge alert triggers the autoscaler NOW
                    # instead of at the next scheduled scale_at instant
                    # — the same water-filling objective decides, the
                    # alert only moves the clock.  Only when no standby
                    # capacity came up does a full rebalance run:
                    # rebalancing WHILE fresh replicas warm retires the
                    # degraded-but-serving sources into a capacity hole
                    n_scale = len(scale_events)
                    run_scaling(t_next)
                    if len(scale_events) == n_scale:
                        run_rebalance(t_next)
        t = t_next

    for node in nodes:
        for cn, q in queues[node.name].items():
            for it in q:
                if it.gid >= 0:
                    # horizon flush is terminal: no retries — but a copy
                    # whose sibling already answered is just hedge waste,
                    # and one with a live sibling defers to it
                    grp = hedge_groups[it.gid]
                    grp["live"] -= 1
                    if grp["done"]:
                        stats[cn].hedge_wasted += 1
                        continue
                    if grp["live"] > 0:
                        continue
                if node.state == DEAD:
                    stats[cn].failed += 1
                else:
                    stats[cn].dropped += 1   # unserved within the horizon
            q.clear()
    for _, _, cn, _it in retry_heap:
        stats[cn].failed += 1   # retry scheduled past the horizon
    node_view = {n.name: {"state": n.state,
                          "capacity_chips": n.g(t).total_chips,
                          "arbiter": n.arbiter.summary()}
                 for n in nodes}
    return ClusterReport(policy=policy, router=router, classes=stats,
                         nodes=node_view, decisions=list(rtr.decisions),
                         routed=rtr.routed_counts(),
                         health_failed=list(health_failed),
                         migrations=list(migrations),
                         preempted=list(preempted),
                         scale_events=list(scale_events),
                         unplaceable=sorted(unplaceable),
                         injections=list(injections),
                         brownouts=list(brownouts),
                         alerts=list(run_alerts),
                         retry_granted=budget.granted if budget else 0,
                         retry_denied=dict(retry_denied),
                         decisions_dropped=rtr.decisions_dropped,
                         log_dropped=dict(log_dropped),
                         energy_mj={c.name: energy[c.name].value
                                    for c in classes},
                         migration_energy_mj=mig_energy.value,
                         tracer=tracer, metrics=m)
