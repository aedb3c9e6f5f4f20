"""Concurrent-workload runtime arbiter.

The paper's management layer monitors *multiple concurrent workloads* and
splits the hardware between them; the single-model :class:`JointGovernor`
cannot do that — each instance assumes it owns the whole machine, so two
governors co-running on one slice oversubscribe it.  The arbiter closes the
gap (the multi-DNN arbitration problem of Xun et al., arXiv:2105.03608):

* N registered workloads, each with its own LUT, latency target, priority
  and :class:`JointGovernor`;
* a global chip count + power budget, divided by **iterative
  water-filling**: first give every workload (in priority order) the
  *smallest* resource share under which a feasible :class:`OpPoint` exists,
  then pour the surplus back wherever it buys the most, until a full pass
  changes nothing.  The surplus pass is **queue-depth aware** (ROADMAP
  item): :meth:`set_active` carries each tenant's queue length and an
  arrival-rate EWMA (tenants with servers report their live queue depth
  automatically), and backlogged tenants are filled FIRST, trading up to
  their *fastest* feasible point so the surplus drains the backlog; only
  backlog-free tenants spend surplus on accuracy, in priority order as
  before;
* a shared constraint clock that re-arbitrates periodically and drives the
  per-workload governors/servers — multiple :class:`DynamicServer`
  instances run behind one arbiter, each keeping its own (thread-safe)
  executable cache.

Degradation is by priority: when the budget shrinks below the sum of
minimal shares, the lowest-priority workloads lose their targets first and
fall back to the fastest point that fits the leftovers.

The traffic layer (``repro_torch.traffic``) adds two ROADMAP items on top:

* **admission control** — :meth:`ResourceArbiter.admission_check` asks
  whether a prospective class's minimal feasible share can EVER fit next
  to the minimal shares of its equal-or-higher-priority tenants;
  ``register(..., admission_under=g)`` raises :class:`AdmissionError`
  when it cannot (lower-priority tenants don't block admission — they
  are preemptable);
* **priority preemption** — :meth:`ResourceArbiter.preempt` re-arbitrates
  mid-cycle on behalf of a high-priority arrival, evicting lower-priority
  slices immediately instead of waiting for the next constraint clock
  tick.  Idle workloads release their slice via :meth:`set_active`.

With a :class:`repro_torch.runtime.telemetry.CalibrationStore` attached
(``ResourceArbiter(calibration=...)``) the planner is CLOSED-LOOP (the
paper's runtime layer "monitors the dynamically changing algorithms'
performance targets as well as hardware resources"): feasibility runs on
calibrated point latencies (measured per-bucket EWMAs blended over the
analytic prior) and the power budget is charged the tenant's MEASURED
watts — modelled slice power scaled by its observed duty cycle — so the
energy objective the paper optimises is driven by observed energy, not
the open-loop ``slice_power_w`` model.

Lock discipline (enforced by ``pytest --lock-check``, see
:mod:`repro_torch.analysis.locks`): the canonical project lock order is
``Cluster._admin_lock > Cluster._lock > ResourceArbiter._lock >
DynamicServer locks > Tracer/Metrics locks`` — outer locks left of inner.
``ResourceArbiter._lock`` (an RLock) guards ``_workloads`` and
``last_alloc``; it may be taken while a cluster lock is held (router load
probes, drain/failover) and may itself be held while taking engine locks
(``_drive_servers`` pausing/resuming servers), but never the reverse.
External readers of ``last_alloc`` go through :meth:`last_allocations`.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import threading
import time
from typing import Callable, Deque, Dict, List, Optional, Tuple

from repro_torch.analysis.guards import guarded_by
from repro_torch.core.pareto import OpPoint
from repro_torch.obs import trace as obs
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.runtime import hwmodel as hm
from repro_torch.runtime import waterfill as wf
from repro_torch.runtime.engine import DynamicServer
from repro_torch.runtime.governor import Constraints, JointGovernor
from repro_torch.runtime.lut import LUT

# the water-filling core lives in repro_torch.runtime.waterfill (the
# cluster placement engine runs the SAME solver over nodes); the aliases
# keep the arbiter's historical knobs pointing at the one definition
_MAX_FILL_PASSES = wf.MAX_FILL_PASSES
# new latency observations before a tenant's calibrated LUT is rebuilt
_LUT_REFRESH_SAMPLES = 16
# smoothing for the arrival-rate EWMA reported through set_active()
_EWMA_BETA = 0.6
# below this many pending requests a tenant counts as backlog-free (the
# EWMA decays geometrically and never exactly reaches zero — without a
# threshold one reported burst would keep a tenant "backlogged" forever)
_BACKLOG_MIN = wf.BACKLOG_MIN


class AdmissionError(RuntimeError):
    """A registration whose minimal feasible share can never fit."""


# the per-tenant accounting series (label ``tenant=``) that replaced the
# old ad-hoc ``_stats`` dicts; :meth:`ResourceArbiter.summary` reads them
# back into its historical row shape, and unregister/export clears them so
# a re-registered tenant never inherits a predecessor's meet-rate
_STAT_SERIES = ("arbiter_cycles_total", "arbiter_met_total",
                "arbiter_energy_mj_total", "arbiter_share_sum",
                "arbiter_preemptions_total")
_STAT_GAUGES = ("arbiter_chips", "arbiter_backlog")


@dataclasses.dataclass
class GlobalConstraints:
    """The shared machine state the arbiter divides each cycle."""
    total_chips: int
    power_budget_w: Optional[float] = None
    temperature_throttle: float = 1.0


@dataclasses.dataclass
class Workload:
    """One tenant: a governed model with its own profile and target."""
    name: str
    lut: LUT
    target_latency_ms: float
    priority: int = 0
    min_accuracy: Optional[float] = None
    governor: Optional[JointGovernor] = None
    server: Optional[DynamicServer] = None
    active: bool = True   # idle tenants release their slice (set_active)
    # backlog signals (queue-depth-aware water-filling): reported through
    # set_active() or refreshed from server.queue_depth() each arbitration
    queue_depth: int = 0
    arrival_ewma: float = 0.0   # requests/s, smoothed
    # exactly-once rate smoothing: arrivals pulled off the server since
    # the last EWMA update, and when that update happened (monotonic s).
    # A mid-cycle preempt() accumulates counts here instead of smoothing
    # a partial window a second time.
    rate_pending: int = 0
    rate_last_t: Optional[float] = None
    # last seen server.measured_energy_mj (per-tick measured-watts delta)
    energy_last_mj: float = 0.0
    # brownout mode (chaos reliability): the ORIGINAL target while the
    # tenant is pinned to its degraded one; None = not browned out
    brownout_base_ms: Optional[float] = None
    # SLO-watchtower burn signal (0 = healthy): while a fast burn-rate
    # alert is active on this tenant's class, the surplus pass treats its
    # backlog as (1 + alert_pressure)x — capacity shifts toward the
    # burning class BEFORE failure pressure would have reacted
    alert_pressure: float = 0.0

    def __post_init__(self):
        if self.governor is None:
            self.governor = JointGovernor(self.lut)


@dataclasses.dataclass
class Headroom:
    """Unreserved capacity after minimal shares (cluster admission export)."""
    chips: int
    power_w: float   # math.inf when the node has no power budget


@dataclasses.dataclass
class Allocation:
    """One workload's share of the machine for one arbitration cycle."""
    workload: str
    point: Optional[OpPoint]   # None => starved (nothing fits the leftovers)
    chips: int
    power_w: float
    feasible: bool             # meets its latency target within its share
    share: float = 0.0         # chips / total_chips
    # what the slice costs against the global power budget: modelled
    # watts scaled by the tenant's MEASURED duty cycle when a calibration
    # store is attached (== power_w otherwise).  Summing priced watts is
    # how the energy-aware water-filling packs more tenants under one
    # budget without oversubscribing observed draw.
    priced_power_w: float = 0.0


@guarded_by("_lock", "_workloads", "last_alloc")
class ResourceArbiter:
    """Water-filling allocator + shared constraint clock over N workloads."""

    def __init__(self, *, interval_s: float = 0.05, calibration=None,
                 time_fn: Callable[[], float] = time.monotonic,
                 tracer=None, metrics: Optional[MetricsRegistry] = None):
        self.interval_s = interval_s
        # measured-performance feedback (repro_torch.runtime.telemetry
        # .CalibrationStore): when set, water-filling plans off CALIBRATED
        # point latencies and prices candidate slices with each tenant's
        # measured watts instead of the raw modelled slice_power_w
        self.calibration = calibration
        self._time_fn = time_fn   # injectable for deterministic tests
        self._workloads: Dict[str, Workload] = {}   # guarded-by: _lock
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._clock: Optional[threading.Thread] = None
        # per-tenant calibrated-LUT cache: (raw lut, store version, eff)
        self._lut_cache: Dict[str, Tuple[LUT, int, LUT]] = {}
        # recent cycles only; summary() uses the running accumulators so a
        # 20 Hz clock doesn't grow memory without bound
        self.alloc_log: Deque[Dict[str, Allocation]] = collections.deque(
            maxlen=4096)
        self.last_alloc: Dict[str, Allocation] = {}   # guarded-by: _lock
        # per-tenant accounting lives in the metrics registry (see
        # _STAT_SERIES); the arbiter owns its registry by default — two
        # nodes can both host a tenant "api", so arbiter registries are
        # NOT shared cluster-wide (the cluster keeps its own for
        # router/placement counters)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        # live tracing: ARBITRATE decision spans per tick.  The cluster
        # sets trace_label to the node name; the virtual-time simulators
        # leave arbiter tracers unset and emit their own spans at sim time
        self.tracer = tracer
        self.trace_label: Optional[str] = None

    # --- registration -------------------------------------------------------

    def register(self, name: str, lut: LUT, target_latency_ms: float, *,
                 priority: int = 0, min_accuracy: Optional[float] = None,
                 governor: Optional[JointGovernor] = None,
                 server: Optional[DynamicServer] = None,
                 admission_under: Optional[GlobalConstraints] = None
                 ) -> Workload:
        with self._lock:
            if name in self._workloads:
                raise ValueError(f"workload {name!r} already registered")
            if admission_under is not None and self.admission_check(
                    lut, target_latency_ms, admission_under,
                    priority=priority, min_accuracy=min_accuracy) is None:
                raise AdmissionError(
                    f"workload {name!r}: no feasible point under "
                    f"{target_latency_ms}ms fits {admission_under.total_chips}"
                    f" chips after equal-or-higher-priority minimal shares")
            w = Workload(name=name, lut=lut,
                         target_latency_ms=target_latency_ms,
                         priority=priority, min_accuracy=min_accuracy,
                         governor=governor, server=server)
            self._workloads[name] = w
            if (server is not None and not server.is_running
                    and self._clock is not None and self._clock.is_alive()):
                # late arrival while the clock is already running
                server.start()
            return w

    def _touch_stats(self, name: str):
        """Create the tenant's full accounting row at once — summary()'s
        row-existence semantics (absent vs all-zero) match the old dicts."""
        for s in _STAT_SERIES:
            self.metrics.counter(s, tenant=name)

    def _clear_stats(self, name: str):
        for s in _STAT_SERIES + _STAT_GAUGES:
            self.metrics.remove(s, tenant=name)

    def unregister(self, name: str):
        with self._lock:
            w = self._workloads.pop(name, None)
            self.last_alloc.pop(name, None)
            # a later tenant registering under the same name must not
            # inherit this one's accumulated cycles/meet-rate/energy
            self._clear_stats(name)
            self._lut_cache.pop(name, None)
            if w is not None and w.server is not None:
                w.server.stop()   # the clock drove it; don't leak the worker

    def export_tenant(self, name: str) -> Workload:
        """Remove a tenant WITHOUT stopping its server (migration hook).

        The cluster layer moves a draining node's registrations to
        surviving nodes: the returned :class:`Workload` carries the
        lut/target/priority needed to re-register elsewhere, and the
        server (if any) stays up so in-flight work still resolves.
        Stats are cleared like :meth:`unregister` — the new host starts
        the tenant's accounting fresh.
        """
        with self._lock:
            w = self._workloads.pop(name)   # KeyError: unknown workload
            self.last_alloc.pop(name, None)
            self._clear_stats(name)
            self._lut_cache.pop(name, None)
            return w

    def set_active(self, name: str, active: bool = True, *,
                   queue_depth: Optional[int] = None,
                   arrival_rate_rps: Optional[float] = None):
        """Idle workloads release their slice (an empty request queue needs
        no chips); the traffic driver toggles this as queues fill/drain.

        ``queue_depth`` and ``arrival_rate_rps`` carry the tenant's backlog
        into the arbiter (ROADMAP queue-depth-aware water-filling): the
        surplus pass fills the most backlogged tenant first, buying it
        speed instead of accuracy.  The arrival rate is EWMA-smoothed here
        so callers can report instantaneous per-epoch rates.

        For a tenant WITH a server the reported rate is ignored: the
        server's own arrival counter is authoritative and is smoothed
        once per interval by :meth:`arbitrate` — accepting a second
        report of the same arrivals here would run them through the EWMA
        twice (the double-smoothing bug: the twice-smoothed value then
        feeds the server's adaptive batching window at an effective
        beta² instead of the configured beta).
        """
        with self._lock:
            w = self._workloads[name]
            w.active = active
            if queue_depth is not None:
                w.queue_depth = max(0, int(queue_depth))
            if arrival_rate_rps is not None and w.server is None:
                w.arrival_ewma = (_EWMA_BETA * w.arrival_ewma
                                  + (1.0 - _EWMA_BETA)
                                  * max(0.0, float(arrival_rate_rps)))

    def set_brownout(self, name: str, degraded_target_ms: Optional[float]):
        """Pin a tenant to a relaxed latency target (chaos brownout mode).

        Under sustained fault pressure the reliability layer prefers
        serving every request a bit slower over shedding some outright:
        passing a value saves the tenant's original target in
        ``brownout_base_ms`` and arbitrates against the degraded one
        (a looser target admits cheaper LUT points, freeing chips on the
        shrunken post-fault cluster); passing ``None`` restores the
        original.  Idempotent in both directions — re-entering brownout
        keeps the first saved base, restoring twice is a no-op.
        """
        with self._lock:
            w = self._workloads[name]
            if degraded_target_ms is None:
                if w.brownout_base_ms is not None:
                    w.target_latency_ms = w.brownout_base_ms
                    w.brownout_base_ms = None
            else:
                if w.brownout_base_ms is None:
                    w.brownout_base_ms = w.target_latency_ms
                    self.metrics.counter("arbiter_brownouts_total",
                                         tenant=name).inc()
                w.target_latency_ms = float(degraded_target_ms)

    def set_alert_pressure(self, name: str, pressure: float):
        """Feed one tenant's watchtower burn signal into arbitration.

        ``pressure`` is the normalised fast-window burn (0 = no active
        alert); the demand phrasing scales the tenant's backlog by
        ``1 + pressure`` so water-filling's surplus pass favours the
        burning class.  Unknown tenants are ignored (the watchtower may
        monitor classes a node does not host)."""
        with self._lock:
            w = self._workloads.get(name)
            if w is None:
                return
            w.alert_pressure = max(0.0, float(pressure))
            self.metrics.gauge("arbiter_alert_pressure",
                               tenant=name).set(w.alert_pressure)

    def _backlog(self, w: Workload) -> float:
        """Pending work the surplus pass should drain: queued requests plus
        the arrivals expected before the next arbitration."""
        return w.queue_depth + w.arrival_ewma * self.interval_s

    def tenants(self) -> List[str]:
        """Registered workload names, in registration order."""
        with self._lock:
            return list(self._workloads)

    def backlog(self, name: str) -> float:
        """One tenant's pending-work signal (cluster routing reads it)."""
        with self._lock:
            return self._backlog(self._workloads[name])

    def last_allocations(self) -> Dict[str, "Allocation"]:
        """Snapshot of the most recent per-tenant allocations.

        The locked accessor external readers (health checks, drivers,
        simulators) must use instead of touching ``last_alloc`` directly —
        ``arbitrate`` rebinds it mid-cycle under ``_lock``.
        """
        with self._lock:
            return dict(self.last_alloc)

    def total_backlog(self) -> float:
        """Summed pending work across active tenants — the per-node load
        signal the cluster router's least-loaded/p2c policies compare."""
        with self._lock:
            return sum(self._backlog(w) for w in self._workloads.values()
                       if w.active)

    def _priority_order(self) -> List[Workload]:
        # stable sort: ties broken by registration order
        return sorted(self._workloads.values(), key=lambda w: -w.priority)

    # --- admission control --------------------------------------------------

    def admission_check(self, lut: LUT, target_latency_ms: float,
                        g: GlobalConstraints, *, priority: int = 0,
                        min_accuracy: Optional[float] = None
                        ) -> Optional[OpPoint]:
        """Can a prospective class ever get its minimal feasible share?

        Reserves the minimal feasible share of every equal-or-higher-
        priority tenant (lower-priority tenants are preemptable, so they
        don't block admission) and looks for a feasible point in the
        remainder.  Returns that point, or None — reject the registration
        (ROADMAP admission-control item).
        """
        with self._lock:
            chips_left, power_left = self._after_min_shares(
                g, min_priority=priority)
            probe = Workload(name="__probe__", lut=lut,
                             target_latency_ms=target_latency_ms,
                             priority=priority, min_accuracy=min_accuracy)
            return self._min_share_point(probe, chips_left, power_left,
                                         g.temperature_throttle)

    def _after_min_shares(self, g: GlobalConstraints,
                          min_priority: Optional[int] = None
                          ) -> "tuple[int, float]":
        """(chips, power) left after reserving tenants' minimal feasible
        shares — all tenants, or only those at ``min_priority`` and above
        (lower-priority tenants are preemptable)."""
        chips_left = g.total_chips
        power_left = (g.power_budget_w if g.power_budget_w is not None
                      else math.inf)
        for w in self._priority_order():
            if min_priority is not None and w.priority < min_priority:
                continue
            p = self._min_share_point(w, chips_left, power_left,
                                      g.temperature_throttle)
            if p is not None:
                chips_left -= p.hw_state.chips
                power_left -= (hm.slice_power_w(p.hw_state)
                               * self._power_scale(w.name))
        return chips_left, power_left

    def headroom(self, g: GlobalConstraints) -> "Headroom":
        """Chips/power left after EVERY tenant's minimal feasible share —
        the node's observability export (dashboards, `cluster_headroom`).

        This is deliberately more conservative than admission: it
        reserves all tenants, while the admission path
        (:meth:`admission_check`, called per node by
        ``repro_torch.cluster.cluster_admission``) skips lower-priority ones
        because they are preemptable.  Don't compute admission from this
        number.
        """
        with self._lock:
            chips_left, power_left = self._after_min_shares(g)
            return Headroom(chips=chips_left, power_w=power_left)

    # --- calibration (measured-performance feedback) ------------------------

    def _power_scale(self, name: str) -> float:
        """Measured/modelled watts ratio for one tenant (1.0 uncalibrated).

        Pricing a candidate slice at ``slice_power_w(hw) * scale`` makes
        the water-filling's power arithmetic run on OBSERVED draw: a
        tenant that historically keeps its slice 30 % busy charges the
        budget 30 % of the modelled board power.  Equivalently, its
        power cap is divided by the scale before the LUT filter.
        """
        if self.calibration is None:
            return 1.0
        return max(1e-6, self.calibration.power_scale(name))

    def _lut_for(self, w: Workload) -> LUT:
        """The tenant's planning LUT: raw, or calibrated point latencies.

        With a calibration store, each point's pad-to-max latency is
        re-estimated from the measured per-bucket EWMAs
        (:meth:`CalibrationStore.point_latency_ms` — analytic value as
        the prior, measurement blended in by sample count), so
        feasibility checks run on what the engine actually observed.

        Cached per tenant against the store's latency-observation
        counter, refreshed only after ``_LUT_REFRESH_SAMPLES`` new
        observations: under live traffic every completed batch bumps the
        counter, and rebuilding the table per 20 Hz tick would contend
        the store lock with the completer for no benefit — the blend
        moves negligibly per sample (EWMA + count confidence).
        """
        if self.calibration is None:
            return w.lut
        version = self.calibration.version()
        cached = self._lut_cache.get(w.name)
        if (cached is not None and cached[0] is w.lut
                and version - cached[1] < _LUT_REFRESH_SAMPLES):
            return cached[2]
        eff = LUT([dataclasses.replace(
            p, latency_ms=self.calibration.point_latency_ms(
                p.subnet, p.latency_ms)) for p in w.lut.points])
        if w.name != "__probe__":
            self._lut_cache[w.name] = (w.lut, version, eff)
        return eff

    # --- water-filling (delegates to repro_torch.runtime.waterfill) ---------------

    @staticmethod
    def _throttled(pts, throttle: float):
        if throttle < 1.0:
            pts = [p for p in pts if p.hw_state.freq <= throttle]
        return pts

    def _priced(self, p: OpPoint, scale: float) -> wf.PricedPoint:
        """One LUT point, phrased for the level-agnostic solver."""
        base = hm.slice_power_w(p.hw_state)
        return wf.PricedPoint(units=p.hw_state.chips, cost=base * scale,
                              base_cost=base, latency_ms=p.latency_ms,
                              accuracy=p.accuracy, energy_mj=p.energy_mj,
                              payload=p)

    def _demand_for(self, w: Workload, throttle: float) -> wf.Demand:
        """Phrase one workload as a solver demand.

        The candidate enumerators close over the tenant's calibrated LUT
        and duty-cycle price: the solver budgets in PRICED watts, so the
        callbacks un-price the cost cap back to modelled watts for the
        LUT's power filter — exactly the arithmetic the pre-extraction
        arbiter ran inline.
        """
        scale = self._power_scale(w.name)

        def feasible(chips_cap: int, power_cap: float):
            pts = self._lut_for(w).feasible(
                max_latency_ms=w.target_latency_ms,
                chips_available=chips_cap,
                power_budget_w=(None if math.isinf(power_cap)
                                else power_cap / scale),
                min_accuracy=w.min_accuracy, max_freq=throttle)
            return [self._priced(p, scale) for p in pts]

        def candidates(chips_cap: int, power_cap: float):
            cands = [p for p in self._lut_for(w).points
                     if p.hw_state.chips <= chips_cap
                     and hm.slice_power_w(p.hw_state) * scale <= power_cap]
            cands = self._throttled(cands, throttle) or cands
            return [self._priced(p, scale) for p in cands]

        return wf.Demand(name=w.name, feasible=feasible,
                         candidates=candidates, priority=w.priority,
                         backlog=self._backlog(w)
                         * (1.0 + w.alert_pressure))

    def _min_share_point(self, w: Workload, chips_cap: int,
                         power_cap: float, throttle: float
                         ) -> Optional[OpPoint]:
        """Feasible point with the smallest (chips, power), max accuracy.

        ``power_cap`` is in PRICED watts (measured-duty-cycle scaled);
        the demand callback converts it back to modelled watts for the
        LUT filter.
        """
        got = wf.min_share_point(self._demand_for(w, throttle),
                                 chips_cap, power_cap)
        return got.payload if got is not None else None

    def _best_effort_point(self, w: Workload, chips_cap: int,
                           power_cap: float, throttle: float
                           ) -> Optional[OpPoint]:
        """Fastest point that fits the leftover budget (target missed)."""
        got = wf.best_effort_point(self._demand_for(w, throttle),
                                   chips_cap, power_cap)
        return got.payload if got is not None else None

    def _refresh_live_tenant(self, w: Workload, now: float):
        """Pull a live tenant's measured signals (backlog, arrival rate,
        energy) — each observation smoothed EXACTLY once.

        Arrivals accumulate in ``rate_pending`` and enter the EWMA only
        when at least half an interval has elapsed since the last update,
        with the ACTUAL elapsed time as the rate denominator.  A
        mid-cycle :meth:`preempt` therefore neither re-smooths a partial
        window nor inflates the rate by dividing a few arrivals by a full
        ``interval_s``; the counts it drains are folded into the next
        tick's window instead.
        """
        w.queue_depth = w.server.queue_depth()
        w.rate_pending += w.server.take_arrival_count()
        elapsed = (self.interval_s if w.rate_last_t is None
                   else now - w.rate_last_t)
        if elapsed < 0.5 * self.interval_s:
            return
        w.arrival_ewma = (_EWMA_BETA * w.arrival_ewma
                          + (1.0 - _EWMA_BETA)
                          * (w.rate_pending / max(elapsed, 1e-9)))
        w.rate_pending = 0
        w.rate_last_t = now
        if self.calibration is not None:
            # measured tenant watts over the window vs the modelled watts
            # of the slice it held: the duty-cycle ratio that prices its
            # candidate points in the next water-filling pass
            energy_mj = w.server.measured_energy_mj
            d_mj = energy_mj - w.energy_last_mj
            w.energy_last_mj = energy_mj
            last = self.last_alloc.get(w.name)
            if last is not None and last.point is not None and d_mj >= 0:
                self.calibration.note_power(
                    w.name, (d_mj / max(elapsed, 1e-9)) / 1e3,
                    hm.slice_power_w(last.point.hw_state))

    def arbitrate(self, g: GlobalConstraints) -> Dict[str, Allocation]:
        """Divide (chips, power) among all registered workloads.

        The min-share + backlog-first-surplus objective itself lives in
        :func:`repro_torch.runtime.waterfill.waterfill` (shared with the
        cluster placement engine); this method phrases the active
        tenants as demands, runs the solver, and converts grants back
        into :class:`Allocation`s — bit-identical to the pre-extraction
        inline algorithm.
        """
        with self._lock:
            now = self._time_fn()
            for w in self._workloads.values():
                if w.server is not None:
                    # live tenants report backlog/rate/energy automatically
                    self._refresh_live_tenant(w, now)
            order = [w for w in self._priority_order() if w.active]
            power = (g.power_budget_w if g.power_budget_w is not None
                     else math.inf)
            grants = wf.waterfill(
                [self._demand_for(w, g.temperature_throttle) for w in order],
                g.total_chips, power)
            allocs: Dict[str, Allocation] = {}
            for w in order:
                grant = grants[w.name]
                point: Optional[OpPoint] = (grant.point.payload
                                            if grant.point is not None
                                            else None)
                allocs[w.name] = Allocation(
                    workload=w.name, point=point,
                    chips=point.hw_state.chips if point else 0,
                    power_w=(hm.slice_power_w(point.hw_state)
                             if point else 0.0),
                    feasible=grant.feasible,
                    priced_power_w=grant.cost)

            # inactive tenants hold nothing this cycle (slice released)
            for w in self._workloads.values():
                if w.name not in allocs:
                    allocs[w.name] = Allocation(workload=w.name, point=None,
                                                chips=0, power_w=0.0,
                                                feasible=False)
            for a in allocs.values():
                a.share = a.chips / g.total_chips if g.total_chips else 0.0
            self.last_alloc = allocs
            return allocs

    # --- per-workload constraints + governor/server drive -------------------

    def constraints_for(self, w: Workload, alloc: Allocation,
                        g: GlobalConstraints) -> Constraints:
        """The arbiter's grant, phrased as the workload's own Constraints."""
        return Constraints(
            target_latency_ms=w.target_latency_ms,
            chips_available=max(alloc.chips, 1),
            power_budget_w=alloc.power_w if alloc.power_w > 0 else None,
            min_accuracy=w.min_accuracy,
            temperature_throttle=g.temperature_throttle,
            priority=w.priority,
            share=alloc.share)

    def _drive_servers(self, allocs: Dict[str, Allocation],
                       g: GlobalConstraints):
        for w in self._workloads.values():
            alloc = allocs[w.name]
            if alloc.point is None:
                # starved or idle: its slice went to other tenants — park
                # the server so it doesn't compute on chips it lost
                if w.server is not None:
                    w.server.pause()
                continue
            c = self.constraints_for(w, alloc, g)
            if self.calibration is not None and hasattr(w.governor, "lut"):
                # the governor must re-pick from the same calibrated
                # table the water-filling planned with, or it would undo
                # the measurement loop with analytic latencies
                w.governor.lut = self._lut_for(w)
            point = w.governor.select(c)
            if w.server is not None:
                # the arbiter's EWMA sizes the server's adaptive batching
                # window (a no-op unless adaptive_window=True)
                w.server.note_arrival_rate(w.arrival_ewma)
                if point.subnet != w.server.active_spec:
                    w.server.switch(point.subnet, point)
                else:
                    w.server.active_point = point
                w.server.resume()

    def tick(self, g: GlobalConstraints) -> Dict[str, Allocation]:
        """One arbitration cycle: allocate, govern, switch/pause servers."""
        with self._lock:
            t0 = self.tracer.clock() if self.tracer is not None else 0.0
            allocs = self.arbitrate(g)
            self._drive_servers(allocs, g)
            self.alloc_log.append(allocs)
            m = self.metrics
            for name, a in allocs.items():
                w = self._workloads[name]
                if not w.active:
                    continue   # idle: no demand, don't dilute meet_rate
                self._touch_stats(name)
                m.counter("arbiter_cycles_total", tenant=name).inc()
                if a.feasible:
                    m.counter("arbiter_met_total", tenant=name).inc()
                m.counter("arbiter_share_sum", tenant=name).inc(a.share)
                if a.point is not None:
                    m.counter("arbiter_energy_mj_total", tenant=name).inc(
                        a.point.energy_mj)
                m.gauge("arbiter_chips", tenant=name).set(a.chips)
                m.gauge("arbiter_backlog", tenant=name).set(self._backlog(w))
            if self.tracer is not None:
                self.tracer.decision(
                    obs.ARBITRATE, t0, self.tracer.clock(),
                    node=self.trace_label,
                    tenants=sum(w.active
                                for w in self._workloads.values()),
                    granted=sum(a.chips for a in allocs.values()))
            return allocs

    def preempt(self, name: str, g: GlobalConstraints) -> Allocation:
        """Mid-cycle priority preemption (ROADMAP item).

        A high-priority arrival must not wait out the constraint clock:
        re-arbitrate NOW on behalf of ``name``.  Water-filling in priority
        order means any chips/power the arrival needs are reclaimed from
        strictly lower-priority tenants, whose servers are parked or
        downgraded in the same call — the eviction lands mid-cycle, not at
        the next tick.
        """
        with self._lock:
            w = self._workloads[name]   # KeyError: unknown workload
            w.active = True
            t0 = self.tracer.clock() if self.tracer is not None else 0.0
            allocs = self.arbitrate(g)
            self._drive_servers(allocs, g)
            self._touch_stats(name)
            self.metrics.counter("arbiter_preemptions_total",
                                 tenant=name).inc()
            if self.tracer is not None:
                self.tracer.decision(obs.PREEMPT, t0, self.tracer.clock(),
                                     node=self.trace_label, for_cls=name)
            return allocs[name]

    # --- shared constraint clock --------------------------------------------

    def start(self, global_constraints_fn: Callable[[], GlobalConstraints]):
        """Run the constraint clock: re-arbitrate every ``interval_s``."""
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                self.tick(global_constraints_fn())
                self._stop.wait(self.interval_s)

        self._clock = threading.Thread(target=loop, daemon=True)
        self._clock.start()
        with self._lock:
            servers = [w.server for w in self._workloads.values()]
        for server in servers:
            if server is not None and not server.is_running:
                # servers run governor-less: the arbiter's clock governs
                server.start()

    def stop(self):
        self._stop.set()
        if self._clock:
            self._clock.join(timeout=5)
            self._clock = None
        with self._lock:
            for w in self._workloads.values():
                if w.server is not None:
                    w.server.stop()

    # --- accounting ---------------------------------------------------------

    def summary(self) -> dict:
        """Meet-rate and energy per workload over ALL cycles (running
        accumulators — alloc_log only keeps the recent window).

        ``energy_mj`` is modelled (LUT points held per cycle);
        ``measured_energy_mj`` integrates the server's real batch
        wall-clock against the active slice's power model — the ROADMAP's
        measured per-tenant energy accounting (minimal version).

        The rows keep their historical shape but are READ BACK from the
        metrics registry (``self.metrics``) — the same numbers a
        Prometheus scrape of the registry exports.
        """
        out = {}
        m = self.metrics
        tenants_seen = {lbl.get("tenant")
                        for lbl in m.labels_of("arbiter_cycles_total")}
        with self._lock:
            # snapshot: register/unregister mutate the dict concurrently
            workloads = list(self._workloads.items())
        for name, w in workloads:
            exists = name in tenants_seen
            n = m.value("arbiter_cycles_total", tenant=name)
            if not exists or not n:
                row = {"cycles": 0}
            else:
                row = {"cycles": int(n),
                       "meet_rate": round(
                           m.value("arbiter_met_total", tenant=name) / n, 4),
                       "energy_mj": round(
                           m.value("arbiter_energy_mj_total", tenant=name),
                           2),
                       "mean_share": round(
                           m.value("arbiter_share_sum", tenant=name) / n, 4)}
            if exists:
                row["preemptions"] = int(
                    m.value("arbiter_preemptions_total", tenant=name))
            if w.server is not None:
                row["measured_energy_mj"] = round(
                    w.server.measured_energy_mj, 2)
                row["busy_s"] = round(w.server.busy_s, 4)
            if w.queue_depth or w.arrival_ewma:
                row["queue_depth"] = w.queue_depth
                row["arrival_ewma_rps"] = round(w.arrival_ewma, 2)
            if w.brownout_base_ms is not None:
                row["brownout"] = True
            if w.alert_pressure > 0.0:
                row["alert_pressure"] = round(w.alert_pressure, 3)
            if self.calibration is not None:
                row["power_scale"] = round(self._power_scale(name), 4)
            out[name] = row
        return out
