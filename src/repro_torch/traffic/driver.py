"""Open-loop SLO-classed load drivers over the resource arbiter.

Two drivers share the same classes/arrivals/report types:

* :func:`simulate` — a deterministic discrete-event driver in virtual
  time.  Service times come from each workload's arbitrated
  :class:`OpPoint` latency through a **batching-aware service model**
  (ROADMAP item): queued requests are served in batches of up to the
  class's ``max_batch``, and one batch of ``k`` requests costs the
  power-of-two *bucket* latency for ``k`` (``service_model="bucketed"``,
  mirroring the engine's bucketed data path) or the full pad-to-max
  latency regardless of occupancy (``service_model="padded"``, the
  baseline the benchmarks compare against).  The run exercises the REAL
  arbiter code (admission_check, water-filling, preempt, set_active with
  queue depth + arrival-rate EWMA) without touching a clock or a jit
  cache — policy comparisons are exactly reproducible from the arrival
  seeds.
* :func:`drive_live` — wall-clock submission of real requests to
  :class:`DynamicServer` instances behind a started arbiter
  (``launch/serve.py --trace``).

Policies:

* ``"slo"``  — admission control at registration, per-request shedding
  for SHED classes, and mid-cycle :meth:`ResourceArbiter.preempt` when a
  request arrives for a class holding no slice;
* ``"fifo"`` — the no-admission baseline: every class admitted at equal
  priority (arbitration ties break by registration = arrival order), no
  shedding, and arrivals wait for the next constraint-clock tick.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import queue
import time
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.obs import trace as obs
from repro_torch.obs.metrics import MetricsRegistry, quantile
from repro_torch.runtime.arbiter import (AdmissionError, GlobalConstraints,
                                   ResourceArbiter)
from repro_torch.runtime.engine import DynamicServer
from repro_torch.runtime.lut import LUT, bucket_for, bucket_latency_ms
from repro_torch.traffic import arrivals as arr
from repro_torch.traffic.slo import DEGRADE, SHED, SLOClass

SLO_POLICY = "slo"
FIFO_POLICY = "fifo"
POLICIES = (SLO_POLICY, FIFO_POLICY)

# service models for simulate(): how a batch of k queued requests is priced
BUCKETED_SERVICE = "bucketed"   # nearest power-of-two bucket latency
PADDED_SERVICE = "padded"       # always the full pad-to-max latency
SERVICE_MODELS = (BUCKETED_SERVICE, PADDED_SERVICE)


@dataclasses.dataclass
class ClassStats:
    """Per-class accounting: every submitted request ends in exactly one
    of rejected / dropped / failed / completed (+ pending if the sim is
    cut off)."""
    submitted: int = 0
    rejected: int = 0      # admission-rejected class
    dropped: int = 0       # shed on arrival (or unserved at horizon)
    failed: int = 0        # resolved with an error payload (node fail-stop)
    completed: int = 0
    good: int = 0          # completed within the deadline
    batches: int = 0       # serving batches dispatched (sim service model)
    batch_occupancy: int = 0   # requests summed over those batches
    retried: int = 0       # failed attempts re-submitted (reliability layer)
    hedge_wasted: int = 0  # hedge copies whose sibling answered first
    latencies_ms: List[float] = dataclasses.field(default_factory=list)

    @property
    def goodput(self) -> int:
        return self.good

    @property
    def mean_batch(self) -> float:
        """Mean serving-batch occupancy (0.0 when nothing was batched)."""
        return self.batch_occupancy / self.batches if self.batches else 0.0

    def p(self, q: float) -> float:
        return quantile(self.latencies_ms, q)

    def summary(self) -> dict:
        out = {"submitted": self.submitted, "rejected": self.rejected,
               "dropped": self.dropped, "failed": self.failed,
               "completed": self.completed,
               "goodput": self.good,
               "goodput_rate": round(self.good / self.submitted, 4)
               if self.submitted else 0.0,
               "mean_batch": round(self.mean_batch, 3)}
        if self.retried or self.hedge_wasted:
            out["retried"] = self.retried
            out["hedge_wasted"] = self.hedge_wasted
        for q in (50, 95, 99):
            # None (not NaN) when nothing completed: NaN != NaN breaks
            # report equality for deterministic-replay checks
            out[f"p{q}_ms"] = (round(self.p(q), 3)
                               if self.latencies_ms else None)
        return out


@dataclasses.dataclass
class TrafficReport:
    """What one driver run measured, per class + the arbiter's view."""
    policy: str
    classes: Dict[str, ClassStats]
    arbiter: dict = dataclasses.field(default_factory=dict)
    # retry-budget accounting when a reliability layer ran (else empty)
    reliability: dict = dataclasses.field(default_factory=dict)

    @property
    def total_goodput(self) -> int:
        return sum(s.good for s in self.classes.values())

    @property
    def total_dropped(self) -> int:
        return sum(s.dropped for s in self.classes.values())

    def summary(self) -> dict:
        out = {"policy": self.policy,
               "total_goodput": self.total_goodput,
               "total_dropped": self.total_dropped,
               "classes": {n: s.summary()
                           for n, s in self.classes.items()},
               "arbiter": self.arbiter}
        if self.reliability:
            out["reliability"] = self.reliability
        return out


def _register_classes(arbiter: ResourceArbiter, classes: Sequence[SLOClass],
                      luts: Dict[str, LUT], policy: str,
                      g0: GlobalConstraints,
                      servers: Optional[Dict[str, DynamicServer]] = None
                      ) -> Dict[str, bool]:
    """Admission phase.  Returns admitted[name]; under "slo", a class whose
    minimal share can never fit is rejected (REJECT/SHED) or re-admitted
    with its relaxed DEGRADE target; "fifo" admits everything at equal
    priority, in arrival order."""
    admitted: Dict[str, bool] = {}
    for c in classes:
        server = (servers or {}).get(c.name)
        if policy == FIFO_POLICY:
            arbiter.register(c.name, luts[c.name],
                             target_latency_ms=c.service_target_ms,
                             priority=0, server=server)
            admitted[c.name] = True
            continue
        try:
            arbiter.register(c.name, luts[c.name],
                             target_latency_ms=c.service_target_ms,
                             priority=c.priority,
                             min_accuracy=c.min_accuracy,
                             server=server, admission_under=g0)
            admitted[c.name] = True
        except AdmissionError:
            if c.drop_policy == DEGRADE:
                # never drop: serve best-effort against the relaxed target
                arbiter.register(c.name, luts[c.name],
                                 target_latency_ms=c.degraded_target_ms,
                                 priority=c.priority, server=server)
                admitted[c.name] = True
            else:
                admitted[c.name] = False
    return admitted


def _service_ms(full_ms: float, occupancy: int, max_batch: int,
                service_model: str, *, spec=None, calibration=None) -> float:
    """Cost of one serving batch of ``occupancy`` requests.

    The LUT point latency is the profiled pad-to-max (full batch) cost;
    the bucketed model pays only the nearest power-of-two bucket, the
    padded baseline always pays the full forward.  With a warmed
    :class:`repro_torch.runtime.telemetry.CalibrationStore` (and the point's
    ``spec`` to key it) the bucket cost is the MEASURED dispatch→ready
    EWMA blended over that analytic prior — a replayed trace then
    predicts with the numbers the live engine actually observed.
    """
    if service_model == PADDED_SERVICE:
        return full_ms
    return bucket_latency_ms(full_ms, bucket_for(occupancy, max_batch),
                             max_batch, calibration=calibration, spec=spec)


def simulate(classes: Sequence[SLOClass], luts: Dict[str, LUT],
             streams: Dict[str, Sequence[float]],
             g_fn: Callable[[float], GlobalConstraints], *,
             interval_s: float = 0.1, policy: str = SLO_POLICY,
             service_model: str = BUCKETED_SERVICE,
             max_drain_s: float = 120.0,
             calibration=None, tracer=None,
             metrics: Optional[MetricsRegistry] = None) -> TrafficReport:
    """Deterministic discrete-event run of a traffic trace.

    Virtual time advances in constraint-clock epochs of ``interval_s``.
    Each epoch: (1) idle classes release their slice and the arbiter
    re-water-fills, fed each class's queue depth + arrival-rate EWMA so
    surplus chips go to the most backlogged tenant; (2) the epoch's
    arrivals are admitted / shed / preempt-served in timestamp order;
    (3) each workload serves its queue in batches of up to its class's
    ``max_batch`` — one batch of ``k`` requests costs the bucket latency
    for ``k`` under ``service_model="bucketed"`` or the full pad-to-max
    latency under ``"padded"``.  A batch locks in the service time
    current when it starts.

    ``calibration`` (a warmed :class:`repro_torch.runtime.telemetry
    .CalibrationStore`, typically recorded by :func:`drive_live`) makes
    the replay CLOSED-LOOP: the arbiter water-fills on calibrated point
    latencies and measured tenant watts, and every batch is priced by
    the measured per-bucket EWMA instead of the analytic bucket model —
    so a recorded trace predicts the live system with measured numbers.

    ``tracer`` (a :class:`repro_torch.obs.Tracer` built on a virtual clock)
    records the SAME span schema the live engine emits — queue /
    collect / stack / dispatch / device / complete per request plus
    arbitrate/preempt decision spans — in virtual time; host-side
    stages are zero-width points (the service model folds them into
    ``device``).  ``metrics`` receives per-class completion counters.
    """
    assert policy in POLICIES, policy
    assert service_model in SERVICE_MODELS, service_model
    by_class = {c.name: c for c in classes}
    stats = {c.name: ClassStats() for c in classes}
    m = metrics if metrics is not None else MetricsRegistry()
    completed = {c.name: m.counter("traffic_completed_total", cls=c.name)
                 for c in classes}
    arbiter = ResourceArbiter(interval_s=interval_s,
                              calibration=calibration)
    admitted = _register_classes(arbiter, classes, luts, policy, g_fn(0.0))

    events = arr.merge({n: ts for n, ts in streams.items()})
    queues = {c.name: collections.deque() for c in classes}  # repro: allow-unbounded(per-class work queue, drained every epoch; depth IS the backlog signal)
    busy_until = {c.name: 0.0 for c in classes}
    arrived_epoch = {c.name: 0 for c in classes}   # arrivals last epoch
    last_arrival = events[-1][0] if events else 0.0

    def svc_of(allocs):
        # the granted OpPoint (not just its latency): the calibrated
        # service model needs the subnet spec to key the measured columns
        return {n: a.point for n, a in allocs.items()}

    ei = 0
    t = 0.0
    while True:
        backlog = any(queues.values()) or ei < len(events)
        in_flight = any(b > t for b in busy_until.values())
        if not backlog and not in_flight:
            break
        if t > last_arrival + max_drain_s:
            break   # safety: leftover queue flushed as dropped below
        g = g_fn(t)
        for name in queues:
            if admitted[name]:
                arbiter.set_active(
                    name, bool(queues[name]) or busy_until[name] > t,
                    queue_depth=len(queues[name]),
                    arrival_rate_rps=arrived_epoch[name] / interval_s)
            arrived_epoch[name] = 0
        allocs = arbiter.tick(g)
        svc = svc_of(allocs)
        if tracer is not None:
            tracer.decision(obs.ARBITRATE, t, t,
                            tenants=len(allocs),
                            granted=sum(a.chips for a in allocs.values()))
        t_next = t + interval_s

        while ei < len(events) and events[ei][0] < t_next:
            ta, name = events[ei]
            ei += 1
            c = by_class[name]
            st = stats[name]
            st.submitted += 1
            arrived_epoch[name] += 1
            if not admitted[name]:
                st.rejected += 1
                continue
            if policy == SLO_POLICY and svc.get(name) is None:
                # arrival for a class holding no slice: preempt NOW — the
                # eviction of lower-priority tenants must not wait for the
                # next constraint clock tick
                arbiter.preempt(name, g_fn(ta))
                allocs = arbiter.last_allocations()
                svc = svc_of(allocs)
                if tracer is not None:
                    tracer.decision(obs.PREEMPT, ta, ta, for_cls=name)
            if (policy == SLO_POLICY and c.drop_policy == SHED
                    and svc.get(name) is not None):
                # predicted completion: in-flight remainder, then the queue
                # plus this request drained in batches priced by the active
                # service model at the estimated occupancy (the arrival
                # JOINS a batch — don't double-count its service)
                q_len = len(queues[name])
                occ = min(q_len + 1, c.max_batch)
                batch_ms = _service_ms(svc[name].latency_ms, occ,
                                       c.max_batch, service_model,
                                       spec=svc[name].subnet,
                                       calibration=calibration)
                n_batches = math.ceil((q_len + 1) / c.max_batch)
                eta_ms = (max(0.0, busy_until[name] - ta) * 1e3
                          + n_batches * batch_ms)
                if eta_ms > c.deadline_ms:
                    st.dropped += 1   # predicted miss: shed on arrival
                    continue
            queues[name].append(ta)

        for name, q in queues.items():
            pt = svc.get(name)
            if pt is None:
                continue   # starved this epoch; queue waits
            c = by_class[name]
            st = stats[name]
            while q:
                # clamp to t: a leftover request from a starved epoch can
                # start no earlier than the tick that granted the slice
                start = max(q[0], busy_until[name], t)
                if start >= t_next:
                    break
                # batch everything already waiting at the start instant
                k = 0
                for ta in q:
                    if ta <= start and k < c.max_batch:
                        k += 1
                    else:
                        break
                k = max(k, 1)
                done = start + _service_ms(pt.latency_ms, k, c.max_batch,
                                           service_model, spec=pt.subnet,
                                           calibration=calibration) / 1e3
                busy_until[name] = done
                st.batches += 1
                st.batch_occupancy += k
                completed[name].inc(k)
                if tracer is not None:
                    dev_attrs = {
                        "bucket": bucket_for(k, c.max_batch), "n": k,
                        "subnet": (pt.subnet.name()
                                   if hasattr(pt.subnet, "name")
                                   else str(pt.subnet))}
                for _ in range(k):
                    ta = q.popleft()
                    lat_ms = (done - ta) * 1e3
                    st.completed += 1
                    st.latencies_ms.append(lat_ms)
                    if lat_ms <= c.deadline_ms:
                        st.good += 1
                    if tracer is not None:
                        # same schema as the live engine, virtual time;
                        # host-side stages are zero-width (the service
                        # model folds them into `device`)
                        tracer.request(name, ta, done, spans=[
                            (obs.QUEUE, ta, start, None),
                            (obs.COLLECT, start, start, None),
                            (obs.STACK, start, start, None),
                            (obs.DISPATCH, start, start, None),
                            (obs.DEVICE, start, done, dev_attrs),
                            (obs.COMPLETE, done, done, None)])
        t = t_next

    for name, q in queues.items():
        stats[name].dropped += len(q)   # never served within the horizon
        q.clear()
    return TrafficReport(policy=policy, classes=stats,
                         arbiter=arbiter.summary())


def _drain_reliable(pending, by_class, servers, make_input, stats,
                    reliability, t0: float, timeout_s: float):
    """Reliability-aware drain loop for :func:`drive_live`.

    Polls outstanding futures; a FAILED attempt (error payload from a
    fail-stopped node) is re-submitted through the cluster router after
    its class's backoff — but only while the policy's attempt cap, the
    cluster-wide retry budget, and the request's own deadline all still
    allow it (a retry that could not land before the SLO deadline is
    wasted work on a degraded cluster).  The retry's span tree links to
    the first failed attempt's trace_id.  Returns the final
    ``(name, future)`` list for the normal harvest loop — each arrival
    contributes exactly one terminal future, so the accounting invariant
    (submitted == rejected+dropped+failed+completed) is untouched.
    """
    budget = reliability.budget.fresh()
    # entry: [name, fut-or-None, t_sub, attempts, retry_at, first_tid]
    live = [[name, fut, t_sub, 1, 0.0, None]
            for name, fut, t_sub in pending]
    final: List = []
    completed_seen = 0
    deadline = time.perf_counter() + timeout_s
    while live and time.perf_counter() < deadline:
        nxt: List = []
        for entry in live:
            name, fut, t_sub, attempts, retry_at, first_tid = entry
            now = time.perf_counter() - t0
            if fut is None:               # parked for backoff
                if now < retry_at:
                    nxt.append(entry)
                    continue
                links = [first_tid] if first_tid is not None else []
                nf = (servers[name].submit(make_input(name), links=links)
                      if links else servers[name].submit(make_input(name)))
                nxt.append([name, nf, t_sub, attempts, 0.0, first_tid])
                continue
            if fut.empty():
                nxt.append(entry)
                continue
            out = fut.get()
            if out.get("cancelled") and out.get("failed"):
                pol = reliability.policy_for(name)
                c = by_class[name]
                t_retry = now + pol.backoff(attempts)
                if (attempts < pol.max_attempts
                        and t_retry <= t_sub + c.deadline_ms / 1e3
                        and budget.allow(completed_seen)):
                    stats[name].retried += 1
                    tid = getattr(fut, "trace_id", None)
                    nxt.append([name, None, t_sub, attempts + 1, t_retry,
                                first_tid if first_tid is not None else tid])
                    continue
            if not out.get("cancelled"):
                completed_seen += 1
            fut.put(out)                  # hand back to the harvest loop
            final.append((name, fut))
        live = nxt
        time.sleep(0.005)
    for name, fut, *_ in live:            # timed out mid-flight / parked
        if fut is None:
            fut = _dead_live_future("retry window expired")
        final.append((name, fut))
    return final, budget


def _dead_live_future(reason: str) -> "queue.Queue":
    fut: "queue.Queue" = queue.Queue(maxsize=1)
    fut.put({"y": None, "cancelled": True, "failed": True,
             "error": reason, "latency_ms": 0.0, "subnet": None})
    return fut


class _WatchtowerFeed:
    """Wall-clock feeder for :class:`repro_torch.obs.Watchtower` inside
    :func:`drive_live`: periodically sweeps the outstanding futures
    without consuming them (peek + put-back, the `_drain_reliable`
    idiom), classifies newly-resolved ones against their class deadline,
    feeds the watchtower one delta sample, evaluates, and forwards the
    per-class alert pressure to the arbiter/cluster — the live mirror
    of the simulator's per-epoch actuation hook."""

    def __init__(self, wt, arbiter, by_class, t0: float):
        self.wt = wt
        self.arbiter = arbiter
        self.by_class = by_class
        self.t0 = t0
        self.interval = max(0.05, min(w.short_s for w in wt.windows) / 2.0)
        self._seen: set = set()
        self._last = 0.0

    def sweep(self, pending, force: bool = False):
        now = time.perf_counter() - self.t0
        if not force and now - self._last < self.interval:
            return
        self._last = now
        delta = {cn: [0, 0] for cn in self.by_class}
        for i, (name, fut, _t_sub) in enumerate(pending):
            if i in self._seen or fut is None or fut.empty():
                continue
            try:
                out = fut.get_nowait()
            except Exception:   # raced with the harvest loop
                continue
            fut.put(out)
            self._seen.add(i)
            if out.get("cancelled"):
                good = 0
            else:
                good = int(out["latency_ms"]
                           <= self.by_class[name].deadline_ms)
            delta[name][0] += good
            delta[name][1] += 1 - good
        for cn, (g, b) in delta.items():
            if cn in self.wt.targets:
                self.wt.observe(now, cn, good=g, bad=b)
        self.wt.evaluate(now)
        if self.wt.actuate and hasattr(self.arbiter, "set_alert_pressure"):
            for cn in self.wt.targets:
                self.arbiter.set_alert_pressure(cn, self.wt.pressure(cn))


def drive_live(classes: Sequence[SLOClass],
               servers: Dict[str, DynamicServer],
               arbiter: ResourceArbiter,
               streams: Dict[str, Sequence[float]],
               make_input: Callable[[str], object], *,
               g_fn: Callable[[], GlobalConstraints],
               speed: float = 1.0, timeout_s: float = 120.0,
               record_path: Optional[str] = None, tracer=None,
               reliability=None, watchtower=None,
               metrics: Optional[MetricsRegistry] = None,
               sink: Optional[list] = None) -> TrafficReport:
    """Wall-clock open-loop driver: real requests to real servers.

    Classes must already be registered on ``arbiter`` with their servers
    (see ``_register_classes`` / ``launch.serve --trace``).  ``speed`` > 1
    compresses the arrival schedule; deadlines stay in real ms.  The
    arbiter clock runs for the duration and is stopped (draining the
    servers) before the report is built, so every future resolves.

    ``arbiter``/``servers`` may equally be a
    :class:`repro_torch.cluster.Cluster` and its class ports — the duck
    interface is start/stop/summary and per-class ``.submit``.

    ``record_path`` writes the ACTUAL per-class submission times (not the
    planned schedule — sleep overshoot and submit cost shift them) as a
    multi-stream schedule JSON, so a real run becomes a regression trace:
    ``load_schedule`` feeds it back to :func:`simulate` (bit-identical
    replay) or ``launch.serve --trace <file>``.

    ``sink``, when given, receives ``(class, payload)`` for every answered
    request (the served outputs, for callers that check them).

    ``reliability`` (a :class:`repro_torch.chaos.Reliability`) turns on
    the retry layer: failed attempts (fail-stopped replicas, chaos kills)
    are re-routed through the cluster with per-class backoff, capped by
    the policy's attempt limit, the cluster-wide retry budget, and the
    request's own deadline; retries count in ``ClassStats.retried`` and
    their span trees link to the first attempt.  (Hedging is a
    virtual-time feature — see
    :func:`repro_torch.cluster.sim.simulate_cluster`.)

    ``watchtower`` (a :class:`repro_torch.obs.Watchtower`) runs the SLO
    burn monitors against the live outcomes as they resolve: resolved
    futures are classified against their class deadline, fed as delta
    samples on the wall clock, and — when the watchtower actuates — the
    per-class alert pressure is forwarded to
    ``arbiter.set_alert_pressure`` (a plain arbiter or a
    :class:`repro_torch.cluster.Cluster` alike).  The same instance fed by
    the simulator fires the same alerts.
    """
    by_class = {c.name: c for c in classes}
    stats = {c.name: ClassStats() for c in classes}
    if tracer is not None or metrics is not None:
        # wire observability down the stack: the engines emit the request
        # span trees themselves, the arbiter its arbitrate/preempt spans
        if tracer is not None and hasattr(arbiter, "tracer"):
            arbiter.tracer = tracer
        for server in servers.values():
            if tracer is not None:
                server.tracer = tracer
            if metrics is not None:
                server.metrics = metrics
    events = arr.merge({n: ts for n, ts in streams.items()})
    pending: List = []
    recorded: Dict[str, List[float]] = {c.name: [] for c in classes}
    arbiter.start(g_fn)
    try:
        t0 = time.perf_counter()
        feed = (_WatchtowerFeed(watchtower, arbiter, by_class, t0)
                if watchtower is not None else None)
        for ta, name in events:
            wait = ta / speed - (time.perf_counter() - t0)
            if wait > 0:
                time.sleep(wait)
            now = time.perf_counter() - t0
            recorded[name].append(now)
            pending.append((name, servers[name].submit(make_input(name)),
                            now))
            if feed is not None:
                feed.sweep(pending)
        rel_info: dict = {}
        if reliability is not None:
            pending, budget = _drain_reliable(
                pending, by_class, servers, make_input, stats,
                reliability, t0, timeout_s)
            pending = [(name, fut, 0.0) for name, fut in pending]
            rel_info = {"retry_granted": budget.granted,
                        "retry_denied": budget.denied}
        else:
            # wait for the fleet to drain; a starved server's requests may
            # never run — arbiter.stop() below cancels them so no get()
            # hangs
            deadline = time.perf_counter() + timeout_s
            while (time.perf_counter() < deadline
                   and any(fut.empty() for _, fut, _ in pending)):
                if feed is not None:
                    feed.sweep(pending)
                time.sleep(0.02)
        if feed is not None:
            # terminal sample: whatever resolved since the last sweep
            feed.sweep(pending, force=True)
    finally:
        arbiter.stop()
    if record_path is not None:
        arr.save_schedule(record_path, recorded,
                          meta={"kind": "drive_live", "speed": speed,
                                "classes": [c.name for c in classes]})
    for name, fut, _ in pending:
        st = stats[name]
        st.submitted += 1
        try:
            out = fut.get(timeout=5.0)
        except Exception:   # still in flight past the drain: count it lost
            st.dropped += 1
            continue
        if out.get("cancelled"):
            # a fail-stopped node's error payloads are failures, not load
            # shedding — same split the cluster simulator reports
            if out.get("failed"):
                st.failed += 1
            else:
                st.dropped += 1
            continue
        if sink is not None:
            sink.append((name, out))
        lat = out["latency_ms"]
        st.completed += 1
        st.latencies_ms.append(lat)
        if lat <= by_class[name].deadline_ms:
            st.good += 1
    return TrafficReport(policy="live", classes=stats,
                         arbiter=arbiter.summary(), reliability=rel_info)
