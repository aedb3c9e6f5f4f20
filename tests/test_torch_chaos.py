"""The port's chaos layer (``repro_torch.chaos``) against the JAX package's
on the CPU.

* virtual time: injections, seeded ``generate`` scenarios, the
  ``ChaosTimeline`` overlays and event streams, and ``simulate_cluster``
  with chaos, bare and under a ``Reliability`` layer (retries, budget,
  deadline, hedging, brownout, make-before-break), run through both
  packages on the same seeds and must be equal (``==``) under the ``v5e``
  fixture;
* live: a ``ChaosController`` replaying a scenario against the port's
  ``Cluster`` of small port ViT servers on the CPU, the retry drain loop,
  and ``drive_live`` with ``reliability=`` and ``watchtower=`` over a
  cluster whose node is wedged mid-stream.

Each test also holds the port to the reference test's own property
(``tests/test_chaos.py``).
"""
import dataclasses
import queue
import time

import pytest

from _torch_cluster import (JO, JX, PC, PO, PT, PX, P, X,  # noqa: F401
                            both, live_lut, make_lut, make_nodes,
                            tiny_server, two_nodes, v5e)
from repro_torch.chaos import engine as ce
from repro_torch.obs.analyze import check_trace


def invariant(report):
    for st in report.classes.values():
        assert st.submitted == (st.rejected + st.dropped + st.failed
                                + st.completed)


def rep_sig(rep):
    return (rep.summary(), list(rep.decisions),
            [dataclasses.astuple(a) for a in rep.alerts])


# --- scenario vocabulary -----------------------------------------------------

def test_injection_validation():
    with pytest.raises(ValueError):
        PX.Injection(t=0.0, kind="meteor", node="n0")
    with pytest.raises(ValueError):
        PX.Injection(t=0.0, kind=PX.RACK_FAIL)
    with pytest.raises(ValueError):
        PX.Injection(t=0.0, kind=PX.STRAGGLER)
    inj = PX.Injection(t=1.0, kind=PX.RACK_FAIL, nodes=("n0", "n1"))
    assert inj.targets() == ("n0", "n1")
    assert PX.Injection(t=0.0, kind=PX.WEDGE, node="n2").targets() == \
        ("n2",)
    assert PX.KINDS == JX.KINDS and PX.DEFAULT_LADDER == JX.DEFAULT_LADDER


def test_scenario_sorts_and_summarises():
    ref, port = both(lambda k: k.X.Scenario(name="s", injections=(
        k.X.Injection(t=2.0, kind=k.X.FAIL_STOP, node="n1"),
        k.X.Injection(t=1.0, kind=k.X.RACK_FAIL, nodes=("n0", "n2")))))
    assert dataclasses.astuple(port) == dataclasses.astuple(ref)
    assert port.summary() == ref.summary() == [
        (1.0, PX.RACK_FAIL, "n0"), (1.0, PX.RACK_FAIL, "n2"),
        (2.0, PX.FAIL_STOP, "n1")]


@pytest.mark.parametrize("seed", [5, 11, 12])
def test_generate_equals_reference(seed):
    names = ["n0", "n1", "n2"]
    ref, port = both(lambda k: k.X.generate(
        seed, 10.0, names, racks={"r0": ["n0", "n1"]}, n_faults=6))
    assert dataclasses.astuple(port) == dataclasses.astuple(ref)
    assert port == PX.generate(seed, 10.0, names, racks={"r0": ["n0", "n1"]},
                               n_faults=6)
    assert all(inj.kind in PX.KINDS for inj in port.injections)


def test_generate_differs_across_seeds():
    a = PX.generate(11, 10.0, ["n0", "n1"], n_faults=6)
    assert a != PX.generate(12, 10.0, ["n0", "n1"], n_faults=6)


# --- timeline compilation ----------------------------------------------------

def test_timeline_rejects_unknown_nodes():
    sc = PX.Scenario(injections=(PX.Injection(t=0.0, kind=PX.WEDGE,
                                              node="ghost"),))
    with pytest.raises(ValueError):
        PX.ChaosTimeline(sc, ["n0", "n1"])


def test_straggler_partition_and_thermal_overlays():
    def run(k):
        X = k.X
        sc = X.Scenario(injections=(
            X.Injection(t=1.0, kind=X.STRAGGLER, node="n0", factor=2.0,
                        duration_s=2.0),
            X.Injection(t=2.0, kind=X.STRAGGLER, node="n0", factor=3.0,
                        duration_s=2.0),
            X.Injection(t=1.0, kind=X.PARTITION, node="n1", duration_s=1.0),
            X.Injection(t=0.0, kind=X.THERMAL, node="n1", duration_s=4.0)))
        tl = X.ChaosTimeline(sc, ["n0", "n1"])
        ts = [0.0, 0.5, 1.0, 1.5, 2.0, 2.5, 3.5, 4.0, 4.5]
        return ([tl.latency_mult("n0", t) for t in ts],
                [tl.partitioned("n1", t) for t in ts],
                [tl.throttle("n1", t) for t in ts], tl.events())
    ref, port = both(run)
    assert port == ref
    mult, part, thr, _ = port
    assert mult == [1.0, 1.0, 2.0, 2.0, 6.0, 6.0, 3.0, 1.0, 1.0]
    assert part == [False, False, True, True] + [False] * 5
    assert thr[1:8:2] == [0.875, 0.75, 0.625, 1.0]


def test_lifecycle_expansion():
    def run(k):
        X, e = k.X, k.X.engine
        tl = X.ChaosTimeline(X.Scenario(injections=(
            X.Injection(t=1.0, kind=X.RACK_FAIL, nodes=("n0", "n1")),
            X.Injection(t=2.0, kind=X.SPOT_PREEMPT, node="n2", notice_s=0.5),
            X.Injection(t=3.0, kind=X.WEDGE, node="n0"))),
            ["n0", "n1", "n2"])
        evs = X.ChaosTimeline(X.Scenario(injections=(
            X.Injection(t=0.0, kind=X.STRAGGLER, node="n0", factor=2.0,
                        duration_s=1.0),
            X.Injection(t=0.0, kind=X.THERMAL, node="n0", duration_s=2.0),)),
            ["n0"]).events()
        return tl.lifecycle(), evs, (e.FAIL, e.DRAIN, e.WEDGE_ON)
    ref, port = both(run)
    assert port == ref
    life, evs, _ = port
    assert life == [(1.0, ce.FAIL, "n0"), (1.0, ce.FAIL, "n1"),
                    (2.0, ce.DRAIN, "n2"), (2.5, ce.FAIL, "n2"),
                    (3.0, ce.WEDGE_ON, "n0")]
    actions = [a for _, a, _, _ in evs]
    assert evs == sorted(evs)
    assert actions.count(ce.THROTTLE) == len(PX.DEFAULT_LADDER) + 1
    assert ce.STRAGGLE_OFF in actions


def test_node_chaos_overlay_on_constraints():
    node = make_nodes(P, [64])[0]
    assert node.g(0.0).total_chips == 64
    node.chaos_throttle = node.chaos_capacity = 0.5
    g = node.g(0.0)
    assert g.total_chips == 32 and g.temperature_throttle == 0.5
    node.chaos_throttle = node.chaos_capacity = 1.0
    assert node.g(0.0).total_chips == 64


# --- sim: chaos with and without the reliability layer -----------------------

def run_sim(k, chaos=None, reliability=None, caps=(64, 64), rate=300.0,
            horizon=3.0, seed=1, **kw):
    cls = [k.T.SLOClass("api", deadline_ms=800.0, priority=2,
                        drop_policy=k.T.SHED)]
    return k.C.simulate_cluster(cls, {"api": make_lut(k)},
                                {"api": k.T.poisson(rate, horizon,
                                                    seed=seed)},
                                make_nodes(k, list(caps)), router=k.C.P2C,
                                chaos=chaos, reliability=reliability, **kw)


def fail_n0(k):
    return k.X.Scenario(injections=(
        k.X.Injection(t=1.0, kind=k.X.FAIL_STOP, node="n0"),))


def rel(k, **kw):
    X = k.X
    budget = kw.pop("budget", None)
    return X.Reliability(
        default=X.RetryPolicy(**kw),
        budget=(X.RetryBudget(**budget) if budget is not None
                else X.RetryBudget()),
        brownout=None)


def _retry_recovers(k):
    return run_sim(k, chaos=fail_n0(k), reliability=rel(
        k, max_attempts=3, backoff_s=0.05,
        budget=dict(burst=1000, fraction=1.0)))


def _check_retry_recovers(port):
    off = run_sim(P, chaos=fail_n0(P))
    assert off.total_failed > 0
    assert port.classes["api"].retried > 0
    assert port.retry_granted == sum(s.retried
                                     for s in port.classes.values())
    assert port.total_failed < off.total_failed


def _check_deadline(port):
    assert port.retry_denied["deadline"] > 0
    assert port.classes["api"].retried == 0 and port.retry_granted == 0


def _check_budget(port):
    assert port.retry_denied["budget"] > 0
    assert port.classes["api"].retried == 0 and port.retry_granted == 0


def _hedged(k):
    return run_sim(k, rate=200.0, reliability=k.X.Reliability(
        policies={"api": k.X.RetryPolicy(hedge=True)}, brownout=None))


def _check_hedged(port):
    st = port.classes["api"]
    assert st.hedge_wasted > 0 and st.completed <= st.submitted
    plain = run_sim(P, rate=200.0)
    assert st.completed >= plain.classes["api"].completed - 1


def _brownout(k):
    X = k.X
    sc = X.Scenario(injections=(
        X.Injection(t=1.0, kind=X.PARTITION, node="n0", duration_s=1.0),
        X.Injection(t=1.0, kind=X.PARTITION, node="n1", duration_s=1.0)))
    return run_sim(k, chaos=sc, rate=200.0, horizon=4.0,
                   reliability=X.Reliability(
                       default=X.RetryPolicy(max_attempts=2, backoff_s=0.05),
                       budget=X.RetryBudget(burst=10000, fraction=1.0),
                       brownout=X.BrownoutPolicy()))


def _check_brownout(port):
    directions = [d for _, _, d in port.brownouts]
    assert "enter" in directions and "exit" in directions
    assert directions.index("enter") < directions.index("exit")
    ts = [t for t, _, _ in port.brownouts]
    assert ts == sorted(ts)


def _generated(k):
    sc = k.X.generate(5, 2.5, ["n0", "n1", "n2"],
                      racks={"r0": ["n1", "n2"]}, n_faults=5)
    return run_sim(k, chaos=sc, reliability=k.X.Reliability(),
                   caps=(64, 64, 64))


def _check_generated(port):
    sc = PX.generate(5, 2.5, ["n0", "n1", "n2"],
                     racks={"r0": ["n1", "n2"]}, n_faults=5)
    assert port.injections == sorted(sc.summary())


def _make_before_break(k):
    nodes = [k.C.ClusterNode(name="n0", g_fn=lambda t: k.R.GlobalConstraints(
                 total_chips=128 if t < 0.9 else 2)),
             k.C.ClusterNode(name="n1", g_fn=lambda t: k.R.GlobalConstraints(
                 total_chips=256))]
    cls = [k.T.SLOClass("api", deadline_ms=2000.0, priority=2,
                        drop_policy=k.T.DEGRADE)]
    return k.C.simulate_cluster(
        cls, {"api": make_lut(k)}, {"api": k.T.poisson(400.0, 3.0, seed=2)},
        nodes, router=k.C.P2C, placement_mode=k.C.FIRST_FIT, replicas=1,
        rebalance_at=[1.0], hysteresis=0.0)


def _check_make_before_break(port):
    assert [m for m in port.migrations if m[1] == "api"
            and m[2] is not None and m[3] is not None]
    st = port.classes["api"]
    assert st.dropped == 0 and st.completed == st.submitted


CHAOS_SIMS = {
    "fail_stop_bare": (lambda k: run_sim(k, chaos=fail_n0(k)),
                       lambda p: p.injections == [(1.0, PX.FAIL_STOP, "n0")]),
    "generated_reliability": (_generated, _check_generated),
    "retry_recovers": (_retry_recovers, _check_retry_recovers),
    "retry_past_deadline": (
        lambda k: run_sim(k, chaos=fail_n0(k), reliability=rel(
            k, max_attempts=3, backoff_s=10.0)), _check_deadline),
    "retry_budget": (
        lambda k: run_sim(k, chaos=fail_n0(k), reliability=rel(
            k, max_attempts=3, backoff_s=0.05,
            budget=dict(burst=0, fraction=0.0))), _check_budget),
    "hedged": (_hedged, _check_hedged),
    "brownout": (_brownout, _check_brownout),
    "make_before_break": (_make_before_break, _check_make_before_break),
}


@pytest.mark.parametrize("case", sorted(CHAOS_SIMS))
def test_chaos_sim_equals_reference(case):
    build, check = CHAOS_SIMS[case]
    ref, port = both(build)
    assert rep_sig(port) == rep_sig(ref)
    assert rep_sig(build(P)) == rep_sig(port)          # deterministic
    invariant(port)
    assert check(port) is not False


def test_chaos_fail_stop_matches_fail_at_scripting():
    a = run_sim(P, chaos=fail_n0(P))
    b = run_sim(P, fail_at={"n0": 1.0})
    assert a.decisions == b.decisions
    assert {n: s.summary() for n, s in a.classes.items()} == \
           {n: s.summary() for n, s in b.classes.items()}
    assert b.injections == []


def test_retry_span_links_equal_reference_and_export():
    def run(k):
        tracer = k.O.Tracer()
        r = run_sim(k, chaos=fail_n0(k), tracer=tracer, reliability=rel(
            k, max_attempts=3, backoff_s=0.05,
            budget=dict(burst=1000, fraction=1.0)))
        return r, tracer
    (jr, jt), (pr, pt) = both(run)
    sig = lambda tr: [(t.trace_id, t.cls, t.t0, t.t1, tuple(t.links))
                      for t in tr.requests()]
    assert sig(pt) == sig(jt)
    assert pr.classes["api"].retried > 0
    linked = [tr for tr in pt.requests() if tr.links]
    by_id = {tr.trace_id: tr for tr in pt.requests()}
    assert linked
    for tr in linked:
        for rid in tr.links:
            assert by_id[rid].cls == tr.cls
            assert by_id[rid].t1 <= tr.t0 + 1e-9
    check_trace(linked[0])
    doc = PO.to_chrome_trace(pt)
    assert doc["traceEvents"] == JO.to_chrome_trace(jt)["traceEvents"]
    ids = {tr.trace_id for tr in linked}
    ev_links = [e["args"]["links"] for e in doc["traceEvents"]
                if e.get("args", {}).get("trace_id") in ids]
    assert ev_links and all(ev_links)


# --- live: ChaosController + the retry drain loop ----------------------------

def test_live_chaos_controller_replays_scenario():
    cluster = two_nodes()
    cluster.register("api", live_lut(), target_latency_ms=500.0,
                     priority=1, make_server=tiny_server)
    sc = PX.Scenario(name="live-day", injections=(
        PX.Injection(t=0.0, kind=PX.STRAGGLER, node="n0", factor=2.0,
                     duration_s=0.2),
        PX.Injection(t=0.05, kind=PX.PARTITION, node="n0", duration_s=0.1),
        PX.Injection(t=0.3, kind=PX.FAIL_STOP, node="n0")))
    cluster.start()
    try:
        ctl = PX.ChaosController(cluster, sc).start()
        deadline = time.perf_counter() + 10.0
        while not ctl.done and time.perf_counter() < deadline:
            time.sleep(0.02)
        assert ctl.done
        assert [a for _, a, _ in ctl.applied] == \
               [a for _, a, _, _ in ctl.timeline.events()]
        assert cluster.nodes["n0"].state == PC.DEAD
        assert cluster.nodes["n0"].chaos_capacity == 1.0
        assert cluster.router.weights == {}          # partition healed
        outs = [cluster.submit("api", X).get(timeout=30) for _ in range(4)]
        assert all(not o.get("cancelled") for o in outs)
        assert cluster.metrics.value("chaos_injections_total",
                                     kind=ce.FAIL) == 1
    finally:
        cluster.stop()


class _FakeServer:
    """submit() succeeds immediately; records the span links passed."""

    def __init__(self):
        self.links_seen = []

    def submit(self, x, links=()):
        self.links_seen.append(list(links))
        fut = queue.Queue(maxsize=1)
        fut.put({"y": 1, "cancelled": False, "failed": False,
                 "latency_ms": 1.0, "subnet": None})
        fut.trace_id = 99
        return fut


def _failed_fut(trace_id=7):
    fut = queue.Queue(maxsize=1)
    fut.put({"y": None, "cancelled": True, "failed": True,
             "error": "node failed", "latency_ms": 0.0, "subnet": None})
    fut.trace_id = trace_id
    return fut


@pytest.mark.parametrize("backoff_s,deadline_ms,retried",
                         [(0.01, 5000.0, 1), (10.0, 100.0, 0)],
                         ids=["retries_with_links", "respects_deadline"])
def test_drain_reliable(backoff_s, deadline_ms, retried):
    from repro_torch.traffic.driver import ClassStats, _drain_reliable
    srv = _FakeServer()
    stats = {"api": ClassStats()}
    r = PX.Reliability(default=PX.RetryPolicy(max_attempts=3,
                                              backoff_s=backoff_s),
                       brownout=None)
    final, budget = _drain_reliable(
        [("api", _failed_fut(trace_id=7), 0.0)],
        {"api": PT.SLOClass("api", deadline_ms=deadline_ms, priority=2)},
        {"api": srv}, lambda n: None, stats, r, time.perf_counter(),
        timeout_s=5.0)
    assert stats["api"].retried == budget.granted == retried
    assert len(final) == 1
    out = final[0][1].get()
    if retried:
        assert srv.links_seen == [[7]] and not out.get("cancelled")
    else:
        assert srv.links_seen == [] and out["cancelled"] and out["failed"]


def test_drive_live_cluster_with_reliability_and_watchtower():
    """A wedged node under live traffic: the health check fails it over,
    its stuck requests are retried through the router onto the survivor,
    every future resolves, and the watchtower (fed on the wall clock)
    sees every outcome."""
    tracer = PO.Tracer()
    cluster = two_nodes(health_interval_s=0.05, health_epochs=3,
                        tracer=tracer)
    classes = [PT.SLOClass("api", deadline_ms=4000.0, priority=2)]
    cluster.register("api", live_lut(), target_latency_ms=500.0,
                     priority=2, make_server=tiny_server)
    sc = PX.Scenario(name="wedge", injections=(
        PX.Injection(t=0.3, kind=PX.WEDGE, node="n1"),))
    wt = PO.Watchtower({"api": 0.99}, tracer=tracer,
                       windows=(PO.BurnWindow(PO.FAST, 0.3, 0.6, 1.0,
                                              PO.PAGE),))
    streams = {"api": list(PT.poisson(40.0, 1.0, seed=0))}
    reliab = PX.Reliability(default=PX.RetryPolicy(max_attempts=3,
                                                   backoff_s=0.02),
                            budget=PX.RetryBudget(burst=100), brownout=None)
    ctl = PX.ChaosController(cluster, sc)
    ctl.start()
    rep = PT.drive_live(classes, cluster.ports(), cluster, streams,
                        lambda n: X,
                        g_fn=lambda: PR.GlobalConstraints(total_chips=2),
                        timeout_s=30.0, reliability=reliab, watchtower=wt)
    ctl.stop()
    ctl.join()
    st = rep.classes["api"]
    assert st.submitted == len(streams["api"])
    assert st.submitted == st.rejected + st.dropped + st.failed + \
        st.completed
    assert cluster.nodes["n1"].state == PC.DEAD
    assert "n1" in rep.arbiter["health_failed"]
    assert st.retried > 0 and rep.reliability["retry_granted"] == st.retried
    assert st.completed > 0
    outcomes = wt._good["api"][-1] + wt._bad["api"][-1]
    assert outcomes == st.submitted
    assert [a for _, a, _ in ctl.applied] == [ce.WEDGE_ON]
