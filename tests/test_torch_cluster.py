"""The port's cluster layer (``repro_torch.cluster``) against the JAX
package's on the CPU.

* virtual time: router picks, cluster admission and headroom, and
  ``simulate_cluster`` reports (routing, failover, drain, the silent
  ``wedge_at`` failure under the stall health check) run through both
  packages on the same seeds and must be equal (``==``), under the
  ``v5e`` fixture that sets the port's H100 constants to the reference's;
* live: the port's ``Cluster`` over small port ViT servers on the CPU —
  routing, drain, fail-stop, the health check failing over a wedged node,
  the engine's ``wedge``/``unwedge`` and span links, and the serve
  launcher's cluster mode with every artefact.

Each test also holds the port to the reference test's own property
(``tests/test_cluster.py``).
"""
import dataclasses
import json
import time

import pytest

from _torch_cluster import (JC, PC, PKGS, PR, PT, X, P,  # noqa: F401
                            both, live_lut, make_lut, make_nodes,
                            tiny_server, two_nodes, v5e)


def rep_sig(rep):
    return (rep.summary(), list(rep.decisions))


# --- router ------------------------------------------------------------------

def test_round_robin_cycles():
    ref, port = both(lambda k: [
        n.name for n in (lambda r, ns: [r.pick("a", ns) for _ in range(6)])(
            k.C.ClusterRouter(k.C.ROUND_ROBIN), make_nodes(k, [64] * 3))])
    assert port == ref == ["n0", "n1", "n2", "n0", "n1", "n2"]


def test_least_loaded_follows_signal():
    def run(k):
        nodes = make_nodes(k, [64, 64])
        nodes[0].arbiter.register("a", make_lut(k), target_latency_ms=40.0)
        nodes[0].arbiter.set_active("a", True, queue_depth=10)
        nodes[1].arbiter.register("a", make_lut(k), target_latency_ms=40.0)
        r = k.C.ClusterRouter(k.C.LEAST_LOADED)
        first = r.pick("a", nodes).name
        big = make_nodes(k, [256])[0]
        big.name = "big"
        big.arbiter.register("a", make_lut(k), target_latency_ms=40.0)
        big.arbiter.set_active("a", True, queue_depth=10)
        return first, r.pick("a", [nodes[0], big]).name
    ref, port = both(run)
    assert port == ref == ("n1", "big")


def test_p2c_is_seed_deterministic_and_skips_unroutable():
    def run(k):
        nodes = make_nodes(k, [64, 64, 64])
        a = k.C.ClusterRouter(k.C.P2C, seed=7)
        picks = [a.pick("x", nodes).name for _ in range(32)]
        nodes[0].state = k.C.DEAD
        after = [a.pick("x", nodes).name for _ in range(8)]
        return picks, after, a.pick("x", [])
    ref, port = both(run)
    assert port == ref
    picks, after, none = port
    assert picks == run(P)[0] and len(set(picks)) > 1
    assert set(after) <= {"n1", "n2"} and none is None


def test_router_rejects_unknown_policy():
    with pytest.raises(ValueError):
        PC.ClusterRouter("random")


# --- cluster admission -------------------------------------------------------

def test_admission_needs_one_fitting_node():
    for k in PKGS:
        with pytest.raises(k.R.AdmissionError):
            k.C.cluster_admission(make_nodes(k, [64, 64]), make_lut(k),
                                  10.0, priority=2)
    ref, port = both(lambda k: k.C.cluster_admission(
        make_nodes(k, [64, 64, 256]), make_lut(k), 10.0, priority=2))
    assert port == ref == ["n2"]


def test_admission_skips_unroutable_nodes():
    nodes = make_nodes(P, [256, 64])
    nodes[0].state = PC.DEAD
    with pytest.raises(PR.AdmissionError):
        PC.cluster_admission(nodes, make_lut(P), 10.0, priority=2)


def test_cluster_headroom_sums_routable_and_shrinks_with_tenants():
    def run(k):
        nodes = make_nodes(k, [64, 64])
        out = [dataclasses.astuple(k.C.cluster_headroom(nodes))]
        nodes[1].state = k.C.DEAD
        out.append(dataclasses.astuple(k.C.cluster_headroom(nodes)))
        node = make_nodes(k, [256])[0]
        free = node.headroom().chips
        node.arbiter.register("a", make_lut(k), target_latency_ms=40.0)
        return out, free, node.headroom().chips
    ref, port = both(run)
    assert port == ref
    (idle, one), free, taken = port
    assert idle[0] == 128 and one[0] == 64 and taken < free


# --- simulate_cluster: scaling, routing, lifecycle, health -------------------

def sim(k, caps, router=None, rate=1000.0, seed=1, **kw):
    cls = [k.T.SLOClass("api", deadline_ms=200.0, priority=2,
                        drop_policy=k.T.SHED)]
    return k.C.simulate_cluster(cls, {"api": make_lut(k)},
                                {"api": k.T.poisson(rate, 4.0, seed=seed)},
                                make_nodes(k, caps),
                                router=router or k.C.P2C, **kw)


def _check_plain(rep):
    s = rep.classes["api"]
    assert s.submitted == s.rejected + s.dropped + s.failed + s.completed


def _check_failover(rep):
    _check_plain(rep)
    assert rep.classes["api"].failed > 0
    assert rep.nodes["n1"]["state"] == PC.DEAD
    assert rep.routed["api"]["n1"] < rep.routed["api"]["n0"]


def _check_drain(rep):
    s = rep.classes["api"]
    assert s.failed == 0
    assert s.submitted == s.rejected + s.dropped + s.completed
    assert rep.nodes["n1"]["state"] == PC.DRAINED
    assert "api" not in rep.nodes["n1"]["arbiter"]


def _check_wedge(rep):
    assert rep.health_failed, rep.summary()
    t_fail, nn = rep.health_failed[0]
    assert nn == "n1" and t_fail <= 2.0 + 0.1 * (3 + 1) + 1e-9
    assert rep.nodes["n1"]["state"] == PC.DEAD
    _check_plain(rep)
    assert rep.classes["api"].failed > 0
    assert rep.routed["api"]["n0"] > rep.routed["api"]["n1"]


def _check_overloaded_healthy(rep):
    assert not rep.health_failed
    assert rep.nodes["n0"]["state"] != PC.DEAD


SIM_CASES = {
    "three_nodes": (dict(caps=[64, 64, 64]), _check_plain),
    "failover": (dict(caps=[64, 64], fail_at={"n1": 2.0}), _check_failover),
    "drain": (dict(caps=[64, 64], drain_at={"n1": 2.0}), _check_drain),
    "wedge_health": (dict(caps=[64, 64], round_robin=True,
                          wedge_at={"n1": 2.0}, health_epochs=3),
                     _check_wedge),
    "overloaded_health": (dict(caps=[64], health_epochs=3),
                          _check_overloaded_healthy),
}


@pytest.mark.parametrize("case", sorted(SIM_CASES))
def test_sim_report_equals_reference(case):
    """The same seeded trace through both simulators: identical routing
    decisions and ClusterReport summaries; the port's run again is
    identical too (determinism)."""
    kw, check = SIM_CASES[case]
    kw = dict(kw)
    rr = kw.pop("round_robin", False)
    ref, port = both(lambda k: sim(
        k, router=k.C.ROUND_ROBIN if rr else None, **kw))
    again = sim(P, router=PC.ROUND_ROBIN if rr else None, **kw)
    assert rep_sig(port) == rep_sig(ref) == rep_sig(again)
    check(port)


def test_two_nodes_scale_goodput():
    g1 = sim(P, [64]).classes["api"].good
    g2 = sim(P, [64, 64]).classes["api"].good
    assert g2 >= 1.7 * g1


def test_p2c_beats_round_robin_under_skew():
    def run(k):
        cls = [k.T.SLOClass("web", deadline_ms=200.0, priority=2,
                            drop_policy=k.T.DEGRADE)]
        stream = k.T.poisson(1000.0, 4.0, seed=2)
        return {r: k.C.simulate_cluster(cls, {"web": make_lut(k)},
                                        {"web": list(stream)},
                                        make_nodes(k, [256, 64]), router=r)
                for r in (k.C.P2C, k.C.ROUND_ROBIN)}
    ref, port = both(run)
    for r in port:
        assert rep_sig(port[r]) == rep_sig(ref[r])
    p2c, rr = port[PC.P2C], port[PC.ROUND_ROBIN]
    assert p2c.classes["web"].p(95) <= rr.classes["web"].p(95)
    assert p2c.routed["web"]["n1"] < rr.routed["web"]["n1"]


@pytest.mark.parametrize("case", ["rejected", "unplaceable", "readmits"])
def test_sim_admission_and_orphans_equal_reference(case):
    def run(k):
        if case == "rejected":
            cls = [k.T.SLOClass("rt", deadline_ms=2.0, priority=1,
                                drop_policy=k.T.SHED)]
            return k.C.simulate_cluster(
                cls, {"rt": make_lut(k)},
                {"rt": k.T.poisson(50.0, 2.0, seed=3)}, make_nodes(k, [64]))
        if case == "unplaceable":
            cls = [k.T.SLOClass("rt", deadline_ms=20.0, priority=2,
                                drop_policy=k.T.SHED)]
            return k.C.simulate_cluster(
                cls, {"rt": make_lut(k)},
                {"rt": k.T.poisson(100.0, 4.0, seed=5)},
                make_nodes(k, [256, 64]), fail_at={"n0": 2.0})
        cls = [k.T.SLOClass("rt", deadline_ms=20.0, priority=2,
                            drop_policy=k.T.SHED, service_frac=0.5)]
        return k.C.simulate_cluster(
            cls, {"rt": make_lut(k)},
            {"rt": k.T.poisson(100.0, 4.0, seed=4)},
            make_nodes(k, [256, 256]), fail_at={"n0": 2.0})
    ref, port = both(run)
    assert rep_sig(port) == rep_sig(ref)
    s = port.classes["rt"]
    assert s.submitted == s.rejected + s.dropped + s.failed + s.completed
    if case == "rejected":
        assert s.rejected == s.submitted > 0 and s.completed == 0
    elif case == "unplaceable":
        assert s.rejected == 0 and s.dropped > 0
    else:
        post = [d for d in port.decisions if d[0] > 2.0]
        assert post and all(d[2] == "n1" for d in post)


def test_stall_detector_resets_on_progress():
    det = PC.StallDetector(epochs=2)
    seq = [(0, 5), (0, 5), (3, 5), (3, 0), (3, 4), (3, 4)]
    got = [det.observe(c, b) for c, b in seq]
    ref = JC.StallDetector(epochs=2)
    assert got == [ref.observe(c, b) for c, b in seq]
    assert got == [False] * 5 + [True]


# --- live: the port's Cluster over small port servers on the CPU -------------

def live_cluster(n=2, **kw):
    cluster = two_nodes(n, **kw)
    cluster.register("api", live_lut(), target_latency_ms=500.0,
                     priority=1, make_server=tiny_server)
    return cluster


def test_live_cluster_routes_and_serves():
    cluster = live_cluster()
    cluster.start()
    try:
        outs = [cluster.submit("api", X).get(timeout=30) for _ in range(8)]
        assert all(not o.get("cancelled") for o in outs)
        assert all(o["y"].shape == (4,) for o in outs)
    finally:
        cluster.stop()
    assert sum(cluster.summary()["routed"]["api"].values()) == 8


def test_live_drain_serves_backlog_then_migrates():
    cluster = live_cluster()
    cluster.start()
    try:
        futs = [cluster.submit("api", X) for _ in range(6)]
        assert cluster.drain("n0", timeout_s=20.0)
        outs = [f.get(timeout=30) for f in futs]
        assert all(not o.get("cancelled") for o in outs)
        assert cluster.placements_snapshot()["api"] == ["n1"]
        assert cluster.nodes["n0"].state == PC.DRAINED
        assert not cluster.submit("api", X).get(timeout=30).get("cancelled")
    finally:
        cluster.stop()


def test_live_fail_resolves_every_future():
    cluster = live_cluster()
    cluster.start()
    try:
        futs = [cluster.submit("api", X) for _ in range(16)]
        cluster.fail("n0", reason="pulled the plug")
        outs = [f.get(timeout=30) for f in futs]
        for o in (o for o in outs if o.get("cancelled")):
            assert o["error"] in ("pulled the plug", "server stopped")
        assert cluster.nodes["n0"].state == PC.DEAD
        assert not cluster.submit("api", X).get(timeout=30).get("cancelled")
    finally:
        cluster.stop()


def test_kill_payloads_marked_failed():
    server = tiny_server()
    futs = [server.submit(X) for _ in range(3)]   # queued, never started
    server.kill("node failed")
    for f in futs:
        out = f.get(timeout=5)
        assert out["cancelled"] and out["failed"]
        assert out["error"] == "node failed"
    other = tiny_server()
    fut = other.submit(X)
    other.stop()
    out = fut.get(timeout=5)
    assert out["cancelled"] and not out["failed"]


def test_kill_with_batches_in_flight_resolves_every_future():
    """Fail-stop after the first answer, with later batches dispatched or
    queued: each future resolves with logits or the failed payload."""
    server = tiny_server(max_batch=4)
    server.start()
    futs = [server.submit(X) for _ in range(32)]
    futs[0].put(futs[0].get(timeout=30))
    server.kill("pulled the plug")
    outs = [f.get(timeout=10) for f in futs]
    assert not outs[0].get("cancelled")
    assert all(not o.get("cancelled") or (o["failed"] and
                                          o["error"] == "pulled the plug")
               for o in outs)
    assert server.outstanding() == 0 and not server.is_running


def test_live_fail_last_node_errors_new_submits():
    cluster = live_cluster(n=1)
    cluster.start()
    try:
        cluster.fail("n0")
        out = cluster.submit("api", X).get(timeout=5)
        assert out["cancelled"] and "no placement" in out["error"]
        assert "api" in cluster.summary()["unplaceable"]
    finally:
        cluster.stop()


def test_live_health_check_auto_fails_wedged_node():
    """The port's wedge(): the worker parks, resume() is defeated, the
    node's completions stay flat with futures outstanding, and the health
    thread fails it over; every stuck future resolves failed."""
    cluster = live_cluster(health_interval_s=0.05, health_epochs=3)
    cluster.start()
    try:
        assert not cluster.submit("api", X).get(timeout=30).get("cancelled")
        n0 = cluster.nodes["n0"]
        srv = n0.servers["api"]
        srv.wedge()
        srv.resume()                       # the arbiter's resume is ignored
        assert srv._paused.is_set()
        futs = [srv.submit(X) for _ in range(4)]
        deadline = time.perf_counter() + 15.0
        while n0.state != PC.DEAD and time.perf_counter() < deadline:
            time.sleep(0.02)
        assert n0.state == PC.DEAD, "health check never failed the node"
        assert "n0" in cluster.summary()["health_failed"]
        outs = [f.get(timeout=10) for f in futs]
        assert all(o.get("cancelled") and o.get("failed") for o in outs)
        assert "wedged" in outs[0]["error"]
        assert not cluster.submit("api", X).get(timeout=30).get("cancelled")
        assert cluster.placements_snapshot()["api"] == ["n1"]
    finally:
        cluster.stop()


def test_unwedge_resumes_and_serves():
    server = tiny_server()
    server.start()
    try:
        server.wedge()
        fut = server.submit(X)
        time.sleep(0.1)
        assert fut.empty() and server.outstanding() == 1
        server.unwedge()
        assert not fut.get(timeout=30).get("cancelled")
    finally:
        server.stop()


def test_starved_node_not_flagged_wedged():
    server = tiny_server()
    node = PC.ClusterNode(name="n0",
                          g_fn=lambda t: PR.GlobalConstraints(total_chips=2))
    node.servers["api"] = server
    node.arbiter.register("api", make_lut(P), target_latency_ms=40.0,
                          server=server)
    futs = [server.submit(X) for _ in range(3)]
    node.arbiter.tick(node.g(0.0))
    assert node.arbiter.last_alloc["api"].point is None
    assert node.starved() and node.outstanding() > 0
    for _ in range(6):
        assert not node.check_health()
    server.stop()
    for f in futs:
        assert f.get(timeout=5)["cancelled"]


def test_submit_links_reach_the_request_tree():
    """A retried attempt's trace links back through Cluster.submit and
    DynamicServer.submit alike."""
    from repro_torch.obs import Tracer
    tracer = Tracer()
    cluster = live_cluster(tracer=tracer)
    server = tiny_server(tracer=tracer)
    cluster.start()
    server.start()
    try:
        a = cluster.submit("api", X, links=[41])
        b = server.submit(X, links=[42])
        assert not a.get(timeout=30).get("cancelled")
        assert not b.get(timeout=30).get("cancelled")
    finally:
        server.stop()
        cluster.stop()
    links = {tr.trace_id: tr.links for tr in tracer.requests()}
    assert list(links[a.trace_id]) == [41]
    assert list(links[b.trace_id]) == [42]


@pytest.mark.parametrize("hand_over", [True, False])
def test_route_to_queue_gap_keeps_latency_partitioned(hand_over):
    """A thread switch between the route span's end and the engine's own
    stamp (20 ms here) lands in the queue span when ``Cluster.submit``
    hands its stamp over (``t_submit=``): the tree's components still sum
    to its latency.  Without the hand-over the gap belongs to no span and
    ``check_trace`` rejects the tree."""
    from repro_torch.obs import DecompositionError, Tracer
    from repro_torch.obs.analyze import check_trace

    def slow_server(node, **kw):
        s = tiny_server(node, **kw)
        real = s.submit

        def submit(x, trace_id=None, links=(), *, t_submit=None):
            time.sleep(0.02)
            return real(x, trace_id, links,
                        t_submit=t_submit if hand_over else None)
        s.submit = submit
        return s

    tracer = Tracer()
    cluster = two_nodes(1, tracer=tracer)
    cluster.register("api", live_lut(), target_latency_ms=500.0,
                     priority=1, make_server=slow_server)
    cluster.start()
    try:
        assert not cluster.submit("api", X).get(timeout=30).get("cancelled")
    finally:
        cluster.stop()
    (tree,) = tracer.requests()
    if hand_over:
        check_trace(tree)
    else:
        with pytest.raises(DecompositionError):
            check_trace(tree)


# --- the serve launcher's cluster mode ---------------------------------------

def test_serve_cluster_mode_writes_every_artefact(tmp_path, capsys):
    from repro_torch.launch import serve
    from repro_torch.obs import iter_trace_events
    p = {n: str(tmp_path / n) for n in ("s.json", "a.txt", "p.txt",
                                          "t.json", "m.prom", "rec.json")}
    serve.main(["--smoke", "--device", "cpu", "--trace", "poisson",
                "--nodes", "2", "--router", "p2c",
                "--health-interval", "0.5", "--rebalance-interval", "1",
                "--trace-duration", "1", "--requests", "8",
                "--trace-steps", "10",
                "--stream-trace", p["s.json"], "--alerts-out", p["a.txt"],
                "--profile-out", p["p.txt"], "--trace-out", p["t.json"],
                "--metrics-out", p["m.prom"], "--record", p["rec.json"]])
    out = capsys.readouterr().out
    assert "interactive: placed on ['node0', 'node1']" in out
    assert "cluster trace mode [poisson] x2 nodes, router=p2c" in out
    for line in ("  routed       {", "  health-failed nodes: []",
                 "  migrations:   ", "  preempted:    ", "  streamed ",
                 " SLO alerts (time-in-SLO ", "  device profile: "):
        assert line in out, line
    streamed = list(iter_trace_events(p["s.json"]))
    one_shot = json.load(open(p["t.json"]))["traceEvents"]
    assert streamed and len(streamed) == len(one_shot)
    assert open(p["p.txt"]).read().startswith("subnet")
    assert "router_routed_total" in open(p["m.prom"]).read()
    rec = PT.load_schedule(p["rec.json"])
    assert set(rec) == {"interactive", "batch"}
