"""The port's placement engine (``repro_torch.cluster.placement``) and the
cluster simulator's rebalance / scale / preemption scripting against the
JAX package's on the CPU: the same specs, nodes, stores and seeded traces
go through both packages, and every plan and report must be equal (``==``).

The port prices slices with the H100's constants (``runtime/hwmodel.py``);
the ``v5e`` fixture sets them to the reference's values first, so the two
packages run the same arithmetic.  Each test also holds the port's result
to the reference test's own property (``tests/test_placement.py``).
"""
import dataclasses

import pytest

from _torch_cluster import (PC, PKGS, both, make_lut, make_nodes,  # noqa: F401
                            phm, v5e)


def spec(k, name, target, **kw):
    return k.C.placement.ClassSpec(name, make_lut(k), target, **kw)


def plan_sig(plan):
    """Plain data of a PlacementPlan / RebalancePlan / ScalePlan / list."""
    if isinstance(plan, list):
        return [dataclasses.astuple(e) for e in plan]
    if hasattr(plan, "moves"):
        return (plan_sig(plan.target), plan_sig(plan.moves),
                plan_sig(plan.rejected))
    return dataclasses.astuple(plan)


def rep_sig(rep):
    return (rep.summary(), list(rep.decisions), list(rep.migrations),
            list(rep.scale_events), list(rep.preempted))


# --- the fresh global solve --------------------------------------------------

def test_solve_placement_replicates_when_everything_fits():
    ref, port = both(lambda k: k.C.solve_placement(
        [spec(k, "a", 40.0, priority=2), spec(k, "b", 120.0, priority=1)],
        make_nodes(k, [256, 256])))
    assert plan_sig(port) == plan_sig(ref)
    assert sorted(port.placements["a"]) == ["n0", "n1"]
    assert sorted(port.placements["b"]) == ["n0", "n1"]


def test_solve_placement_respects_replica_cap_and_headroom():
    ref, port = both(lambda k: (
        k.C.solve_placement([spec(k, "a", 40.0, priority=2)],
                            make_nodes(k, [256, 256, 256]), replicas=2),
        k.C.solve_placement([spec(k, "t", 10.0, priority=2)],
                            make_nodes(k, [64, 256]))))
    assert [plan_sig(p) for p in port] == [plan_sig(p) for p in ref]
    assert len(port[0].placements["a"]) == 2
    assert port[1].placements["t"] == ["n1"]


def test_solve_placement_backlogged_class_fills_first():
    def run(k):
        lut = make_lut(k)
        specs = [k.C.placement.ClassSpec("calm", lut, 10.0, priority=2,
                                         backlog=0.0),
                 k.C.placement.ClassSpec("hot", lut, 10.0, priority=2,
                                         backlog=50.0)]
        return k.C.solve_placement(specs, make_nodes(k, [256, 256, 256]))
    ref, port = both(run)
    assert plan_sig(port) == plan_sig(ref)
    assert len(port.placements["hot"]) == 2
    assert len(port.placements["calm"]) == 1


def test_solve_placement_skips_standby_nodes():
    ref, port = both(lambda k: k.C.solve_placement(
        [spec(k, "a", 40.0)],
        make_nodes(k, [256, 256], states=[k.C.UP, k.C.STANDBY])))
    assert plan_sig(port) == plan_sig(ref)
    assert port.placements["a"] == ["n0"]


def test_solve_placement_fallback_places_everywhere():
    ref, port = both(lambda k: k.C.solve_placement(
        [spec(k, "never", 0.001, fallback_target_ms=500.0)],
        make_nodes(k, [64, 64])))
    assert plan_sig(port) == plan_sig(ref)
    assert sorted(port.placements["never"]) == ["n0", "n1"]
    assert port.best_effort == ["never"]


# --- priced rebalancing ------------------------------------------------------

def test_migration_cost_is_positive_and_calibration_aware():
    def run(k):
        s = spec(k, "a", 40.0)
        cost = k.C.migration_cost(s)
        store = k.R.CalibrationStore()
        pt = min(s.lut.points, key=lambda p: (p.latency_ms, -p.accuracy))
        for _ in range(8):
            store.note_latency(pt.subnet, 8, pt.latency_ms * 3.0,
                               max_batch=8)
        return cost, k.C.migration_cost(s, calibration=store)
    ref, port = both(run)
    assert [dataclasses.astuple(c) for c in port] == \
        [dataclasses.astuple(c) for c in ref]
    cost, slow = port
    assert cost.seconds > PC.placement.DEFAULT_TRANSFER_S
    assert cost.joules > 0
    assert slow.seconds > cost.seconds


def test_migration_cost_prices_with_the_h100_constants(monkeypatch):
    """Outside the fixture the port's joules come from the H100's power
    model: the same seconds, 700 W-class watts instead of v5e's."""
    s = spec(PKGS[1], "a", 40.0)
    at_v5e = PC.migration_cost(s)
    monkeypatch.undo()
    at_h100 = PC.migration_cost(s)
    assert at_h100.seconds == at_v5e.seconds
    pt = min(s.lut.points, key=lambda p: (p.latency_ms, -p.accuracy))
    assert at_h100.joules == pytest.approx(
        at_h100.seconds * phm.slice_power_w(pt.hw_state))
    assert at_h100.joules > at_v5e.joules


def test_plan_rebalance_steady_state_is_empty():
    ref, port = both(lambda k: k.C.plan_rebalance(
        [spec(k, "a", 40.0, priority=2, backlog=3.0),
         spec(k, "b", 120.0, priority=1, backlog=2.0)],
        make_nodes(k, [256, 256]), {"a": ["n0", "n1"], "b": ["n0", "n1"]}))
    assert plan_sig(port) == plan_sig(ref)
    assert port.moves == [] and port.rejected == []


def test_plan_rebalance_prices_out_unamortized_adds():
    ref, port = both(lambda k: (
        k.C.plan_rebalance([spec(k, "a", 40.0, backlog=0.0)],
                           make_nodes(k, [256, 256]), {"a": ["n0"]}),
        k.C.plan_rebalance([spec(k, "a", 40.0, backlog=2000.0)],
                           make_nodes(k, [256, 256]), {"a": ["n0"]},
                           horizon_s=30.0)))
    assert [plan_sig(p) for p in port] == [plan_sig(p) for p in ref]
    calm, hot = port
    assert calm.moves == []
    assert [m.kind for m in calm.rejected] == ["add"]
    assert [m.kind for m in hot.moves] == ["add"]
    mv = hot.moves[0]
    assert mv.dst == "n1" and mv.benefit_s > 2.0 * mv.cost_s > 0


def test_plan_rebalance_never_orphans_a_class():
    ref, port = both(lambda k: k.C.plan_rebalance(
        [spec(k, "t", 10.0)], make_nodes(k, [64, 256]), {"t": ["n0"]},
        horizon_s=30.0))
    assert plan_sig(port) == plan_sig(ref)
    kinds = sorted(m.kind for m in port.moves + port.rejected)
    assert "move" in kinds or "add" in kinds
    final = {"n0"}
    for m in port.moves:
        if m.dst:
            final.add(m.dst)
        if m.src:
            final.discard(m.src)
    assert final


# --- cross-node preemption ---------------------------------------------------

@pytest.mark.parametrize("case", ["evicts_lowest", "last_replica", "quiet"])
def test_plan_preemptions(case):
    def run(k):
        lut = make_lut(k)
        S = k.C.placement.ClassSpec
        if case == "evicts_lowest":
            specs = [S("hi", lut, 40.0, priority=3, backlog=20.0),
                     S("mid", lut, 40.0, priority=2),
                     S("lo", lut, 40.0, priority=1)]
            return k.C.plan_preemptions(
                specs, make_nodes(k, [256, 256]),
                {"hi": ["n0"], "mid": ["n0", "n1"], "lo": ["n0", "n1"]})
        backlog = 20.0 if case == "last_replica" else 0.0
        specs = [S("hi", lut, 40.0, priority=3, backlog=backlog),
                 S("lo", lut, 40.0, priority=1)]
        if case == "last_replica":
            return k.C.plan_preemptions(specs, make_nodes(k, [256]),
                                        {"hi": ["n0"], "lo": ["n0"]})
        return k.C.plan_preemptions(specs, make_nodes(k, [256, 256]),
                                    {"hi": ["n0"], "lo": ["n0", "n1"]})
    ref, port = both(run)
    assert plan_sig(port) == plan_sig(ref)
    if case == "evicts_lowest":
        assert port and port[0].victim == "lo" and port[0].node == "n0"
        assert port[0].for_cls == "hi"
    else:
        assert port == []


# --- autoscaling -------------------------------------------------------------

def test_plan_scaling_spins_up_standby_on_backlog():
    ref, port = both(lambda k: (
        k.C.plan_scaling(make_nodes(k, [256, 256],
                                    states=[k.C.UP, k.C.STANDBY]),
                         backlog_per_chip=5.0),
        k.C.plan_scaling(make_nodes(k, [256]), backlog_per_chip=5.0)))
    assert [plan_sig(p) for p in port] == [plan_sig(p) for p in ref]
    assert port[0].spin_up == ["n1"] and port[0].spin_down == []
    assert port[1].spin_up == []


def test_plan_scaling_spins_down_idle_under_high_price():
    def run(k):
        nodes = make_nodes(k, [256, 64])
        return (k.C.plan_scaling(nodes, backlog_per_chip=0.0,
                                 energy_price=2.0),
                k.C.plan_scaling(nodes, backlog_per_chip=0.0,
                                 energy_price=0.1),
                k.C.plan_scaling(nodes, backlog_per_chip=0.0,
                                 energy_price=2.0, min_nodes=2))
    ref, port = both(run)
    assert [plan_sig(p) for p in port] == [plan_sig(p) for p in ref]
    assert port[0].spin_down == ["n1"]
    assert port[1].spin_down == [] and port[2].spin_down == []


# --- simulate_cluster scripting ---------------------------------------------

def cls(k, name="api", priority=2, drop_policy=None, deadline_ms=200.0):
    return k.T.SLOClass(name, deadline_ms=deadline_ms, priority=priority,
                        drop_policy=drop_policy or k.T.SHED)


def test_sim_no_flapping_under_steady_load():
    ref, port = both(lambda k: k.C.simulate_cluster(
        [cls(k)], {"api": make_lut(k)},
        {"api": k.T.poisson(300.0, 6.0, seed=3)},
        make_nodes(k, [256, 256]), router=k.C.LEAST_LOADED,
        rebalance_at=[1.0, 2.0, 3.0, 4.0, 5.0]))
    assert rep_sig(port) == rep_sig(ref)
    assert port.migrations == [] and port.preempted == []
    assert port.total_goodput > 0


@pytest.mark.parametrize("rebalance", [False, True],
                         ids=["static", "rebalanced"])
def test_sim_rebalance_recovers_skewed_first_fit(rebalance):
    def run(k):
        kw = dict(classes=[cls(k, drop_policy=k.T.DEGRADE)],
                  luts={"api": make_lut(k)},
                  streams={"api": k.T.poisson(2500.0, 4.0, seed=5)},
                  router=k.C.LEAST_LOADED, placement_mode=k.C.FIRST_FIT)
        static = k.C.simulate_cluster(nodes=make_nodes(k, [256] * 3), **kw)
        if not rebalance:
            return static, None
        return static, k.C.simulate_cluster(
            nodes=make_nodes(k, [256] * 3),
            rebalance_at=[0.5, 1.5, 2.5, 3.5], **kw)
    (rs, rr), (ps, pr) = both(run)
    assert rep_sig(ps) == rep_sig(rs)
    assert ps.migrations == []
    if rebalance:
        assert rep_sig(pr) == rep_sig(rr)
        assert len(pr.migrations) >= 1
        assert all(mv[3] is not None for mv in pr.migrations)
        assert pr.total_goodput > ps.total_goodput


def test_sim_rebalance_and_scale_are_deterministic():
    def run(k):
        return k.C.simulate_cluster(
            [cls(k, drop_policy=k.T.DEGRADE)], {"api": make_lut(k)},
            {"api": k.T.poisson(2500.0, 4.0, seed=11)},
            make_nodes(k, [256, 256, 256],
                       states=[k.C.UP, k.C.UP, k.C.STANDBY]),
            router=k.C.LEAST_LOADED, placement_mode=k.C.FIRST_FIT,
            rebalance_at=[0.5, 1.5, 2.5], scale_at=[0.4, 1.4, 2.4],
            energy_price_fn=lambda t: 0.2 if t < 2.0 else 2.0)
    ref, port = both(run)
    again = run(PKGS[1])
    assert rep_sig(port) == rep_sig(ref) == rep_sig(again)


def test_sim_autoscaler_spins_up_standby_on_sustained_backlog():
    ref, port = both(lambda k: k.C.simulate_cluster(
        [cls(k, drop_policy=k.T.DEGRADE)], {"api": make_lut(k)},
        {"api": k.T.poisson(3000.0, 4.0, seed=13)},
        make_nodes(k, [256, 256], states=[k.C.UP, k.C.STANDBY]),
        router=k.C.LEAST_LOADED, scale_at=[1.0, 2.0, 3.0]))
    assert rep_sig(port) == rep_sig(ref)
    ups = [e for e in port.scale_events if e[1] == "up"]
    assert ups and ups[0][2] == "n1"
    assert any(d[2] == "n1" for d in port.decisions)


def test_sim_autoscaler_spins_down_idle_node_under_high_price():
    times = [i * 0.25 for i in range(40)]
    ref, port = both(lambda k: k.C.simulate_cluster(
        [cls(k)], {"api": make_lut(k)}, {"api": times},
        make_nodes(k, [256, 64]), router=k.C.LEAST_LOADED,
        scale_at=[8.0], energy_price_fn=lambda t: 2.0))
    assert rep_sig(port) == rep_sig(ref)
    downs = [e for e in port.scale_events if e[1] == "down"]
    assert len(downs) == 1 and downs[0][2] == "n1"
    assert 8.0 <= downs[0][0] <= 8.5
    assert port.nodes["n1"]["state"] == PC.STANDBY


def test_sim_cross_node_preemption_evicts_colocated_replica():
    def run(k):
        lut = make_lut(k)
        return k.C.simulate_cluster(
            [cls(k, "hot", priority=3, drop_policy=k.T.DEGRADE),
             cls(k, "bulk", priority=0, drop_policy=k.T.DEGRADE)],
            {"hot": lut, "bulk": lut},
            {"hot": k.T.poisson(2500.0, 3.0, seed=17),
             "bulk": k.T.poisson(50.0, 3.0, seed=18)},
            make_nodes(k, [256, 256]), router=k.C.LEAST_LOADED,
            rebalance_at=[0.5])
    ref, port = both(run)
    assert rep_sig(port) == rep_sig(ref)
    assert any(p[1] == "bulk" and p[3] == "hot" for p in port.preempted)
    assert port.classes["bulk"].completed > 0


# --- router ------------------------------------------------------------------

def test_router_decision_log_is_bounded():
    def run(k):
        nodes = make_nodes(k, [64, 64])
        r = k.C.ClusterRouter(k.C.LEAST_LOADED, decision_log_cap=8)
        for i in range(20):
            r.pick("a", nodes, t=float(i))
        return r
    ref, port = both(run)
    assert list(port.decisions) == list(ref.decisions)
    assert port.routed_counts() == ref.routed_counts()
    assert len(port.decisions) == 8 and port.decisions_dropped == 12
    assert [d[0] for d in port.decisions] == [float(i)
                                              for i in range(12, 20)]
    assert sum(port.routed_counts()["a"].values()) == 20


def test_router_weight_zero_takes_replica_out_of_rotation():
    def run(k):
        nodes = make_nodes(k, [64, 64])
        r = k.C.ClusterRouter(k.C.LEAST_LOADED)
        r.set_weight("a", "n0", 0.0)
        out = [r.pick("a", nodes).name for _ in range(4)]
        r.set_weight("a", "n0", None)
        out.append(r.pick("a", nodes, load_fn=lambda n: 0.0).name)
        r.set_weight("a", "n1", 4.0)
        out.append(r.pick("a", nodes, load_fn=lambda n: 1.0
                          if n.name == "n1" else 0.5).name)
        return out
    ref, port = both(run)
    assert port == ref == ["n1"] * 4 + ["n0", "n1"]
