"""The port's multi-tenant ResourceArbiter, its water-filling solver and
the roofline-modelled LUT against the JAX package's on the CPU, compared
exactly: the same scenario through both packages gives the same
allocations, summaries and registry series.

The port prices slices with the H100's constants (``runtime/hwmodel.py``);
the parity tests set them to the reference's v5e values first, so the two
packages run the same arithmetic.  One test keeps the H100 constants and
checks the pricing the port actually serves with.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.runtime as JR  # noqa: E402
import repro_torch.runtime as PR  # noqa: E402
from repro.core import types as JTY  # noqa: E402
from repro.runtime import hwmodel as jhm  # noqa: E402
from repro.runtime import waterfill as jwf  # noqa: E402
from repro_torch.core import types as PTY  # noqa: E402
from repro_torch.runtime import hwmodel as phm  # noqa: E402
from repro_torch.runtime import waterfill as pwf  # noqa: E402

TERMS = (0.02, 0.008, 0.004)
V5E = ("PEAK_FLOPS", "HBM_BW", "ICI_BW", "TDP_W", "IDLE_W")
PKGS = ((JR, JTY, jhm), (PR, PTY, phm))


@pytest.fixture
def v5e(monkeypatch):
    """The port's hardware constants set to the reference's."""
    for name in V5E:
        monkeypatch.setattr(phm, name, getattr(jhm, name))


def make_lut(R, TY, hm, scale=1.0, chips=None):
    space = TY.ElasticSpace(width_mults=(0.5, 0.75, 1.0), ffn_mults=(0.5, 1.0),
                            depth_mults=(0.5, 1.0))
    terms = hm.RooflineTerms(*(t * scale for t in TERMS))
    hw = (None if chips is None else
          [hm.HwState(chips=c, freq=f) for c in chips for f in hm.FREQ_LADDER])
    return R.model_lut(space.enumerate(), full_terms=terms, full_chips=256,
                       hw_states=hw)


def point_key(p):
    if p is None:
        return None
    return (p.subnet.name(), p.hw_state.chips, p.hw_state.freq,
            p.latency_ms, p.energy_mj, p.accuracy)


def alloc_key(allocs):
    return {n: (point_key(a.point), a.chips, a.power_w, a.feasible, a.share,
                a.priced_power_w) for n, a in allocs.items()}


@pytest.mark.parametrize("chips", [None, (256, 128, 64, 32)],
                         ids=["default-ladder", "four-tiers"])
@pytest.mark.parametrize("scale", [0.5, 1.0, 3.0])
def test_model_lut_points_equal_reference(scale, chips, v5e):
    j, p = (make_lut(R, TY, hm, scale, chips) for R, TY, hm in PKGS)
    assert len(j.points) > 100
    assert [point_key(q) for q in p.points] == \
        [point_key(q) for q in j.points]


@pytest.mark.parametrize("full", [1, 2, 7, 256])
def test_default_hw_states_equal_reference(full):
    assert [(s.chips, s.freq) for s in PR.default_hw_states(full)] == \
        [(s.chips, s.freq) for s in JR.default_hw_states(full)]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_waterfill_grants_equal_reference(seed):
    """Random demands over random priced candidates: the same grants."""
    rng = np.random.default_rng(seed)
    n_dem = int(rng.integers(2, 6))
    specs = []
    for i in range(n_dem):
        cands = [dict(units=int(rng.integers(1, 9)),
                      cost=float(rng.uniform(50, 800)),
                      latency_ms=float(rng.uniform(1, 40)),
                      accuracy=float(rng.uniform(70, 80)),
                      energy_mj=float(rng.uniform(1, 100)))
                 for _ in range(int(rng.integers(3, 12)))]
        specs.append(dict(name=f"t{i}", cands=cands,
                          target=float(rng.uniform(5, 30)),
                          priority=int(rng.integers(0, 3)),
                          backlog=float(rng.choice([0.0, 0.2, 3.0, 40.0]))))
    units = int(rng.integers(4, 24))
    power = float(rng.choice([np.inf, rng.uniform(400, 3000)]))

    def run(wf):
        demands = []
        for d in specs:
            pts = [wf.PricedPoint(units=c["units"], cost=c["cost"],
                                  base_cost=c["cost"],
                                  latency_ms=c["latency_ms"],
                                  accuracy=c["accuracy"],
                                  energy_mj=c["energy_mj"], payload=k)
                   for k, c in enumerate(d["cands"])]

            def feasible(u, cost, pts=pts, target=d["target"]):
                return [q for q in pts if q.units <= u and q.cost <= cost
                        and q.latency_ms <= target]

            def candidates(u, cost, pts=pts):
                return [q for q in pts if q.units <= u and q.cost <= cost]

            demands.append(wf.Demand(name=d["name"], feasible=feasible,
                                     candidates=candidates,
                                     priority=d["priority"],
                                     backlog=d["backlog"]))
        grants = wf.waterfill(demands, units, power)
        return {n: (g.point.payload if g.point else None, g.feasible,
                    g.units, g.cost) for n, g in grants.items()}

    assert run(pwf) == run(jwf)


def scenario(R, TY, hm):
    """Three tenants on a shrinking chip and power budget, on a fake
    clock: admission, backlog EWMA, preemption and starvation."""
    clock = [0.0]
    arb = R.ResourceArbiter(interval_s=0.05, time_fn=lambda: clock[0])
    fast, slow = make_lut(R, TY, hm, 0.5), make_lut(R, TY, hm, 2.0)
    g_big = R.GlobalConstraints(total_chips=256, power_budget_w=60000.0)
    arb.register("api", fast, target_latency_ms=30.0, priority=2,
                 admission_under=g_big)
    arb.register("vision", fast, target_latency_ms=60.0, priority=1,
                 min_accuracy=76.0, admission_under=g_big)
    arb.register("batch", slow, target_latency_ms=400.0, priority=0)
    rejected = []
    for name, lut, target in (("impossible", fast, 0.001),
                              ("tight", slow, 5.0)):
        try:
            arb.register(name, lut, target_latency_ms=target, priority=1,
                         admission_under=g_big)
        except R.AdmissionError as e:
            rejected.append((name, str(e)))
    out = []
    budgets = [(256, None), (256, 60000.0), (192, 40000.0), (128, 30000.0),
               (64, 15000.0), (32, 9000.0), (16, 4000.0), (8, 2000.0),
               (128, None)]
    for step, (chips, power) in enumerate(budgets):
        clock[0] += 0.05
        g = R.GlobalConstraints(total_chips=chips, power_budget_w=power,
                                temperature_throttle=0.8 if step == 5
                                else 1.0)
        arb.set_active("api", True, queue_depth=3 * step,
                       arrival_rate_rps=100.0 + 20 * step)
        arb.set_active("vision", step % 3 != 2, queue_depth=step,
                       arrival_rate_rps=10.0)
        arb.set_active("batch", step % 4 != 3, queue_depth=40 - 4 * step,
                       arrival_rate_rps=2.0)
        out.append(alloc_key(arb.tick(g)))
        if step in (3, 6):
            arb.set_active("vision", False)
            out.append(alloc_key(arb.arbitrate(g)))
            a = arb.preempt("vision", g)
            out.append(alloc_key({"vision": a}))
        out.append((arb.backlog("api"), arb.total_backlog(),
                    arb.headroom(g).chips, arb.headroom(g).power_w))
        out.append(arb.admission_check(slow, 100.0, g, priority=1)
                   is not None)
        out.append({n: (c.target_latency_ms, c.chips_available,
                        c.power_budget_w, c.priority, c.share)
                    for n, c in ((n, arb.constraints_for(
                        arb._workloads[n], a, g))
                        for n, a in arb.last_allocations().items())})
    arb.set_brownout("batch", 900.0)
    arb.set_alert_pressure("api", 1.5)
    out.append(alloc_key(arb.tick(R.GlobalConstraints(total_chips=64))))
    return out, rejected, arb.summary(), arb.metrics.to_json()


def test_arbitrate_tick_preempt_equal_reference(v5e):
    j, p = scenario(*PKGS[0]), scenario(*PKGS[1])
    j_out, j_rej, j_sum, j_json = j
    p_out, p_rej, p_sum, p_json = p
    assert [n for n, _ in j_rej] == ["impossible", "tight"]
    assert p_rej == j_rej
    assert p_out == j_out
    assert p_sum == j_sum
    assert p_json == j_json
    # the scenario reached what it was built for: starvation, preemption,
    # backlog smoothing and a brownout
    assert any(isinstance(o, dict) and any(v[0] is None for v in o.values())
               for o in j_out)
    assert j_sum["vision"]["preemptions"] == 2
    assert j_sum["api"]["arrival_ewma_rps"] > 0
    assert j_sum["batch"]["brownout"] is True


def test_unregister_clears_stats_equal_reference(v5e):
    sums = []
    for R, TY, hm in PKGS:
        arb = R.ResourceArbiter(interval_s=0.05, time_fn=lambda: 0.0)
        lut = make_lut(R, TY, hm)
        arb.register("a", lut, target_latency_ms=30.0, priority=1)
        arb.register("b", lut, target_latency_ms=60.0)
        for _ in range(3):
            arb.tick(R.GlobalConstraints(total_chips=64))
        arb.unregister("a")
        arb.register("a", lut, target_latency_ms=30.0, priority=1)
        arb.tick(R.GlobalConstraints(total_chips=64))
        sums.append((arb.summary(), arb.metrics.to_prometheus()))
    assert sums[1] == sums[0]
    assert sums[0][0]["a"]["cycles"] == 1


def test_h100_pricing_charges_the_card_power():
    """With the port's own constants a 1-card slice at full clock costs
    the modelled board power of one H100 at 80% utilisation."""
    hw = phm.HwState(chips=1, freq=1.0)
    assert phm.slice_power_w(hw) == pytest.approx(
        phm.IDLE_W + 0.8 * (phm.TDP_W - phm.IDLE_W))
    arb = PR.ResourceArbiter(interval_s=0.05, time_fn=lambda: 0.0)
    lut = make_lut(PR, PTY, phm, chips=(2, 1))
    arb.register("a", lut, target_latency_ms=1e9)
    allocs = arb.tick(PR.GlobalConstraints(total_chips=2,
                                           power_budget_w=700.0))
    a = allocs["a"]
    assert a.feasible and a.power_w <= 700.0
    assert a.power_w == phm.slice_power_w(a.point.hw_state)
