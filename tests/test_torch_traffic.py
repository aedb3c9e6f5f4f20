"""The port's traffic layer (``repro_torch.traffic``) against the JAX
package's on the CPU: seeded arrivals, schedules saved by one package and
loaded by the other, ``simulate`` reports (SLO and FIFO, bucketed and
padded, with and without a warmed calibration store) and its virtual-time
spans, all compared exactly; and the live driver over two port servers
behind the port's arbiter.

The port prices slices with the H100's constants (``runtime/hwmodel.py``);
the parity tests set them to the reference's v5e values first, so the two
packages run the same arithmetic and must agree bit for bit.
"""
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.traffic as JT  # noqa: E402
import repro_torch.traffic as PT  # noqa: E402
from repro.core import types as JTY  # noqa: E402
from repro.runtime import CalibrationStore as JStore  # noqa: E402
from repro.runtime import GlobalConstraints as JG  # noqa: E402
from repro.runtime import hwmodel as jhm  # noqa: E402
from repro.runtime import model_lut as j_model_lut  # noqa: E402
from repro_torch.core import types as PTY  # noqa: E402
from repro_torch.obs import (MetricsRegistry, Tracer,  # noqa: E402
                             validate_schema)
from repro_torch.obs.analyze import check_trace  # noqa: E402
from repro_torch.runtime import CalibrationStore as PStore  # noqa: E402
from repro_torch.runtime import GlobalConstraints as PG  # noqa: E402
from repro_torch.runtime import hwmodel as phm  # noqa: E402
from repro_torch.runtime import model_lut as p_model_lut  # noqa: E402

torch.set_num_threads(2)
TERMS = (0.02, 0.008, 0.004)
V5E = ("PEAK_FLOPS", "HBM_BW", "ICI_BW", "TDP_W", "IDLE_W")


@pytest.fixture
def v5e(monkeypatch):
    """The port's hardware constants set to the reference's."""
    for name in V5E:
        monkeypatch.setattr(phm, name, getattr(jhm, name))


def luts(pkg_types, pkg_hm, model_lut, scale=1.0):
    space = pkg_types.ElasticSpace(width_mults=(0.5, 0.75, 1.0),
                                   ffn_mults=(0.5, 1.0),
                                   depth_mults=(0.5, 1.0))
    terms = pkg_hm.RooflineTerms(*(t * scale for t in TERMS))
    return model_lut(space.enumerate(), full_terms=terms, full_chips=256)


def both_setups(horizon_s=3.0):
    """The same classes, LUTs, streams and budget in each package."""
    out = []
    for T, TY, hm, ml, G in ((JT, JTY, jhm, j_model_lut, JG),
                              (PT, PTY, phm, p_model_lut, PG)):
        classes = [
            T.SLOClass("interactive", deadline_ms=60.0, priority=2,
                       drop_policy=T.SHED),
            T.SLOClass("batch", deadline_ms=400.0, priority=0,
                       drop_policy=T.DEGRADE),
            T.SLOClass("impossible", deadline_ms=2.0, priority=1,
                       drop_policy=T.REJECT),
        ]
        lut = luts(TY, hm, ml)
        streams = {
            "interactive": T.onoff(40.0, horizon_s, on_s=1.0, off_s=1.0,
                                   seed=1),
            "batch": T.poisson(5.0, horizon_s, seed=2),
            "impossible": T.poisson(8.0, horizon_s, seed=3),
        }
        # a budget that shrinks mid-run: preemption and starvation fire
        g_fn = (lambda G: lambda t: G(total_chips=256 if t < 1.5 else 96))(G)
        out.append((T, TY, classes, {c.name: lut for c in classes},
                    streams, g_fn))
    return out


def warmed_stores():
    """The same latency and power notes in each package's store."""
    rng = np.random.default_rng(5)
    notes = [(w, b, float(rng.uniform(5.0, 90.0)))
             for _ in range(6) for w in (0.5, 0.75, 1.0)
             for b in (1, 2, 4, 8)]
    stores = []
    for Store, TY in ((JStore, JTY), (PStore, PTY)):
        s = Store()
        for w, b, ms in notes:
            s.note_latency(TY.SubnetSpec(width_mult=w), b, ms, max_batch=8)
        s.note_power("interactive", 120.0, 400.0)
        s.note_power("batch", 30.0, 400.0)
        stores.append(s)
    return stores


@pytest.mark.parametrize("gen,kwargs", [
    ("poisson", dict(rate_rps=30.0, horizon_s=4.0)),
    ("onoff", dict(rate_rps=50.0, horizon_s=4.0, on_s=0.5, off_s=0.7)),
    ("diurnal", dict(peak_rps=40.0, horizon_s=4.0, period_s=2.0)),
])
@pytest.mark.parametrize("seed", [0, 7])
def test_arrivals_equal_reference(gen, kwargs, seed):
    a = getattr(JT, gen)(seed=seed, **kwargs)
    b = getattr(PT, gen)(seed=seed, **kwargs)
    assert len(a) > 0
    np.testing.assert_array_equal(a, b)


def test_merge_equals_reference():
    streams = {"a": JT.poisson(20.0, 2.0, seed=0),
               "b": JT.onoff(30.0, 2.0, seed=1),
               "c": [0.5, 0.5, 1.0]}
    assert PT.merge(streams) == JT.merge(streams)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_schedule_saved_by_one_loaded_by_other(writer, tmp_path):
    w, r = (JT, PT) if writer == "reference" else (PT, JT)
    multi = {"interactive": list(JT.poisson(12.0, 2.0, seed=0)),
             "batch": list(JT.poisson(6.0, 2.0, seed=1))}
    p1, p2 = str(tmp_path / "multi.json"), str(tmp_path / "one.json")
    w.save_schedule(p1, multi, meta={"kind": "test"})
    w.save_schedule(p2, multi["batch"])
    got, want = r.load_schedule(p1), w.load_schedule(p1)
    assert set(got) == set(want) == set(multi)
    for k in multi:
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(r.load_schedule(p2), w.load_schedule(p2))


def test_schedule_files_equal_reference(tmp_path):
    sched = {"x": [0.0, 0.25, 1.5], "y": list(JT.poisson(5.0, 1.0, seed=3))}
    pj, pp = str(tmp_path / "j.json"), str(tmp_path / "p.json")
    JT.save_schedule(pj, sched, meta={"kind": "test"})
    PT.save_schedule(pp, sched, meta={"kind": "test"})
    assert json.load(open(pj)) == json.load(open(pp))


@pytest.mark.parametrize("calibrated", [False, True],
                         ids=["analytic", "calibrated"])
@pytest.mark.parametrize("service_model", ["bucketed", "padded"])
@pytest.mark.parametrize("policy", ["slo", "fifo"])
def test_simulate_summary_equals_reference(policy, service_model,
                                           calibrated, v5e):
    stores = warmed_stores() if calibrated else (None, None)
    reports = []
    for (T, _, classes, lut_map, streams, g_fn), store in zip(
            both_setups(), stores):
        reports.append(T.simulate(classes, lut_map, streams, g_fn,
                                  policy=policy, service_model=service_model,
                                  calibration=store).summary())
    ref, port = reports
    assert port == ref
    for cs in ref["classes"].values():
        assert cs["submitted"] == (cs["rejected"] + cs["dropped"]
                                   + cs["failed"] + cs["completed"])
    if policy == "slo":
        assert ref["classes"]["impossible"]["rejected"] > 0


def test_simulate_tracer_spans_equal_reference(v5e):
    from repro.obs import Tracer as JTracer
    spans = []
    for (T, _, classes, lut_map, streams, g_fn), Tr in zip(
            both_setups(horizon_s=2.0), (JTracer, Tracer)):
        tr = Tr(clock=lambda: 0.0, cap=64, seed=3)
        T.simulate(classes, lut_map, streams, g_fn, tracer=tr)
        spans.append([(s.name, s.t0, s.t1, s.trace_id, s.cls, s.node,
                       s.attrs) for s in tr.spans()])
        if Tr is Tracer:
            assert validate_schema(tr.spans()) == []
            for t in tr.requests():
                check_trace(t)
    assert len(spans[0]) > 100
    assert spans[1] == spans[0]


def test_simulate_metrics_equal_reference(v5e):
    from repro.obs import MetricsRegistry as JReg
    out = []
    for (T, _, classes, lut_map, streams, g_fn), Reg in zip(
            both_setups(horizon_s=2.0), (JReg, MetricsRegistry)):
        m = Reg()
        T.simulate(classes, lut_map, streams, g_fn, metrics=m)
        out.append((m.to_json(), m.to_prometheus()))
    assert out[1] == out[0]


def test_recorded_schedule_replays_identically(tmp_path, v5e):
    """A schedule the port saved replays to the same report in both."""
    (JTm, _, jc, jl, js, jg), (PTm, _, pc, pl, ps, pg) = both_setups(2.0)
    path = str(tmp_path / "rec.json")
    PT.save_schedule(path, {k: list(v) for k, v in ps.items()})
    jr = JT.simulate(jc, jl, JT.load_schedule(path), jg).summary()
    pr = PT.simulate(pc, pl, PT.load_schedule(path), pg).summary()
    assert pr == jr


@pytest.mark.parametrize("hook", ["reliability", "watchtower"])
def test_drive_live_later_slice_hooks_raise(hook):
    """``reliability=`` and ``watchtower=`` (once refused, now ported) run
    an empty schedule to an empty report instead of raising."""
    from repro_torch.chaos import Reliability
    from repro_torch.obs import Watchtower

    class Idle:
        def start(self, g_fn):
            self.started = True

        def stop(self):
            pass

        def summary(self):
            return {}

    given = Reliability() if hook == "reliability" else Watchtower({})
    idle = Idle()
    rep = PT.drive_live([], {}, idle, {}, lambda n: None,
                        g_fn=lambda: PG(total_chips=2), **{hook: given})
    assert idle.started and rep.classes == {}
    assert rep.reliability == ({"retry_granted": 0, "retry_denied": 0}
                               if hook == "reliability" else {})


# --- live: two port servers behind the port arbiter -------------------------

def tiny_pair(store, tracer=None, metrics=None):
    from repro_torch.models.vit import ViTConfig, vit_apply, vit_init
    from repro_torch.runtime import DynamicServer
    cfg = ViTConfig(name="t", img_res=16, patch=8, n_layers=2, d_model=32,
                    n_heads=4, d_ff=64, n_classes=4, compute_dtype="float32")
    params = vit_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    dims = {"d_model": 32, "d_ff": 64, "n_heads": 4, "n_layers": 2}
    return {name: DynamicServer(
        lambda p, x, E: vit_apply(p, x, cfg, E=E)[0], params, dims,
        max_batch=4, timeout_ms=2.0, calibration=store, tenant=name,
        device="cpu") for name in ("interactive", "batch")}, dims


def test_drive_live_two_servers_behind_arbiter():
    from repro_torch.runtime import (LUT, ResourceArbiter, measured_lut)
    from repro_torch.runtime import hwmodel as hm
    store = PStore()
    tracer, metrics = Tracer(), MetricsRegistry()
    servers, _ = tiny_pair(store)
    x1 = np.random.default_rng(0).normal(size=(16, 16, 3)).astype("float32")
    specs = [PTY.SubnetSpec(), PTY.SubnetSpec(width_mult=0.5,
                                               ffn_mult=0.5)]
    lut = measured_lut(specs, lambda spec, hw: (
        servers["interactive"].measure(spec, x1[None], iters=1) / hw.freq,
        1.0))
    assert isinstance(lut, LUT) and hm.FREQ_LADDER
    for s in servers.values():
        s.warm(specs, example_input=x1)
    base = max(p.latency_ms for p in lut.points)
    classes = [PT.SLOClass("interactive", deadline_ms=base * 8, priority=2),
               PT.SLOClass("batch", deadline_ms=base * 30, priority=0,
                           drop_policy=PT.DEGRADE)]
    arbiter = ResourceArbiter(interval_s=0.05, calibration=store,
                              tracer=tracer, metrics=metrics)
    streams = {"interactive": PT.poisson(20.0, 1.0, seed=0),
               "batch": PT.poisson(8.0, 1.0, seed=1)}
    sink = []
    try:
        for c in classes:
            arbiter.register(c.name, lut, target_latency_ms=c.service_target_ms,
                             priority=c.priority, server=servers[c.name])
        rep = PT.drive_live(classes, servers, arbiter, streams,
                            lambda name: x1, g_fn=lambda: PG(total_chips=2),
                            timeout_s=60.0, tracer=tracer, metrics=metrics,
                            sink=sink)
    finally:
        arbiter.stop()
    for name, cs in rep.classes.items():
        assert cs.submitted == len(streams[name])
        assert cs.submitted == (cs.rejected + cs.dropped + cs.failed
                                + cs.completed)
        assert cs.completed == cs.submitted
        assert metrics.value("engine_served_total", tenant=name,
                             node="") == cs.completed
    assert all(s.cold_compiles == 0 for s in servers.values())
    assert validate_schema(tracer.spans()) == []
    for t in tracer.requests():
        check_trace(t)
    assert len(sink) == sum(cs.completed for cs in rep.classes.values())
    assert all(out["y"].shape == (4,) and np.isfinite(out["y"]).all()
               for _, out in sink)
    served = {k.split("/")[0] for k in store.summary()["latency"]}
    assert served and served <= {s.name() for s in specs}
    assert set(rep.arbiter) == {"interactive", "batch"}
    assert not math.isnan(rep.classes["interactive"].p(95))


@pytest.mark.cuda
def test_cuda_drive_live_smoke_through_the_kernels(tmp_path, capsys):
    """The launcher's trace mode on the card at the smoke size: every
    arrival accounted for, no cold pair, both kernels' counters rising."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    args = serve.parse_args(["--smoke", "--trace", "poisson",
                             "--trace-duration", "1", "--requests", "8",
                             "--calibrate", "--trace-out",
                             str(tmp_path / "t.json")])
    arch = get_arch(args.arch)
    cfg = arch.make_smoke()
    server = serve.build_server(arch, cfg, device="cuda")
    x = np.random.default_rng(0).normal(
        size=(server.max_batch, cfg.img_res, cfg.img_res, 3)
    ).astype(np.float32)
    _, governors, base_ms = serve.profile(server, cfg, x, trace_steps=5)
    ops.reset_launch_counts()
    run = serve.run_trace_mode(args, arch, cfg, server,
                               governors["joint (paper)"].lut, x, base_ms)
    counts = ops.launch_counts()
    for name, cs in run.report.classes.items():
        assert cs.submitted == len(run.streams[name]) == (
            cs.rejected + cs.dropped + cs.failed + cs.completed)
    assert all(s.cold_compiles == 0 for s in run.servers.values())
    assert validate_schema(run.tracer.spans()) == []
    assert counts["elastic_matmul"] > 0 and counts["flash_attention"] > 0
