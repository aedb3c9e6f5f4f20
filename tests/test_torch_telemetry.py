"""The port's measurement loop against the JAX package's on the CPU: the
CalibrationStore after the same notes (summaries, blends, projections and
power scales compared exactly), its JSON saved by either package and
loaded by the other, the calibrated and analytic bucket columns; and the
port engine feeding the store, the arbiter's arrival EWMA and the
adaptive batching window on the CPU.
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.runtime as JR  # noqa: E402
import repro_torch.runtime as PR  # noqa: E402
from repro.core import types as JTY  # noqa: E402
from repro.runtime import hwmodel as jhm  # noqa: E402
from repro.runtime import lut as jlut  # noqa: E402
from repro_torch.core import types as PTY  # noqa: E402
from repro_torch.runtime import hwmodel as phm  # noqa: E402
from repro_torch.runtime import lut as plut  # noqa: E402

torch.set_num_threads(2)
TERMS = (0.02, 0.008, 0.004)
WIDTHS = (0.5, 0.75, 1.0)


def notes(seed):
    """A seeded run of latency, power and energy observations."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(int(rng.integers(20, 80))):
        kind = rng.choice(["lat", "lat", "lat", "pow", "energy"])
        if kind == "lat":
            out.append(("lat", float(rng.choice(WIDTHS)),
                        int(rng.choice([1, 2, 4, 8])),
                        float(rng.uniform(1.0, 60.0))))
        elif kind == "pow":
            out.append(("pow", str(rng.choice(["a", "b"])),
                        float(rng.uniform(10, 300)),
                        float(rng.uniform(100, 400))))
        else:
            out.append(("energy", str(rng.choice(["a", "b"])),
                        float(rng.uniform(-5, 500)),
                        float(rng.uniform(0.0, 2.0))))
    return out


def store_after(Store, TY, seq):
    s = Store()
    for kind, *args in seq:
        if kind == "lat":
            w, b, ms = args
            s.note_latency(TY.SubnetSpec(width_mult=w), b, ms, max_batch=8)
        elif kind == "pow":
            s.note_power(*args)
        else:
            s.note_energy(*args)
    return s


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_store_equals_reference_after_same_notes(seed):
    seq = notes(seed)
    j = store_after(JR.CalibrationStore, JTY, seq)
    p = store_after(PR.CalibrationStore, PTY, seq)
    assert p.summary() == j.summary()
    assert p.version() == j.version()
    for w in WIDTHS:
        js, ps = JTY.SubnetSpec(width_mult=w), PTY.SubnetSpec(width_mult=w)
        assert p.point_latency_ms(ps, 33.0) == j.point_latency_ms(js, 33.0)
        for b in (1, 2, 4, 8, 16):
            assert p.latency_ms(ps, b) == j.latency_ms(js, b)
            assert p.latency_samples(ps, b) == j.latency_samples(js, b)
            assert p.blended_latency_ms(ps, b, 20.0) == \
                j.blended_latency_ms(js, b, 20.0)
    for t in ("a", "b", "c"):
        assert p.power_scale(t) == j.power_scale(t)
        assert p.busy_power_w(t) == j.busy_power_w(t)
        assert p.power_samples(t) == j.power_samples(t)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_store_json_loads_in_the_other_package(writer, tmp_path):
    seq = notes(3)
    j = store_after(JR.CalibrationStore, JTY, seq)
    p = store_after(PR.CalibrationStore, PTY, seq)
    path = str(tmp_path / "cal.json")
    src, Other = (j, PR.CalibrationStore) if writer == "reference" \
        else (p, JR.CalibrationStore)
    src.save(path)
    again = Other.load(path)
    want = src.summary()
    want["version"] = 1           # load() starts a fresh version count
    assert again.summary() == want
    # and each package's own round trip agrees with the other's
    pp, jp = str(tmp_path / "p.json"), str(tmp_path / "j.json")
    p.save(pp)
    j.save(jp)
    assert PR.CalibrationStore.load(pp).summary() == \
        JR.CalibrationStore.load(jp).summary()
    assert open(pp).read() == open(jp).read()


@pytest.mark.parametrize("calibrated", [False, True])
@pytest.mark.parametrize("max_batch", [1, 6, 8, 16])
def test_bucket_columns_equal_reference(max_batch, calibrated):
    seq = notes(7)
    stores = ((store_after(JR.CalibrationStore, JTY, seq),
               store_after(PR.CalibrationStore, PTY, seq))
              if calibrated else (None, None))
    cols = []
    for (R, TY, hm, lut_mod), store in zip(
            ((JR, JTY, jhm, jlut), (PR, PTY, phm, plut)), stores):
        space = TY.ElasticSpace(width_mults=WIDTHS)
        lut = R.model_lut(space.enumerate(),
                          full_terms=hm.RooflineTerms(*TERMS),
                          full_chips=16)
        col = []
        for point in lut.points[:12]:
            col.append(lut.bucket_latencies(point, max_batch,
                                            calibration=store))
            for b in (1, 2, 3, 4, 8, 16):
                col.append(lut_mod.bucket_latency_ms(
                    point.latency_ms, b, max_batch, calibration=store,
                    spec=point.subnet))
                col.append(lut_mod.bucket_for(b, max_batch))
        cols.append(col)
    assert cols[1] == cols[0]
    assert plut.BUCKET_OVERHEAD_FRAC == jlut.BUCKET_OVERHEAD_FRAC


# --- the port engine feeding the loop ---------------------------------------

def tiny_server(**kw):
    from repro_torch.models.vit import ViTConfig, vit_apply, vit_init
    cfg = ViTConfig(name="t", img_res=16, patch=8, n_layers=2, d_model=32,
                    n_heads=4, d_ff=64, n_classes=4, compute_dtype="float32")
    params = vit_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    dims = {"d_model": 32, "d_ff": 64, "n_heads": 4, "n_layers": 2}
    kw.setdefault("device", "cpu")
    return PR.DynamicServer(lambda p, x, E: vit_apply(p, x, cfg, E=E)[0],
                            params, dims, **kw)


def test_out_of_order_completion_never_integrates_negative_energy():
    from repro_torch.runtime.engine import _InFlight
    store = PR.CalibrationStore()
    server = tiny_server(calibration=store, tenant="api")
    server._last_ready = time.perf_counter() + 100.0
    stale = _InFlight(out=torch.zeros((1, 4)), ready=None, reqs=[],
                      t_dispatch=time.perf_counter() - 1.0,
                      hw=phm.HwState(chips=1, freq=1.0), subnet="full",
                      buf_key=(1, (), "f4"), buf=None, spec=PTY.SubnetSpec(),
                      bucket=1)
    server._complete(stale)
    assert server.busy_s == 0.0 and server.measured_energy_mj == 0.0
    assert server._last_ready >= time.perf_counter() + 50.0
    # the latency is still noted; no energy row for a zero interval
    assert store.latency_samples(PTY.SubnetSpec(), 1) == 1
    assert store.busy_power_w("api") is None


def test_arbiter_smooths_live_arrivals_exactly_once():
    """The arbiter pulls the server's arrival count once per interval (on
    its own clock) and pushes the EWMA back to size the adaptive window."""
    clock = [0.0]
    server = tiny_server(max_batch=4, timeout_ms=20.0, adaptive_window=True,
                         min_window_ms=0.5)
    space = PTY.ElasticSpace(width_mults=(0.5, 1.0))
    lut = PR.model_lut(space.enumerate(),
                       full_terms=phm.RooflineTerms(*TERMS), full_chips=4)
    arb = PR.ResourceArbiter(interval_s=0.1, time_fn=lambda: clock[0])
    arb.register("a", lut, target_latency_ms=1e9, server=server)
    server.pause()                      # arrivals queue, nothing runs
    x1 = np.zeros((16, 16, 3), "float32")
    futs = [server.submit(x1) for _ in range(50)]
    assert server.queue_depth() == 50
    arb.tick(PR.GlobalConstraints(total_chips=4))    # first window: 0.1 s
    assert arb.summary()["a"]["arrival_ewma_rps"] == pytest.approx(
        0.4 * 50 / 0.1)
    assert server.take_arrival_count() == 0          # drained once
    assert server.effective_timeout_s() == pytest.approx(1.0 / 200.0)
    clock[0] += 0.01                                 # a partial window:
    arb.tick(PR.GlobalConstraints(total_chips=4))    # not smoothed again
    assert arb.summary()["a"]["arrival_ewma_rps"] == pytest.approx(200.0)
    server.stop()
    assert all(f.get(timeout=10)["cancelled"] for f in futs)
    server.adaptive_window = False
    assert server.effective_timeout_s() == server.timeout_s
