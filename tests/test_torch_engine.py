"""The PyTorch port's DynamicServer on the CPU, mirroring
tests/test_bucketed.py: bucketed == unbucketed, zero cold (subnet, bucket)
pairs after warm, unwarmed buckets counted, pad-to-max, stop/pause races
resolving every future, non-overlapping accounting — plus served outputs
equal to a direct ``vit_apply`` of the port and of the JAX reference.
"""
import threading
import time

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import numpy as np  # noqa: E402

from repro_torch.core.types import SubnetSpec  # noqa: E402
from repro_torch.models.vit import ViTConfig, vit_apply, vit_init  # noqa: E402
from repro_torch.runtime import DynamicServer  # noqa: E402
from repro_torch.runtime.lut import bucket_ladder  # noqa: E402

torch.set_num_threads(2)
CFG = ViTConfig(name="t", img_res=16, patch=8, n_layers=2, d_model=32,
                n_heads=4, d_ff=64, n_classes=4, compute_dtype="float32")
DIMS = {"d_model": 32, "d_ff": 64, "n_heads": 4, "n_layers": 2}


def tiny_server(**kw):
    params = vit_init(torch.Generator().manual_seed(0), CFG, device="cpu")
    kw.setdefault("device", "cpu")
    return DynamicServer(lambda p, x, E: vit_apply(p, x, CFG, E=E)[0],
                         params, DIMS, **kw)


def test_bucketed_padding_bit_exact_vs_unbucketed():
    server = tiny_server(max_batch=8, timeout_ms=50.0)
    xs = np.random.default_rng(0).normal(size=(3, 16, 16, 3)).astype("float32")
    server.start()
    try:
        outs = [f.get(timeout=60) for f in
                [server.submit(xs[i]) for i in range(3)]]
    finally:
        server.stop()
    assert all(not o.get("cancelled") for o in outs)
    padded = np.concatenate([xs, np.zeros((5, 16, 16, 3), "float32")])
    ref = server.infer(padded).numpy()
    for i, o in enumerate(outs):
        assert o["y"].dtype == np.float32
        assert np.array_equal(o["y"], ref[i])


def test_served_outputs_equal_direct_apply_and_jax():
    """What the server answers is the port's vit_apply at the active spec,
    which in turn matches the JAX reference on the same weights."""
    from repro.core.elastic import spec_to_static
    from repro.models import vit as JV
    from repro_torch.convert import vit_params
    jcfg = JV.ViTConfig(name="t", img_res=16, patch=8, n_layers=2,
                        d_model=32, n_heads=4, d_ff=64, n_classes=4,
                        compute_dtype="float32")
    jp = JV.vit_init(jax.random.PRNGKey(3), jcfg)
    params = vit_params(jax.tree_util.tree_map(np.asarray, jp))
    spec = SubnetSpec(width_mult=0.5, ffn_mult=0.5, heads_mult=0.5,
                      depth_mult=0.5)
    server = DynamicServer(lambda p, x, E: vit_apply(p, x, CFG, E=E)[0],
                           params, DIMS, max_batch=2, device="cpu")
    server.switch(spec)
    x = np.random.default_rng(1).normal(size=(16, 16, 3)).astype("float32")
    server.start()
    try:
        y = server.submit(x).get(timeout=60)["y"]
    finally:
        server.stop()
    E = spec_to_static(spec, DIMS)
    direct, _ = vit_apply(params, torch.from_numpy(x[None]), CFG, E=E)
    np.testing.assert_array_equal(y, direct[0].numpy())
    yj, _ = JV.vit_apply(jp, x[None], jcfg, E=E)
    np.testing.assert_allclose(y, np.asarray(yj)[0], rtol=2e-4, atol=2e-4)


def test_zero_cold_compiles_after_ladder_warmup():
    x1 = np.zeros((16, 16, 3), "float32")
    half = SubnetSpec(width_mult=0.5, ffn_mult=0.5, depth_mult=0.5)
    server = tiny_server(max_batch=4, timeout_ms=2.0,
                         warm_specs=[SubnetSpec(), half], example_input=x1)
    assert server.cold_compiles == 0
    server.start()
    try:
        futs = []
        for spec in (SubnetSpec(), half, SubnetSpec()):
            server.switch(spec)
            for k in (1, 2, 3, 4):            # hit every bucket
                futs += [server.submit(x1) for _ in range(k)]
                time.sleep(0.01)
        outs = [f.get(timeout=60) for f in futs]
    finally:
        server.stop()
    assert all(not o.get("cancelled") for o in outs)
    assert server.cold_compiles == 0
    assert all(not e["cold"] for e in server.switch_log)


def test_unwarmed_buckets_counted_cold():
    x1 = np.zeros((16, 16, 3), "float32")
    server = tiny_server(max_batch=4, timeout_ms=2.0)
    server.start()
    try:
        assert server.submit(x1).get(timeout=60)["y"].shape == (4,)
    finally:
        server.stop()
    assert server.cold_compiles >= 1


def test_no_buckets_restores_pad_to_max():
    server = tiny_server(max_batch=4, batch_buckets=False)
    assert server.buckets == (4,)
    assert server._bucket_for(1) == 4
    assert tiny_server(max_batch=8).buckets == bucket_ladder(8)


def test_pipelined_resolution_under_stop_race():
    x1 = np.zeros((16, 16, 3), "float32")
    server = tiny_server(max_batch=2, timeout_ms=1.0, pipeline=True)
    server.start()
    futs = [server.submit(x1) for _ in range(40)]
    time.sleep(0.05)
    server.stop()
    outs = [f.get(timeout=10) for f in futs]
    answered = [o for o in outs if not o.get("cancelled")]
    cancelled = [o for o in outs if o.get("cancelled")]
    assert len(answered) + len(cancelled) == 40
    assert all(o["y"].shape == (4,) for o in answered)
    assert server.served == len(answered)
    assert server.cancelled == len(cancelled)


def test_pipelined_resolution_under_pause_churn():
    x1 = np.zeros((16, 16, 3), "float32")
    server = tiny_server(max_batch=2, timeout_ms=1.0, pipeline=True)
    server.start()
    stop_churn = threading.Event()

    def churn():
        while not stop_churn.is_set():
            server.pause()
            time.sleep(0.002)
            server.resume()
            time.sleep(0.002)

    th = threading.Thread(target=churn, daemon=True)
    th.start()
    try:
        outs = [f.get(timeout=60) for f in
                [server.submit(x1) for _ in range(30)]]
    finally:
        stop_churn.set()
        th.join(timeout=10)
        server.stop()
    assert not th.is_alive()
    assert all(o["y"].shape == (4,) for o in outs)
    assert server.served == 30


def test_accounting_non_overlapping_under_pipeline():
    x1 = np.zeros((16, 16, 3), "float32")
    server = tiny_server(max_batch=1, timeout_ms=0.5, pipeline=True)
    t0 = time.perf_counter()
    server.start()
    for f in [server.submit(x1) for _ in range(20)]:
        f.get(timeout=60)
    server.stop()
    span = time.perf_counter() - t0
    assert 0.0 < server.busy_s <= span
    assert server.measured_energy_mj > 0.0


def test_synchronous_dispatch_and_pad_pool_reuse():
    x1 = np.zeros((16, 16, 3), "float32")
    server = tiny_server(max_batch=2, timeout_ms=1.0, pipeline=False)
    server.start()
    try:
        for _ in range(3):
            assert server.submit(x1).get(timeout=60)["y"].shape == (4,)
    finally:
        server.stop()
    # one staging buffer per (bucket, shape, dtype), recycled, never grown
    assert all(len(v) == 1 for v in server._pad_pool.values())


def test_queue_depth_ignores_wake_tokens():
    x1 = np.zeros((16, 16, 3), "float32")
    server = tiny_server()
    server.pause()
    assert server.queue_depth() == 0
    futs = [server.submit(x1) for _ in range(3)]
    assert server.queue_depth() == 3
    server.stop()
    assert all(f.get(timeout=5)["cancelled"] for f in futs)
    assert server.queue_depth() == 0


def test_measure_returns_wall_clock_ms():
    server = tiny_server(max_batch=2)
    x = np.zeros((2, 16, 16, 3), "float32")
    assert server.measure(SubnetSpec(), x, iters=2) > 0.0


@pytest.mark.parametrize("hook", ["calibration", "tracer", "metrics"])
def test_hooks_record(hook):
    """Each hook records what it should: the calibration store the
    (subnet, bucket) latency and the tenant's energy, the tracer a
    schema-valid span tree per request whose components sum to its
    latency, the registry the served counter and latency histogram."""
    from repro_torch.obs import MetricsRegistry, Tracer, validate_schema
    from repro_torch.obs.analyze import check_trace
    from repro_torch.runtime import CalibrationStore
    obj = {"calibration": CalibrationStore, "tracer": Tracer,
           "metrics": MetricsRegistry}[hook]()
    x1 = np.zeros((16, 16, 3), "float32")
    server = tiny_server(max_batch=4, timeout_ms=5.0, tenant="api",
                         warm_specs=[SubnetSpec()], example_input=x1,
                         **{hook: obj})
    server.start()
    try:
        outs = [f.get(timeout=60) for f in
                [server.submit(x1) for _ in range(6)]]
    finally:
        server.stop()
    assert all(not o.get("cancelled") for o in outs)
    if hook == "calibration":
        lat = obj.summary()["latency"]
        assert lat and all(k.startswith("w1-f1-h1-d1/b") for k in lat)
        assert sum(v["n"] for v in lat.values()) >= 2
        assert obj.busy_power_w("api") is not None
    elif hook == "tracer":
        trees = obj.requests()
        assert len(trees) == 6 and {t.cls for t in trees} == {"api"}
        assert validate_schema(obj.spans()) == []
        for t in trees:
            check_trace(t)
            assert [s.name for s in t.spans] == [
                "queue", "collect", "stack", "dispatch", "device",
                "complete"]
    else:
        assert obj.value("engine_served_total", tenant="api", node="") == 6
        h = obj.histogram("engine_request_ms", tenant="api", node="")
        assert h.count == 6
        server.submit(x1)          # a stopped server cancels and counts it
        assert obj.value("engine_cancelled_total", tenant="api",
                         node="") == 1


def test_no_card_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tiny_server(device=None)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def card_server(dev, **kw):
    params = vit_init(torch.Generator().manual_seed(0), CFG, device=dev)
    return DynamicServer(lambda p, x, E: vit_apply(p, x, CFG, E=E)[0],
                         params, DIMS, device=dev, **kw)


@pytest.mark.cuda
def test_cuda_graph_served_batch_equals_eager(card):
    """On the card every (spec, bucket) is a CUDA graph captured at warm:
    a served batch is the eager forward of the same padded batch, bit for
    bit (the same kernels in the same order), and serving meets no cold
    pair."""
    from repro_torch.core.elastic import spec_to_static
    from repro_torch.kernels import ops
    specs = [SubnetSpec(), SubnetSpec(width_mult=0.5, heads_mult=0.5)]
    x1 = np.random.default_rng(0).normal(size=(16, 16, 3)).astype("float32")
    server = card_server(card, max_batch=4, timeout_ms=50.0)
    server.warm(specs, example_input=x1)
    assert server.captures == len(specs) * len(server.buckets)
    xs = np.stack([x1 * (i + 1) for i in range(3)])
    ops.reset_launch_counts()
    server.active_spec = specs[1]
    server.start()
    try:
        outs = [f.get(timeout=60) for f in
                [server.submit(xs[i]) for i in range(3)]]
    finally:
        server.stop()
    assert server.cold_compiles == 0 and all(not o.get("cancelled")
                                             for o in outs)
    assert ops.launch_counts()["elastic_matmul"] > 0   # counted on replay
    padded = torch.from_numpy(np.concatenate(
        [xs, np.zeros((1, 16, 16, 3), "float32")])).to(card)
    with torch.inference_mode():
        eager = vit_apply(server.params, padded, CFG,
                          E=spec_to_static(specs[1], DIMS))[0]
    served = np.stack([o["y"] for o in outs if o["subnet"] ==
                       specs[1].name()])
    if len(served) == 3:                   # one batch of 3: bucket 4
        assert np.array_equal(served, eager[:3].float().cpu().numpy())
    direct = server.infer(xs, specs[1])
    assert torch.equal(direct, eager[:3])


@pytest.mark.cuda
def test_cuda_cold_dispatch_captures_and_measure_replays(card):
    """A (spec, bucket) that warm never captured is captured on the serve
    path and counted in cold_compiles; measure() times replays of the
    graph of its batch's bucket (no new capture, launches counted per
    replay)."""
    from repro_torch.kernels import ops
    x1 = np.zeros((16, 16, 3), "float32")
    server = card_server(card, max_batch=4, timeout_ms=1.0)
    server.start()
    try:
        out = server.submit(x1).get(timeout=60)
    finally:
        server.stop()
    assert not out.get("cancelled")
    assert server.cold_compiles == 1 and server.captures == 1
    ops.reset_launch_counts()
    ms = server.measure(SubnetSpec(), np.stack([x1]), iters=3)
    assert ms > 0 and server.captures == 1          # bucket 1: captured
    per_forward = ops.launch_counts()["elastic_matmul"] // 4
    assert per_forward > 0 and \
        ops.launch_counts()["elastic_matmul"] == 4 * per_forward
    server.measure(SubnetSpec(), np.stack([x1] * 3), iters=3)
    assert server.captures == 2                     # bucket 4, once
    assert server.graph_pool_bytes() > 0
