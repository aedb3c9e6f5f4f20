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


def test_later_slice_hooks_raise():
    for hook in ("calibration", "tracer", "metrics"):
        with pytest.raises(NotImplementedError):
            tiny_server(**{hook: object()})


def test_no_card_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tiny_server(device=None)
