"""Serving launcher: the paper's deployed system, on the card.

``python -m repro_torch.launch.serve --arch dynamic-ofa-supernet``

Brings up the port's DynamicServer (sub-network executable cache + bucketed
continuous batching + pipelined dispatch) over the port's ViT, whose dense
layers and attention run on the hand-written CUDA kernels, with the
JointGovernor in the loop.  It profiles a measured LUT on the device,
drives the governors through the paper's workload trace (changing latency
targets, thermal throttling, co-running apps), prints the monitor summary
next to the Linux-governor baselines, then serves requests.

Serving data-path knobs (mirrored by ``DynamicServer``):

* ``--max-batch N``   — batching ceiling; the bucket ladder is the powers
  of two up to N (requests are padded only to the nearest bucket);
* ``--no-buckets``    — pad every batch to max_batch;
* ``--no-pipeline``   — dispatch synchronously instead of overlapping
  batch N+1's host-side stacking with batch N's device time;
* ``--device``        — ``cuda`` (default; raises without a card) or
  ``cpu`` (the kernels' plain versions).

The SLO-traffic (``--trace``), cluster, calibration and observability
modes of the reference launcher come with a later slice of the port; the
launcher refuses their flags.  The governed server warms its bucket ladder
for the profiled subnets before taking traffic, so serving meets zero cold
(subnet, bucket) pairs (``server.cold_compiles`` stays 0).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.types import SubnetSpec
from repro_torch.device import resolve_device
from repro_torch.obs.metrics import quantile
from repro_torch.runtime import (Constraints, DynamicServer, JointGovernor,
                                 PerformanceGovernor, SchedutilGovernor,
                                 StaticPrunedGovernor, measured_lut,
                                 paper_trace, run_governor)
from repro_torch.runtime import hwmodel as hm

# flags of the reference launcher that wait for a later slice of the port
_LATER = ("trace", "nodes", "router", "record", "calibrate", "calibrate_out",
          "health_interval", "rebalance_interval", "trace_out", "metrics_out",
          "stream_trace", "alerts_out", "profile_out")


def build_server(arch, cfg, *, max_batch=8, batch_buckets=True,
                 pipeline=True, device=None, seed=0):
    """The supernet (random weights from ``seed``) behind a DynamicServer on
    ``device`` (the card unless the caller passes ``"cpu"``)."""
    dev = resolve_device(device)
    if not arch.arch_id.startswith(("deit", "vit", "dynamic-ofa")):
        raise SystemExit("serve launcher: vision transformer archs only "
                         "(the paper serves image classification)")
    from repro_torch.models.vit import cast_params, vit_apply, vit_init
    gen = torch.Generator().manual_seed(seed)
    # resident weights in the compute dtype: vit_apply casts each weight to
    # it at use, so this gives the same numbers with no copy per call
    params = cast_params(vit_init(gen, cfg, device=dev), cfg.cdtype())
    dims = {"d_model": cfg.d_model, "d_ff": cfg.d_ff,
            "n_heads": cfg.n_heads, "n_layers": cfg.n_layers}
    apply_fn = lambda p, x, E: vit_apply(p, x, cfg, E=E)[0]
    return DynamicServer(apply_fn, params, dims, max_batch=max_batch,
                         batch_buckets=batch_buckets, pipeline=pipeline,
                         device=dev)


def serve_specs(cfg):
    """The Pareto subnets the launcher profiles: max, min and the first 24
    of the elastic space."""
    return list(dict.fromkeys(
        [cfg.elastic.max_spec(), cfg.elastic.min_spec()]
        + list(cfg.elastic.enumerate(limit=24))))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="dynamic-ofa-supernet")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; the card) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and request images")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--trace-steps", type=int, default=200)
    ap.add_argument("--max-batch", type=int, default=8,
                    help="batching ceiling (bucket ladder = powers of two)")
    ap.add_argument("--no-buckets", action="store_true",
                    help="pad every batch to max_batch (baseline data path)")
    ap.add_argument("--no-pipeline", action="store_true",
                    help="synchronous dispatch (no host/device overlap)")
    for name in _LATER:
        ap.add_argument("--" + name.replace("_", "-"), default=None,
                        help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    given = ["--" + n.replace("_", "-") for n in _LATER
             if getattr(args, n) is not None]
    if given:
        ap.error(f"{', '.join(given)}: the trace, cluster, calibration and "
                 f"observability modes come with a later slice of the port")
    return args


def profile(server, cfg, x, *, trace_steps: int = 200):
    """Measured LUT over :func:`serve_specs` on the serving device, then the
    paper's workload trace through the joint governor and the baselines.
    Returns (specs, governors, base_ms)."""
    specs = serve_specs(cfg)

    # freq modelled; latency wall-clock on the device
    def measure(spec, hw):
        lat = server.measure(spec, x) / hw.freq
        terms = hm.RooflineTerms(lat / 1e3, 0.0, 0.0)
        return lat, hm.step_energy_mj(terms, hw)

    lut = measured_lut(specs, measure)
    print(f"profiled {len(lut.points)} operating points over "
          f"{len(specs)} subnets")
    full = SubnetSpec()
    base_ms = float(np.median([p.latency_ms for p in lut.points
                               if p.subnet == full]))
    governors = {
        "joint (paper)": JointGovernor(lut),
        "performance": PerformanceGovernor(lut, full),
        "schedutil": SchedutilGovernor(lut, full),
        "static-pruned": StaticPrunedGovernor(
            lut, worst_case=Constraints(target_latency_ms=base_ms * 0.8,
                                        chips_available=1)),
    }
    print(f"\nworkload trace: {trace_steps} steps, base target "
          f"{base_ms:.2f}ms")
    for name, gov in governors.items():
        mon = run_governor(gov, paper_trace(trace_steps, chips=1,
                                            base_target_ms=base_ms))
        print(f"  {name:16s} {mon.summary()}")
    return specs, governors, base_ms


def serve_requests(server, governor, base_ms: float, x1, n_requests: int):
    """Serve ``n_requests`` copies of image ``x1`` with ``governor`` in the
    loop (target ``base_ms``); every future is awaited.  Returns the
    resolved payloads."""
    constraints = lambda: Constraints(target_latency_ms=base_ms,
                                      chips_available=1)
    server.governor = governor
    server.start(constraints_fn=constraints)
    try:
        futs = [server.submit(x1) for _ in range(n_requests)]
        outs = [f.get(timeout=60) for f in futs]
    finally:
        server.stop()
    lats = [o["latency_ms"] for o in outs]
    print(f"\nserved {len(outs)} requests  p50={quantile(lats, 50):.1f}ms "
          f"p99={quantile(lats, 99):.1f}ms  "
          f"subnets used: {sorted(set(str(o['subnet']) for o in outs))}")
    print(f"switches: {len(server.switch_log)} "
          f"(dropped {server.switch_log_dropped} log entries), "
          f"cold compiles while serving: {server.cold_compiles}, "
          f"buckets: {server.buckets}, pipeline: {server.pipeline}")
    return outs


def main(argv=None):
    args = parse_args(argv)
    arch = get_arch(args.arch)
    cfg = arch.make_smoke() if args.smoke else arch.make_config()
    server = build_server(arch, cfg, max_batch=args.max_batch,
                          batch_buckets=not args.no_buckets,
                          pipeline=not args.no_pipeline, device=args.device,
                          seed=args.seed)
    print(f"serving {cfg.name} on {server.device}"
          + (f" ({torch.cuda.get_device_name(server.device)})"
             if server.device.type == "cuda" else ""))
    x = np.random.default_rng(args.seed).normal(
        size=(server.max_batch, cfg.img_res, cfg.img_res, 3)
    ).astype(np.float32)
    specs, governors, base_ms = profile(server, cfg, x,
                                        trace_steps=args.trace_steps)
    # warm the bucket ladder for every profiled subnet (anything the
    # governor may pick) so serving starts with no cold (subnet, bucket)
    server.warm(specs, example_input=x[0])
    serve_requests(server, governors["joint (paper)"], base_ms, x[0],
                   args.requests)


if __name__ == "__main__":
    main()
