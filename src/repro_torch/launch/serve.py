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

Cluster / trace knobs (``--trace`` mode):

* ``--trace poisson|bursty|diurnal|PATH`` — two SLO classes (an
  interactive tenant and a background batch tenant), each a DynamicServer
  of the same supernet, behind one ResourceArbiter; open-loop seeded
  arrivals (or a recorded schedule) through ``traffic.drive_live``;
* ``--trace-duration S`` — seconds of arrival schedule;
* ``--nodes N``       — scale the SLO classes out over N arbiter-governed
  nodes (two modelled chips each) behind the cluster front-end
  (``repro_torch.cluster``); every replica is its own DynamicServer on
  the same device, warmed before traffic;
* ``--router p2c|round_robin|least_loaded`` — the routing policy;
* ``--health-interval S`` — cluster mode: run the stall-based health
  checker every S seconds (a node whose completions stay flat with
  futures outstanding is failed over);
* ``--rebalance-interval S`` — cluster mode: run the placement engine
  every S seconds (migration-cost-priced rebalancing + preemption);
* ``--record PATH``   — save the ACTUAL arrivals as a replayable
  schedule JSON (feed it back via ``--trace PATH``);
* ``--calibrate``     — close the measurement loop: servers record
  per-(subnet, bucket) latency EWMAs and measured tenant energy into a
  ``CalibrationStore`` the arbiter plans off; ``--calibrate-out PATH``
  additionally saves the warmed store as JSON for calibrated replays.

Observability (any mode):

* ``--trace-out PATH``   — record request span trees + decision spans
  through a :class:`repro_torch.obs.Tracer` and write them as Chrome
  trace-event JSON (load in Perfetto / chrome://tracing); also prints
  the per-class p50/p95 latency decomposition;
* ``--metrics-out PATH`` — write the metrics registry snapshot as JSON,
  or Prometheus text format when PATH ends in ``.prom``;
* ``--stream-trace PATH`` — stream trace events to PATH as requests
  retire (incremental Perfetto JSON, loadable mid-run);
* ``--alerts-out PATH``  — ``--trace`` mode: run the SLO watchtower
  (burn-rate alerts + attribution) against the live run and write the
  alert log to PATH;
* ``--profile-out PATH`` — write the per-(subnet, bucket) device profile
  from the retained DEVICE spans to PATH.

Every server warms its bucket ladder for the profiled subnets before taking
traffic, so serving meets zero cold (subnet, bucket) pairs
(``server.cold_compiles`` stays 0).  On the card each (subnet, bucket)
is a CUDA graph, captured when first measured or warmed: the measured
LUT, ``--calibrate`` and the served requests all time graph replays, as
the reference's time compiled executables.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.cluster import Cluster, ClusterNode
from repro_torch.configs import get_arch
from repro_torch.core.types import SubnetSpec
from repro_torch.device import resolve_device
from repro_torch.obs import (MetricsRegistry, TraceStreamer, Tracer,
                             Watchtower, decompose_latency, default_windows,
                             format_alerts, format_decomposition,
                             format_profile, profile_devices, quantile,
                             write_chrome_trace)
from repro_torch.runtime import (CalibrationStore, Constraints, DynamicServer,
                                 GlobalConstraints, JointGovernor,
                                 PerformanceGovernor, ResourceArbiter,
                                 SchedutilGovernor, StaticPrunedGovernor,
                                 measured_lut, paper_trace, run_governor)
from repro_torch.runtime import hwmodel as hm
from repro_torch.traffic import (DEGRADE, SLOClass, TrafficReport, diurnal,
                                 drive_live, load_schedule, onoff, poisson)

def build_server(arch, cfg, *, max_batch=8, batch_buckets=True,
                 pipeline=True, device=None, seed=0, calibration=None,
                 tenant=None):
    """The supernet (random weights from ``seed``) behind a DynamicServer on
    ``device`` (the card unless the caller passes ``"cpu"``)."""
    dev = resolve_device(device)
    if not arch.arch_id.startswith(("deit", "vit", "dynamic-ofa")):
        raise SystemExit("serve launcher: vision transformer archs only "
                         "(the paper serves image classification)")
    from repro_torch.core.layers import cast_params
    from repro_torch.models.vit import vit_apply, vit_init
    gen = torch.Generator().manual_seed(seed)
    # resident weights in the compute dtype: vit_apply casts each weight to
    # it at use, so this gives the same numbers with no copy per call
    params = cast_params(vit_init(gen, cfg, device=dev), cfg.cdtype())
    dims = {"d_model": cfg.d_model, "d_ff": cfg.d_ff,
            "n_heads": cfg.n_heads, "n_layers": cfg.n_layers}
    apply_fn = lambda p, x, E: vit_apply(p, x, cfg, E=E)[0]
    return DynamicServer(apply_fn, params, dims, max_batch=max_batch,
                         batch_buckets=batch_buckets, pipeline=pipeline,
                         calibration=calibration, tenant=tenant, device=dev)


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
    ap.add_argument("--trace", default=None,
                    help="SLO traffic mode: poisson | bursty | diurnal | "
                         "path to a recorded schedule JSON")
    ap.add_argument("--trace-duration", type=float, default=5.0,
                    help="seconds of arrival schedule in --trace mode")
    ap.add_argument("--nodes", type=int, default=1,
                    help="cluster mode: N arbiter-governed nodes behind "
                         "the router (--trace only)")
    ap.add_argument("--router", default="p2c",
                    choices=["p2c", "round_robin", "least_loaded"],
                    help="cluster routing policy for --nodes > 1")
    ap.add_argument("--record", default=None, metavar="PATH",
                    help="record the ACTUAL --trace arrivals to a "
                         "replayable schedule JSON")
    ap.add_argument("--calibrate", action="store_true",
                    help="close the measurement loop: record measured "
                         "(subnet, bucket) latency + tenant energy and "
                         "let the arbiter plan off it")
    ap.add_argument("--calibrate-out", default=None, metavar="PATH",
                    help="save the warmed CalibrationStore as JSON "
                         "(implies nothing without --calibrate)")
    ap.add_argument("--health-interval", type=float, default=None,
                    metavar="S",
                    help="cluster mode: stall-based health check every "
                         "S seconds (auto-failover of wedged nodes)")
    ap.add_argument("--rebalance-interval", type=float, default=None,
                    metavar="S",
                    help="cluster mode: run the global placement engine "
                         "every S seconds (migration-cost-priced replica "
                         "rebalancing + cross-node preemption)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="record request span trees + decision spans and "
                         "write Chrome trace-event JSON (open in Perfetto "
                         "or chrome://tracing); prints the p50/p95 "
                         "latency decomposition")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the metrics snapshot as JSON (Prometheus "
                         "text format when PATH ends in .prom)")
    ap.add_argument("--stream-trace", default=None, metavar="PATH",
                    help="stream trace events to PATH as requests retire "
                         "(incremental Perfetto JSON — loadable mid-run "
                         "or after a crash)")
    ap.add_argument("--alerts-out", default=None, metavar="PATH",
                    help="--trace mode: run the SLO watchtower (burn-rate "
                         "alerts + attribution) against the live run and "
                         "write the alert log to PATH")
    ap.add_argument("--profile-out", default=None, metavar="PATH",
                    help="write the per-(subnet, bucket) device profile "
                         "(device time, share of the card's peak when "
                         "given FLOPs) from retained DEVICE spans to PATH")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="batching ceiling (bucket ladder = powers of two)")
    ap.add_argument("--no-buckets", action="store_true",
                    help="pad every batch to max_batch (baseline data path)")
    ap.add_argument("--no-pipeline", action="store_true",
                    help="synchronous dispatch (no host/device overlap)")
    return ap.parse_args(argv)


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


@dataclasses.dataclass
class TraceRun:
    """What one ``--trace`` run built and measured.  In cluster mode
    (``--nodes`` > 1) ``arbiter`` is the :class:`Cluster` and ``servers``
    holds every replica the run placed, keyed ``"node/class"``."""
    report: TrafficReport
    classes: List[SLOClass]
    streams: Dict[str, List[float]]
    servers: Dict[str, DynamicServer]
    arbiter: Union[ResourceArbiter, Cluster]
    tracer: Optional[Tracer]
    metrics: Optional[MetricsRegistry]
    store: Optional[CalibrationStore]
    watchtower: Optional[Watchtower] = None


def run_trace_mode(args, arch, cfg, server, lut, x, base_ms, *,
                   sink: Optional[list] = None) -> TraceRun:
    """``--trace``: SLO-classed request streams through the arbiter.

    Two tenants (an interactive class and a background batch class) run
    as separate DynamicServers of the same supernet behind one
    ResourceArbiter on two modelled 1-chip slices; the traffic layer
    replays a seeded arrival schedule (or a recorded one from a JSON file)
    open-loop against them and reports per-class percentile latency,
    goodput and drops.  ``server`` (the profiling server) becomes the
    interactive tenant.  ``--nodes N`` scales the same classes out over N
    arbiter-governed nodes of two modelled chips each behind a
    ``--router`` cluster front-end: every replica is a new server of the
    same weights on ``server``'s device, warmed before traffic (the nodes
    share the one device).  ``sink``, when given, receives
    ``(class, payload)`` for every answered request.
    """
    need_tracer = (args.trace_out or args.stream_trace or args.profile_out
                   or args.alerts_out)
    tracer = Tracer() if need_tracer else None
    metrics = (MetricsRegistry()
               if (args.metrics_out or args.alerts_out) else None)
    dur = args.trace_duration
    streamer = (TraceStreamer(args.stream_trace).attach(tracer)
                if args.stream_trace else None)
    watchtower = None
    if args.alerts_out:
        # burn windows scaled so the trace duration is one SLO day; the
        # live driver feeds/evaluates it as futures resolve
        watchtower = Watchtower(
            {"interactive": 0.99, "batch": 0.95},
            windows=default_windows(dur / 86400.0),
            tracer=tracer, registry=metrics, hist_name="engine_request_ms")
    rate = args.requests / dur
    a_batch = poisson(max(rate / 2, 0.5), dur, seed=1)
    if args.trace == "poisson":
        a_int = poisson(rate, dur, seed=0)
    elif args.trace == "bursty":
        a_int = onoff(2.0 * rate, dur, on_s=dur / 6, off_s=dur / 6, seed=0)
    elif args.trace == "diurnal":
        a_int = diurnal(2.0 * rate, dur, period_s=dur / 2, seed=0)
    else:
        loaded = load_schedule(args.trace)   # recorded schedule replay
        if isinstance(loaded, dict):
            # multi-stream recording (drive_live --record): replay every
            # class it holds, falling back to the defaults for the rest
            a_int = loaded.get("interactive", poisson(rate, dur, seed=0))
            a_batch = loaded.get("batch", a_batch)
        else:
            a_int = loaded

    classes = [
        SLOClass("interactive", deadline_ms=base_ms * 8, priority=2),
        SLOClass("batch", deadline_ms=base_ms * 30, priority=0,
                 drop_policy=DEGRADE),
    ]
    streams = {"interactive": a_int, "batch": a_batch}
    # warm each bucket ladder for every profiled subnet (the arbiter's
    # governors pick from the LUT): the live trace meets no cold pair
    warm = list(dict.fromkeys(p.subnet for p in lut.points))
    store = CalibrationStore() if args.calibrate else None

    if args.nodes > 1:
        return _run_cluster(args, arch, cfg, server, lut, x, classes,
                            streams, warm, store, tracer, metrics,
                            watchtower, streamer, sink)

    batch_server = build_server(arch, cfg, max_batch=server.max_batch,
                                batch_buckets=server.batch_buckets,
                                pipeline=server.pipeline,
                                device=server.device, seed=args.seed,
                                calibration=store, tenant="batch")
    # the profiling server becomes the interactive tenant: tag it so its
    # measured energy lands under the right calibration row
    server.calibration, server.tenant = store, "interactive"
    servers = {"interactive": server, "batch": batch_server}
    for s in servers.values():
        s.warm(warm, example_input=x[0])
    arbiter = ResourceArbiter(interval_s=0.05, calibration=store,
                              tracer=tracer, metrics=metrics)
    for c in classes:
        # two modelled 1-chip slices: the measured LUT profiles chips=1,
        # so a 2-chip pool lets both tenants hold a slice at once
        arbiter.register(c.name, lut, target_latency_ms=c.service_target_ms,
                         priority=c.priority, server=servers[c.name])
    report = drive_live(
        classes, servers, arbiter, streams, lambda name: x[0],
        g_fn=lambda: GlobalConstraints(total_chips=2),
        record_path=args.record, tracer=tracer, metrics=metrics,
        watchtower=watchtower, sink=sink)
    print(f"\ntrace mode [{args.trace}] {len(a_int)} interactive + "
          f"{len(a_batch)} batch arrivals over {dur:.1f}s")
    for name, cs in report.classes.items():
        print(f"  {name:12s} {cs.summary()}")
    print(f"  arbiter      {report.arbiter}")
    if args.record:
        print(f"  recorded actual arrivals -> {args.record}")
    _report_calibration(store, args)
    _emit_obs(args, tracer, arbiter.metrics, watchtower=watchtower,
              streamer=streamer)
    return TraceRun(report=report, classes=classes, streams=streams,
                    servers=servers, arbiter=arbiter, tracer=tracer,
                    metrics=metrics, store=store, watchtower=watchtower)


def _run_cluster(args, arch, cfg, server, lut, x, classes, streams, warm,
                 store, tracer, metrics, watchtower, streamer,
                 sink) -> TraceRun:
    """``--trace`` with ``--nodes`` > 1: the classes placed on every node
    that admits them, behind the cluster router."""
    nodes = [ClusterNode(name=f"node{i}",
                         g_fn=lambda t: GlobalConstraints(total_chips=2))
             for i in range(args.nodes)]
    cluster = Cluster(nodes, router=args.router,
                      health_interval_s=args.health_interval,
                      rebalance_interval_s=args.rebalance_interval,
                      tracer=tracer, metrics=metrics)
    if store is not None:
        for node in nodes:
            node.arbiter.calibration = store
    built: Dict[str, DynamicServer] = {}

    for c in classes:
        def mk_server(node, _name=c.name):
            s = build_server(arch, cfg, max_batch=server.max_batch,
                             batch_buckets=server.batch_buckets,
                             pipeline=server.pipeline, device=server.device,
                             seed=args.seed, calibration=store,
                             tenant=_name)
            s.warm(warm, example_input=x[0])
            built[f"{node.name}/{_name}"] = s
            return s

        placed = cluster.register(c.name, lut,
                                  target_latency_ms=c.service_target_ms,
                                  priority=c.priority,
                                  make_server=mk_server)
        print(f"  {c.name}: placed on {placed}")
    report = drive_live(
        classes, cluster.ports(), cluster, streams, lambda name: x[0],
        g_fn=lambda: GlobalConstraints(total_chips=2),
        record_path=args.record, watchtower=watchtower, sink=sink)
    a_int, a_batch = streams["interactive"], streams["batch"]
    print(f"\ncluster trace mode [{args.trace}] x{args.nodes} nodes, "
          f"router={args.router}: {len(a_int)} interactive + "
          f"{len(a_batch)} batch arrivals over {args.trace_duration:.1f}s")
    for name, cs in report.classes.items():
        print(f"  {name:12s} {cs.summary()}")
    print(f"  routed       {report.arbiter['routed']}")
    if args.health_interval is not None:
        print(f"  health-failed nodes: "
              f"{report.arbiter.get('health_failed', [])}")
    if args.rebalance_interval is not None:
        print(f"  migrations:   {report.arbiter.get('migrations', [])}")
        print(f"  preempted:    {report.arbiter.get('preempted', [])}")
    if args.record:
        print(f"  recorded actual arrivals -> {args.record}")
    _report_calibration(store, args)
    _emit_obs(args, tracer, cluster.metrics, watchtower=watchtower,
              streamer=streamer)
    return TraceRun(report=report, classes=classes, streams=streams,
                    servers=built, arbiter=cluster, tracer=tracer,
                    metrics=cluster.metrics, store=store,
                    watchtower=watchtower)


def _emit_obs(args, tracer, metrics, watchtower=None, streamer=None):
    """Write --trace-out / --metrics-out / --alerts-out / --profile-out
    artifacts, close the --stream-trace stream, and print the per-class
    latency decomposition for the retained traces."""
    if streamer is not None:
        n = streamer.close(tracer)
        print(f"  streamed {n} trace events -> {streamer.path}")
    if tracer is not None and args.trace_out:
        n = write_chrome_trace(tracer, args.trace_out)
        print(f"  trace: {len(tracer.requests())} request trees retained "
              f"({tracer.dropped} evicted), {n} events -> {args.trace_out}")
        decomp = decompose_latency(tracer)
        if decomp:
            print(format_decomposition(decomp))
    if watchtower is not None and args.alerts_out:
        with open(args.alerts_out, "w") as f:
            text = format_alerts(watchtower.alerts)
            f.write(text + ("\n" if text else ""))
        print(f"  {len(watchtower.alerts)} SLO alerts "
              f"(time-in-SLO {watchtower.summary()['time_in_slo']}) "
              f"-> {args.alerts_out}")
    if tracer is not None and args.profile_out:
        prof = profile_devices(tracer)
        with open(args.profile_out, "w") as f:
            f.write(format_profile(prof) + "\n")
        print(f"  device profile: {len(prof)} (subnet, bucket) rows "
              f"-> {args.profile_out}")
    if metrics is not None and args.metrics_out:
        text = (metrics.to_prometheus()
                if args.metrics_out.endswith(".prom")
                else metrics.to_json())
        with open(args.metrics_out, "w") as f:
            f.write(text)
        print(f"  metrics snapshot -> {args.metrics_out}")


def _report_calibration(store, args):
    if store is None:
        return
    s = store.summary()
    print(f"  calibration: {len(s['latency'])} (subnet, bucket) latency "
          f"columns, power rows: {s['power']}")
    if args.calibrate_out:
        store.save(args.calibrate_out)
        print(f"  calibration store saved -> {args.calibrate_out}")


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
    if args.trace:
        run_trace_mode(args, arch, cfg, server,
                       governors["joint (paper)"].lut, x, base_ms)
        return
    tracer = (Tracer() if (args.trace_out or args.stream_trace
                           or args.profile_out) else None)
    metrics = MetricsRegistry() if args.metrics_out else None
    streamer = (TraceStreamer(args.stream_trace).attach(tracer)
                if args.stream_trace else None)
    server.tracer, server.metrics = tracer, metrics
    # warm the bucket ladder for every profiled subnet (anything the
    # governor may pick) so serving starts with no cold (subnet, bucket)
    server.warm(specs, example_input=x[0])
    serve_requests(server, governors["joint (paper)"], base_ms, x[0],
                   args.requests)
    _emit_obs(args, tracer, metrics, streamer=streamer)


if __name__ == "__main__":
    main()
