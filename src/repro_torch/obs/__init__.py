"""repro_torch.obs — request tracing + metrics for the port's serving stack.

The port's copy of the reference ``obs`` package: one span schema from
the cluster router down to the card's dispatch, in both time domains (the
live engine on the wall clock, the traffic and cluster simulators on
virtual time).

* ``trace``    — :class:`Tracer`: bounded, thread-safe, tail-biased span
  buffer (always keeps the slowest share of requests plus a seeded
  uniform sample); the fixed span vocabulary and its :data:`SCHEMA`,
  identical to the reference's.
* ``metrics``  — :class:`MetricsRegistry`: counters / gauges /
  fixed-bucket histograms with labels, Prometheus-text + JSON export,
  and the one shared nearest-rank :func:`quantile` every percentile of
  the port routes through.
* ``analyze``  — :func:`decompose_latency`: per-class p50/p95 split into
  queue / collect / stack / dispatch / device / warming, with the
  sum-to-measured-latency invariant asserted.
* ``export``   — Chrome trace-event / Perfetto JSON
  (:func:`to_chrome_trace`, :func:`write_chrome_trace`), incremental
  via the shared :class:`EventBuilder`.
* ``stream``   — :class:`TraceStreamer`: live Perfetto streaming; spans
  append to disk as requests retire (``serve --stream-trace``).
* ``health``   — the SLO watchtower: per-class multi-window burn-rate
  :class:`Alert`\\ s with regression :class:`Attribution` (which
  component regressed, ranked probable causes from chaos injections and
  decision spans) and histogram-bucket exemplars; its
  :meth:`Watchtower.pressure` signal closes the monitor→diagnose→actuate
  loop through the arbiter and rebalancer.
* ``profile``  — device profiling: retained DEVICE spans joined with the
  analytic FLOPs/bytes model into per-(subnet, bucket) utilisation of
  the card's peak and roofline position.

Stdlib-only: imported by every layer, it must never cycle or pull in
torch; ``tracer=None`` everywhere means zero work on the hot path.
"""
from repro_torch.obs.analyze import (DecompositionError, decompose_latency,
                                     format_decomposition, mean_components)
from repro_torch.obs.export import (EventBuilder, iter_trace_events,
                                    to_chrome_trace, write_chrome_trace)
from repro_torch.obs.health import (FAST, PAGE, SLOW, TICKET, Alert,
                                    Attribution, BurnWindow, Cause,
                                    SLOTarget, Watchtower, default_windows,
                                    format_alerts)
from repro_torch.obs.metrics import (DEFAULT_BUCKETS_MS, Counter, Gauge,
                                     Histogram, MetricsRegistry, quantile,
                                     weighted_quantile)
from repro_torch.obs.profile import (export_profile, format_profile,
                                     profile_devices)
from repro_torch.obs.stream import TraceStreamer
from repro_torch.obs.trace import (ARBITRATE, BROWNOUT, CHAOS, COLLECT,
                                   COMPLETE, COMPONENTS, DECISION_SPANS,
                                   DEVICE, DISPATCH, HEALTH_FAIL, MIGRATE,
                                   PREEMPT, QUEUE, REBALANCE, REQUEST_SPANS,
                                   ROUTE, SCALE, SCHEMA, STACK, WARMING,
                                   RequestTrace, Span, Tracer,
                                   validate_schema)

__all__ = [
    "Tracer", "Span", "RequestTrace", "SCHEMA", "COMPONENTS",
    "REQUEST_SPANS", "DECISION_SPANS", "validate_schema",
    "ROUTE", "QUEUE", "COLLECT", "STACK", "DISPATCH", "DEVICE",
    "COMPLETE", "WARMING", "ARBITRATE", "REBALANCE", "MIGRATE",
    "PREEMPT", "SCALE", "HEALTH_FAIL", "CHAOS", "BROWNOUT",
    "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "DEFAULT_BUCKETS_MS", "quantile", "weighted_quantile",
    "decompose_latency", "format_decomposition", "mean_components",
    "DecompositionError",
    "to_chrome_trace", "write_chrome_trace", "EventBuilder",
    "iter_trace_events", "TraceStreamer",
    "Watchtower", "Alert", "Attribution", "Cause", "SLOTarget",
    "BurnWindow", "default_windows", "format_alerts",
    "FAST", "SLOW", "PAGE", "TICKET",
    "profile_devices", "format_profile", "export_profile",
]
