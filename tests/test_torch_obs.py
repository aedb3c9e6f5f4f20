"""The port's observability package (``repro_torch.obs``) against the JAX
package's on the CPU, compared exactly: the span SCHEMA and kind strings,
the metrics registry's snapshot and both exports, the nearest-rank
quantiles, the tracer's tail-biased seeded retention, the latency
decomposition and the Chrome trace export of the same spans.
"""
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.obs as JO  # noqa: E402
import repro_torch.obs as PO  # noqa: E402
from repro.obs import analyze as j_analyze  # noqa: E402
from repro.obs import trace as j_trace  # noqa: E402
from repro_torch.obs import analyze as p_analyze  # noqa: E402
from repro_torch.obs import trace as p_trace  # noqa: E402

KINDS = ("ROUTE", "QUEUE", "COLLECT", "STACK", "DISPATCH", "DEVICE",
         "COMPLETE", "WARMING", "ARBITRATE", "REBALANCE", "MIGRATE",
         "PREEMPT", "SCALE", "HEALTH_FAIL", "CHAOS", "BROWNOUT")


def test_schema_and_kinds_identical_to_reference():
    assert p_trace.SCHEMA == j_trace.SCHEMA
    for k in KINDS:
        assert getattr(p_trace, k) == getattr(j_trace, k)
    assert p_trace.COMPONENTS == j_trace.COMPONENTS
    assert p_trace.REQUEST_SPANS == j_trace.REQUEST_SPANS
    assert p_trace.DECISION_SPANS == j_trace.DECISION_SPANS


def test_exports_cover_what_is_ported():
    missing = [n for n in PO.__all__ if not hasattr(PO, n)]
    assert not missing
    assert set(PO.__all__) <= set(JO.__all__)
    for ported in ("Watchtower", "TraceStreamer", "profile_devices"):
        assert ported in PO.__all__
    assert set(PO.__all__) == set(JO.__all__)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantiles_equal_reference(seed):
    rng = np.random.default_rng(seed)
    xs = list(rng.exponential(10.0, size=int(rng.integers(1, 200))))
    ws = list(rng.integers(0, 5, size=len(xs)).astype(float))
    for q in (0, 1, 50, 90, 95, 99, 99.9, 100):
        assert PO.quantile(xs, q) == JO.quantile(xs, q)
        a, b = PO.weighted_quantile(xs, ws, q), JO.weighted_quantile(xs, ws, q)
        assert a == b or (math.isnan(a) and math.isnan(b))


def fill_registry(M):
    m = M()
    rng = np.random.default_rng(4)
    for t in ("interactive", "batch", 'we"ird\nname'):
        c = m.counter("engine_served_total", tenant=t, node="")
        c.inc(int(rng.integers(1, 50)))
        g = m.gauge("arbiter_chips", tenant=t)
        g.set(float(rng.uniform(0, 4)))
        g.inc(0.5)
        h = m.histogram("engine_request_ms", tenant=t, node="")
        for i, v in enumerate(rng.exponential(20.0, size=40)):
            h.observe(float(v), exemplar=i if i % 3 else None)
    h2 = m.histogram("custom_ms", buckets=(1.0, 3.0, 9.0), tenant="x")
    for v in (0.5, 2.0, 2.5, 50.0):
        h2.observe(v)
    m.counter("to_remove", tenant="gone").inc()
    m.remove("to_remove", tenant="gone")
    return m


def test_registry_exports_equal_reference():
    j, p = fill_registry(JO.MetricsRegistry), fill_registry(PO.MetricsRegistry)
    assert p.to_json() == j.to_json()
    assert p.to_prometheus() == j.to_prometheus()
    assert p.snapshot() == j.snapshot()
    assert p.labels_of("engine_served_total") == \
        j.labels_of("engine_served_total")
    hj = j.histogram("engine_request_ms", tenant="batch", node="")
    hp = p.histogram("engine_request_ms", tenant="batch", node="")
    for q in (50, 95, 99):
        assert hp.percentile(q) == hj.percentile(q)
    assert json.loads(p.to_json())["series"]


def feed(Tracer, n=300, cap=40):
    """A seeded adversarial stream of finished requests plus decisions."""
    tr = Tracer(clock=lambda: 0.0, cap=cap, tail_frac=0.1, decision_cap=16,
                seed=11)
    rng = np.random.default_rng(9)
    t = 0.0
    T = p_trace if Tracer is PO.Tracer else j_trace
    for i in range(n):
        t += float(rng.exponential(0.01))
        lat = float(rng.lognormal(-4.0, 1.0))
        q = lat * float(rng.uniform(0.0, 0.5))
        tr.request("rt" if i % 3 else "batch", t, t + lat, node="n0", spans=[
            (T.QUEUE, t, t + q, None),
            (T.COLLECT, t + q, t + q, None),
            (T.STACK, t + q, t + q, None),
            (T.DISPATCH, t + q, t + q, None),
            (T.DEVICE, t + q, t + lat, {"bucket": 4, "subnet": "s", "n": 3}),
            (T.COMPLETE, t + lat, t + lat, None)])
        if i % 7 == 0:
            tr.decision(T.ARBITRATE, t, t, tenants=2, granted=2)
    tid = tr.begin_request("rt", t=t)
    tr.abort_request(tid, retain=True)
    return tr


def test_tracer_retention_equal_reference():
    j, p = feed(JO.Tracer), feed(PO.Tracer)
    key = lambda tr: sorted((r.trace_id, r.cls, r.t0, r.t1, r.node)
                            for r in tr.requests())
    assert key(p) == key(j)
    assert [r.trace_id for r in p.tail_requests()] == \
        [r.trace_id for r in j.tail_requests()]
    assert p.summary() == j.summary()
    assert p.dropped == j.dropped > 0
    assert p.decisions_dropped == j.decisions_dropped > 0
    assert [(s.name, s.t0, s.t1, s.trace_id, s.attrs) for s in p.spans()] \
        == [(s.name, s.t0, s.t1, s.trace_id, s.attrs) for s in j.spans()]
    assert PO.validate_schema(p.spans()) == []


def test_validate_schema_flags_like_reference():
    bad = [p_trace.Span(name="device", t0=0.0, t1=1.0, trace_id=1,
                        attrs={"bucket": 1}),
           p_trace.Span(name="nonsense", t0=0.0, t1=1.0)]
    jbad = [j_trace.Span(name=s.name, t0=s.t0, t1=s.t1,
                         trace_id=s.trace_id, attrs=s.attrs) for s in bad]
    got = PO.validate_schema(bad)
    assert got and got == JO.validate_schema(jbad)


def test_decomposition_equal_reference():
    j, p = feed(JO.Tracer), feed(PO.Tracer)
    dj, dp = JO.decompose_latency(j), PO.decompose_latency(p)
    assert dp == dj and set(dp) == {"rt", "batch"}
    assert PO.format_decomposition(dp) == JO.format_decomposition(dj)
    assert PO.mean_components(p, "rt") == JO.mean_components(j, "rt")
    for tp, tj in zip(sorted(p.requests(), key=lambda r: r.trace_id),
                      sorted(j.requests(), key=lambda r: r.trace_id)):
        assert p_analyze.check_trace(tp) == j_analyze.check_trace(tj)


def test_check_trace_rejects_gaps_like_reference():
    for T, A in ((p_trace, p_analyze), (j_trace, j_analyze)):
        tr = T.RequestTrace(trace_id=0, cls="rt", t0=0.0, t1=1.0, spans=[
            T.Span(name=T.QUEUE, t0=0.0, t1=0.5, trace_id=0)])
        with pytest.raises(A.DecompositionError):
            A.check_trace(tr)


def test_chrome_trace_equal_reference(tmp_path):
    j, p = feed(JO.Tracer), feed(PO.Tracer)
    cj, cp = JO.to_chrome_trace(j), PO.to_chrome_trace(p)
    # the only difference is the exporter's name in otherData
    assert cj["otherData"].pop("source") == "repro.obs"
    assert cp["otherData"].pop("source") == "repro_torch.obs"
    assert cp == cj
    path = str(tmp_path / "t.json")
    n = PO.write_chrome_trace(p, path)
    assert list(PO.iter_trace_events(path)) == cp["traceEvents"]
    assert n == len(cp["traceEvents"])
    nd = str(tmp_path / "t.ndjson")
    PO.write_chrome_trace(p, nd, ndjson=True)
    assert list(PO.iter_trace_events(nd)) == cp["traceEvents"]
