"""The port's watchtower, trace streamer and device profile
(``repro_torch.obs.{health,stream,profile}``) against the JAX package's on
the CPU.

* the SLO ``Watchtower``: burn-window math, multi-window gating and
  hysteresis, attribution per chaos kind, exemplars — the same feeds
  through both packages give equal burns, alerts and attributions
  (``==`` on their plain data);
* the watchtower inside ``simulate_cluster`` (a throttled day, with
  ``actuate`` on and off) and the span links of a migration, equal to
  the reference's under the ``v5e`` fixture;
* the live driver firing the same alert as the simulator, the cluster
  front-end fanning alert pressure out, the ``TraceStreamer`` against
  the reference's on the same spans, and ``profile_devices`` rows.

Each test also holds the port to the reference test's own property
(``tests/test_watchtower.py``).
"""
import dataclasses
import json

import numpy as np
import pytest

from _torch_cluster import (JO, PO, PR, PT, P, X,  # noqa: F401
                            both, make_lut, pobs, tiny_server, two_nodes,
                            v5e)
from repro_torch.obs.health import EXPECTED_COMPONENT


def vt(k):
    return k.O.Tracer(clock=lambda: 0.0)


def plain(alerts):
    return [dataclasses.astuple(a) for a in alerts]


# --- burn window math --------------------------------------------------------

def test_burn_is_bad_fraction_over_budget():
    def run(k):
        wt = k.O.Watchtower({"api": 0.99}, min_total=1)
        for i in range(1, 11):
            wt.observe(float(i), "api", good=90, bad=10)
        out = [wt.burn("api", 10.0, 5.0), wt.burn("api", 10.0, 100.0)]
        for i in range(11, 21):
            wt.observe(float(i), "api", good=100, bad=0)
        return out + [wt.burn("api", 20.0, 5.0), wt.burn("api", 20.0, 20.0),
                      wt.budget_remaining("api", 20.0),
                      wt.burn("ghost", 20.0, 5.0)]
    ref, port = both(run)
    assert port == ref
    assert port[0] == pytest.approx(10.0) and port[1] == pytest.approx(10.0)
    assert port[2] == 0.0 and port[3] == pytest.approx(5.0)
    assert 0.0 <= port[4] <= 1.0 and port[5] == 0.0


def test_burn_window_slice_is_exact():
    def run(k):
        wt = k.O.Watchtower({"api": 0.9}, min_total=1)
        wt.observe(1.0, "api", good=10, bad=0)
        wt.observe(2.0, "api", good=0, bad=10)
        wt.observe(3.0, "api", good=10, bad=0)
        return (wt.burn("api", 3.0, 1.0), wt.burn("api", 3.0, 2.0),
                wt.burn("api", 2.0, 0.01))
    ref, port = both(run)
    assert port == ref
    assert port[0] == 0.0
    assert port[1] == pytest.approx(5.0) and port[2] == pytest.approx(10.0)


def test_min_total_guard_and_ordering():
    wt = PO.Watchtower({"api": 0.999})
    wt.observe(0.1, "api", good=0, bad=2)
    assert wt.burn("api", 0.1, 1.0) == 0.0 and wt.evaluate(0.1) == []
    wt.observe(0.2, "api", good=0, bad=6)
    assert wt.burn("api", 0.2, 1.0) > 100.0
    with pytest.raises(ValueError):
        wt.observe(0.1, "api", good=1)


# --- multi-window gating + hysteresis ----------------------------------------

def burny(k, **kw):
    return k.O.Watchtower({"api": 0.9}, min_total=1, windows=(
        k.O.BurnWindow(k.O.FAST, 2.0, 10.0, 5.0, k.O.PAGE),), **kw)


def test_alert_needs_both_windows_over_threshold():
    def run(k):
        wt = burny(k)
        for i in range(1, 10):
            wt.observe(float(i), "api", good=100, bad=0)
        wt.observe(10.0, "api", good=0, bad=100)
        first = (wt.burn("api", 10.0, 2.0), wt.burn("api", 10.0, 10.0),
                 wt.evaluate(10.0), wt.active("api"))
        fired = []
        for i in range(11, 20):
            wt.observe(float(i), "api", good=0, bad=100)
            fired += wt.evaluate(float(i))
        return first, fired, wt.pressure("api"), \
            k.O.format_alerts(fired), wt.summary()
    ref, port = both(run)
    assert port[0] == ref[0] and plain(port[1]) == plain(ref[1])
    assert port[2:] == ref[2:]
    (bs, bl, early, active), fired, pressure, text, _ = port
    assert bs >= 5.0 > bl and early == [] and not active
    assert len(fired) == 1
    a = fired[0]
    assert (a.cls, a.window, a.severity) == ("api", PO.FAST, PO.PAGE)
    assert a.burn_short >= 5.0 and a.burn_long >= 5.0
    assert pressure > 0.0 and "PAGE" in text


@pytest.mark.parametrize("hold_s", [None, 0.0])
def test_alert_hold_hysteresis(hold_s):
    def run(k):
        wt = burny(k, hold_s=hold_s)
        for i in range(1, 12):
            wt.observe(float(i), "api", good=0, bad=100)
            wt.evaluate(float(i))
        trail = [wt.active("api")]
        for i in range(12, 17):
            wt.observe(float(i), "api", good=1000 if hold_s is None
                       else 10000, bad=0)
            wt.evaluate(float(i))
            trail.append((wt.active("api"), wt.pressure("api")))
        return trail, wt.time_in_slo("api"), plain(wt.alerts)
    ref, port = both(run)
    assert port == ref
    trail, tis, _ = port
    assert trail[0]
    if hold_s is None:
        assert trail[1][0] and trail[1][1] < 1.0     # held, burn subsided
        assert not trail[-1][0]
    else:
        assert not trail[1][0]
        assert tis < 1.0


def test_default_windows_scale_to_virtual_day():
    ref, port = both(lambda k: k.O.default_windows(10.0 / 86400.0))
    assert [dataclasses.astuple(w) for w in port] == \
        [dataclasses.astuple(w) for w in ref]
    fast = next(w for w in port if w.name == PO.FAST)
    slow = next(w for w in port if w.name == PO.SLOW)
    assert fast.short_s == pytest.approx(300.0 * 10.0 / 86400.0)
    assert slow.long_s == pytest.approx(259200.0 * 10.0 / 86400.0)
    assert fast.burn == 14.4 and slow.burn == 1.0


# --- attribution -------------------------------------------------------------

def feed_component_regression(k, tr, cls, component, t_bad=10.0):
    obs = k.obs
    for i in range(20):
        t0 = 0.1 * i
        tr.request(cls, t0, t0 + 0.002, spans=[
            (obs.QUEUE, t0, t0 + 0.001, None),
            (obs.DEVICE, t0 + 0.001, t0 + 0.002,
             {"bucket": 1, "subnet": "s", "n": 1})])
    for i in range(10):
        t0 = t_bad + 0.1 * i
        q_ms, d_ms = ((0.050, 0.001) if component == "queue"
                      else (0.001, 0.050))
        tr.request(cls, t0, t0 + q_ms + d_ms, spans=[
            (obs.QUEUE, t0, t0 + q_ms, None),
            (obs.DEVICE, t0 + q_ms, t0 + q_ms + d_ms,
             {"bucket": 1, "subnet": "s", "n": 1})])


@pytest.mark.parametrize("kind", sorted(EXPECTED_COMPONENT))
def test_attribution_names_injected_cause_per_kind(kind):
    comp = EXPECTED_COMPONENT[kind]

    def run(k):
        tr = vt(k)
        feed_component_regression(k, tr, "api", comp)
        wt = k.O.Watchtower({"api": 0.999}, tracer=tr, min_total=1)
        wt.note_injection(10.0, kind, node="n0", duration_s=5.0)
        return wt.attribute(11.0, "api", window_s=2.0)
    ref, port = both(run)
    assert dataclasses.astuple(port) == dataclasses.astuple(ref)
    assert port.component == comp and port.cause == f"chaos:{kind}"
    assert port.delta_ms > 10.0 and port.baseline_ms < 5.0


def test_attribution_ranking_and_expiry():
    def run(k):
        tr = vt(k)
        feed_component_regression(k, tr, "api", "queue")
        tr.decision(k.obs.SCALE, 10.5, 10.5, direction="up")
        wt = k.O.Watchtower({"api": 0.999}, tracer=tr, min_total=1)
        wt.note_injection(10.0, "rack_fail", node="r0", duration_s=0.0)
        ranked = wt.attribute(11.0, "api", window_s=2.0)
        tr2 = vt(k)
        feed_component_regression(k, tr2, "api", "device")
        wt2 = k.O.Watchtower({"api": 0.999}, tracer=tr2, min_total=1)
        wt2.note_injection(0.5, "thermal", node="n0", duration_s=1.0)
        expired = wt2.attribute(11.0, "api", window_s=2.0)
        wt2.note_injection(0.5, "fail_stop", node="n0", duration_s=0.0)
        return ranked, expired, wt2.attribute(11.0, "api", window_s=2.0)
    ref, port = both(run)
    assert [dataclasses.astuple(a) for a in port] == \
        [dataclasses.astuple(a) for a in ref]
    ranked, expired, lasting = port
    labels = [c.label for c in ranked.causes]
    assert labels[0] == "chaos:rack_fail"
    assert labels.index("chaos:rack_fail") < labels.index("decision:scale")
    assert all(c.label != "chaos:thermal" for c in expired.causes)
    assert any(c.label == "chaos:fail_stop" for c in lasting.causes)


# --- exemplars ---------------------------------------------------------------

def test_exemplars_come_from_histogram_and_resolve_to_retained():
    def run(k):
        tr = vt(k)
        rids = [tr.request("api", 0.1 * i, 0.1 * i + 0.01, spans=[
            (k.obs.QUEUE, 0.1 * i, 0.1 * i, None),
            (k.obs.DEVICE, 0.1 * i, 0.1 * i + 0.01,
             {"bucket": 1, "subnet": "s", "n": 1})]) for i in range(10)]
        m = k.O.MetricsRegistry()
        h = m.histogram("cluster_request_ms", buckets=(1.0, 100.0),
                        cls="api")
        h.observe(0.5, exemplar=rids[0])
        h.observe(50.0, exemplar=rids[1])
        h.observe(500.0, exemplar=999999)
        wt = k.O.Watchtower({"api": 0.9}, min_total=1, tracer=tr, registry=m,
                            windows=(k.O.BurnWindow(k.O.FAST, 2.0, 10.0, 1.0,
                                                    k.O.PAGE),))
        for i in range(1, 12):
            wt.observe(float(i), "api", good=0, bad=10)
            fired = wt.evaluate(float(i))
            if fired:
                break
        return fired, rids, {t.trace_id for t in tr.requests()}
    ref, port = both(run)
    assert plain(port[0]) == plain(ref[0])
    fired, rids, retained = port
    ex = fired[0].exemplars
    assert ex and set(ex) <= retained and 999999 not in ex
    assert ex.index(rids[1]) < ex.index(rids[0])


# --- the watchtower inside the cluster simulator -----------------------------

def throttle_sim(k, actuate, horizon_s=7.0):
    nodes = [k.C.ClusterNode(name=f"n{i}",
                             g_fn=lambda t: k.R.GlobalConstraints(
                                 total_chips=16),
                             state=(k.C.STANDBY if i >= 2 else "up"))
             for i in range(4)]
    classes = [k.T.SLOClass("rt", deadline_ms=600.0, priority=3,
                            drop_policy=k.T.SHED, degrade_factor=1.5),
               k.T.SLOClass("batch", deadline_ms=2500.0, priority=1,
                            drop_policy=k.T.DEGRADE)]
    tracer = vt(k)
    wt = k.O.Watchtower({"rt": 0.999, "batch": 0.99},
                        time_scale=horizon_s / 86400.0, tracer=tracer,
                        actuate=actuate, rebalance_on_alert=actuate)
    chaos = k.X.Scenario(name="hot", seed=0, injections=tuple(
        k.X.Injection(t=2.0, kind=k.X.THERMAL, node=n,
                      duration_s=horizon_s - 3.0, ladder=(0.2, 0.12, 0.08))
        for n in ("n0", "n1")))
    lut = make_lut(k)
    rep = k.C.simulate_cluster(
        classes, {"rt": lut, "batch": lut},
        {"rt": k.T.poisson(200.0, horizon_s, seed=7),
         "batch": k.T.poisson(100.0, horizon_s, seed=8)},
        nodes, router=k.C.P2C, chaos=chaos, tracer=tracer, watchtower=wt,
        scale_at=(0.8 * horizon_s,), min_nodes=2)
    return rep, wt


@pytest.mark.parametrize("actuate", [True, False],
                         ids=["actuate", "observe_only"])
def test_sim_watchtower_equals_reference(actuate):
    (jr, jw), (pr, pw) = both(lambda k: throttle_sim(k, actuate))
    assert pr.summary() == jr.summary()
    assert plain(pr.alerts) == plain(jr.alerts)
    assert pw.summary() == jw.summary()
    assert pr.alerts, "throttle day fired no alerts"
    retained = {t.trace_id for t in pr.tracer.requests()}
    named = sum(1 for a in pr.alerts if a.attribution is not None
                and a.attribution.cause == "chaos:thermal")
    assert named / len(pr.alerts) >= 0.8
    for a in pr.alerts:
        assert set(a.exemplars) <= retained
    assert [row[1:] for row in pr.summary()["alerts"]] == [
        [a.cls, a.window, a.severity] for a in pr.alerts]
    if actuate:
        assert any(kd == "enter" for _, _, kd in pr.brownouts)
        t_up = min((t for t, d, _ in pr.scale_events if d == "up"),
                   default=float("inf"))
        assert t_up < 0.8 * 7.0
        assert pw.time_in_slo("rt") < 1.0


def test_sim_migration_links_back_to_truncated_first_attempt():
    def run(k):
        nodes = [k.C.ClusterNode(name="n0", g_fn=lambda t:
                                 k.R.GlobalConstraints(total_chips=8)),
                 k.C.ClusterNode(name="n1", g_fn=lambda t:
                                 k.R.GlobalConstraints(
                                     total_chips=256 if t >= 0.5 else 2))]
        cls = k.T.SLOClass("api", deadline_ms=2000.0, priority=2,
                           drop_policy=k.T.DEGRADE)
        tr = vt(k)
        k.C.simulate_cluster(
            [cls], {"api": make_lut(k)},
            {"api": k.T.poisson(800.0, 2.0, seed=5)}, nodes,
            router=k.C.LEAST_LOADED, placement_mode=k.C.FIRST_FIT,
            rebalance_at=[1.0], replicas=1, hysteresis=0.05, tracer=tr)
        return tr
    jt, pt = both(run)
    assert PO.to_chrome_trace(pt)["traceEvents"] == \
        JO.to_chrome_trace(jt)["traceEvents"]
    retained = {t.trace_id: t for t in pt.requests()}
    linked = [t for t in retained.values() if t.links]
    assert linked, "no migration re-homed queued work"
    for t2 in linked:
        for first in t2.links:
            assert [s.name for s in retained[first].spans] == \
                [pobs.ROUTE, pobs.QUEUE]


# --- live --------------------------------------------------------------------

def test_live_driver_fires_same_alert_as_sim():
    """A class whose every completion is late fires the same (class,
    window, severity) alert through the port's wall-clock driver as
    through either package's simulator."""
    streams = {"api": list(PT.poisson(150.0, 1.5, seed=3))}

    def windows(k):
        return (k.O.BurnWindow(k.O.FAST, 0.5, 1.0, 1.0, k.O.PAGE),)

    def cls(k):
        return k.T.SLOClass("api", deadline_ms=1e-3, priority=1,
                            drop_policy=k.T.DEGRADE)

    server = tiny_server(max_batch=8, timeout_ms=2.0)
    arb = PR.ResourceArbiter(interval_s=0.05)
    arb.register("api", make_lut(P, full_chips=2), cls(P).service_target_ms,
                 priority=1, server=server)
    wt_live = PO.Watchtower({"api": 0.99}, windows=windows(P))
    live = PT.drive_live([cls(P)], {"api": server}, arb, streams,
                         lambda n: X,
                         g_fn=lambda: PR.GlobalConstraints(total_chips=2),
                         watchtower=wt_live)
    assert live.classes["api"].completed > 0

    def sim(k):
        wt = k.O.Watchtower({"api": 0.99}, windows=windows(k))
        rep = k.T.simulate([cls(k)], {"api": make_lut(k)}, streams,
                           lambda t: k.R.GlobalConstraints(total_chips=256),
                           tracer=vt(k))
        wt.ingest(rep, t=1.5)
        return wt.alerts
    ref, port = both(sim)
    assert plain(port) == plain(ref)
    sig = lambda alerts: {(a.cls, a.window, a.severity) for a in alerts}
    assert sig(wt_live.alerts) == sig(port) == {("api", PO.FAST, PO.PAGE)}


def test_cluster_frontend_fans_out_alert_pressure():
    cluster = two_nodes()
    placed = cluster.register("api", make_lut(P, full_chips=2),
                              target_latency_ms=500.0,
                              priority=1)
    assert placed
    cluster.set_alert_pressure("api", 1.5)
    for nn in placed:
        assert cluster.nodes[nn].arbiter.metrics.value(
            "arbiter_alert_pressure", tenant="api") == 1.5
    cluster.set_alert_pressure("ghost", 1.0)


# --- streaming export --------------------------------------------------------

def test_streamer_equals_reference(tmp_path):
    def run(k):
        path = str(tmp_path / f"{k.O.__name__}.json")
        tr = vt(k)
        streamer = k.O.TraceStreamer(path).attach(tr)
        rid1 = tr.request("api", 0.0, 0.1, spans=[
            (k.obs.QUEUE, 0.0, 0.05, None),
            (k.obs.DEVICE, 0.05, 0.1, {"bucket": 1, "subnet": "s", "n": 1})])
        mid = list(k.O.iter_trace_events(path))
        tr.request("api", 0.1, 0.2, links=[rid1], spans=[
            (k.obs.DEVICE, 0.1, 0.2, {"bucket": 1, "subnet": "s", "n": 1})])
        tr.decision(k.obs.SCALE, 0.2, 0.2, direction="up")
        n = streamer.close(tr)
        return (mid, list(k.O.iter_trace_events(path)), n, rid1,
                tr.on_retire, k.O.to_chrome_trace(tr)["traceEvents"])
    ref, port = both(run)
    assert port[:4] == ref[:4]
    mid, evs, n, rid1, hook, one_shot = port
    assert mid and hook is None and len(evs) == n > len(mid)
    assert {"queue", "device", "scale"} <= {ev["name"] for ev in evs
                                            if ev["ph"] == "X"}
    assert any(ev.get("args", {}).get("links") == [rid1] for ev in evs)
    assert ({json.dumps(e, sort_keys=True) for e in evs if e["ph"] == "M"}
            == {json.dumps(e, sort_keys=True) for e in one_shot
                if e["ph"] == "M"})


# --- device profile ----------------------------------------------------------

def device_tracer(k):
    """Batches of one node's device dispatches; every request of a batch
    carries a copy of its DEVICE span (the profile counts it once)."""
    tr = vt(k)
    rng = np.random.default_rng(0)
    t = 0.0
    for b in range(12):
        subnet, bucket = ("full", 4) if b % 3 else ("w0.5", 2)
        n = int(rng.integers(1, bucket + 1))
        dev = float(rng.uniform(0.001, 0.004))
        for _ in range(n):
            tr.request("api", t, t + dev, node="n0", spans=[
                (k.obs.QUEUE, t, t, None),
                (k.obs.DEVICE, t, t + dev,
                 {"bucket": bucket, "subnet": subnet, "n": n})])
        t += dev + 0.001
    return tr


def test_profile_devices_equals_reference():
    flops = lambda s, b: 1e9 * b * (1.0 if s == "full" else 0.5)
    nbytes = lambda s, b: 4e6 * b

    def run(k):
        tr = device_tracer(k)
        prof = k.O.profile_devices(tr, flops_of=flops, bytes_of=nbytes)
        bare = k.O.profile_devices(tr)
        m = k.O.MetricsRegistry()
        k.O.export_profile(prof, m)
        return prof, bare, k.O.format_profile(prof), m.to_prometheus()
    ref, port = both(run)
    assert port == ref
    prof, bare, _, _ = port
    assert set(prof) == {("full", 4), ("w0.5", 2)}
    assert sum(r["batches"] for r in prof.values()) == 12
    for row in prof.values():
        assert 0.0 < row["mxu_util"] and row["bound"] in ("compute",
                                                          "memory")
    assert all("mxu_util" not in r for r in bare.values())


def test_profile_devices_defaults_to_the_h100_peak(monkeypatch):
    """Outside the fixture the utilisation column is the share of the
    card's bf16 tensor-core peak (989 TFLOP/s)."""
    monkeypatch.undo()
    tr = device_tracer(P)
    prof = PO.profile_devices(tr, flops_of=lambda s, b: 1e12)
    row = prof[("full", 4)]
    assert row["mxu_util"] == pytest.approx(
        1e12 * row["batches"] / (row["device_s"] * 989e12))
