"""SLO watchtower: burn-rate alerts, regression attribution, exemplars.

The tracer records (spans/metrics) and the chaos layer reacts to hard failures
(retries/brownout on failure pressure); this module WATCHES: it holds
per-class error-budget accounting, fires multi-window burn-rate alerts
the way an SRE pager would, and — because the span pipeline proves
where each request's latency went — every alert is *attributed*: the
regressed pipeline component is named by diffing the firing window's
component decomposition against a rolling baseline, and probable causes
are ranked by correlating the window against active chaos injections
and retained decision spans.  The same :class:`Watchtower` instance is
fed by the virtual-time simulator and the wall-clock live driver, so an
alert means the same thing in both worlds.

Burn rate follows the multi-window multi-burn-rate recipe: with
objective ``o`` (fraction of requests that must be good), the budget is
``1 - o`` and the burn over a window is ``bad_fraction / (1 - o)``.  A
window alert fires only when BOTH its short and long windows exceed the
threshold — the short window makes it fast to clear, the long window
keeps a blip from paging.  ``time_scale`` maps the canonical real-time
windows (5m/1h fast, 6h/3d slow) onto a compressed virtual day.

Stdlib-only (like the rest of ``repro_torch.obs``): chaos kinds arrive as
plain strings via :meth:`Watchtower.note_injection`, so this module
never imports ``repro_torch.chaos``.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

from repro_torch.obs.trace import (COMPONENTS, HEALTH_FAIL, MIGRATE, PREEMPT,
                             REBALANCE, SCALE, Tracer)

FAST = "fast"
SLOW = "slow"
PAGE = "page"
TICKET = "ticket"

# Which pipeline component each chaos kind is expected to inflate:
# throttles/stragglers slow the device itself; everything that kills or
# hides capacity shows up as queueing on the survivors.
EXPECTED_COMPONENT: Dict[str, str] = {
    "thermal": "device",
    "straggler": "device",
    "fail_stop": "queue",
    "rack_fail": "queue",
    "spot_preempt": "queue",
    "wedge": "queue",
    "partition": "queue",
}
# Injections that end on their own vs. ones that leave the node dead
# until something (scale/readmit) intervenes.
_TRANSIENT_KINDS = ("thermal", "straggler", "partition")

# Decision spans worth naming as probable causes (ARBITRATE fires every
# epoch and BROWNOUT is the *response* — both would be noise).
_DECISION_COMPONENT: Dict[str, str] = {
    HEALTH_FAIL: "queue",
    PREEMPT: "queue",
    SCALE: "queue",
    REBALANCE: "queue",
    MIGRATE: "warming",
}


@dataclasses.dataclass(frozen=True)
class SLOTarget:
    """Per-class objective: fraction of requests that must be good."""
    cls: str
    objective: float = 0.999

    def __post_init__(self):
        if not 0.0 < self.objective < 1.0:
            raise ValueError(f"objective must be in (0,1): "
                             f"{self.objective}")


@dataclasses.dataclass(frozen=True)
class BurnWindow:
    """One multi-window burn-rate rule: fires when burn exceeds
    ``burn`` over BOTH ``short_s`` and ``long_s``."""
    name: str
    short_s: float
    long_s: float
    burn: float
    severity: str


def default_windows(time_scale: float = 1.0) -> Tuple[BurnWindow, ...]:
    """The canonical fast(5m/1h, 14.4x, page) + slow(6h/3d, 1x, ticket)
    pairs, scaled so a real SLO day maps onto a compressed virtual
    horizon (``time_scale = horizon_s / 86400`` makes the run one
    virtual day)."""
    ts = float(time_scale)
    return (BurnWindow(FAST, 300.0 * ts, 3600.0 * ts, 14.4, PAGE),
            BurnWindow(SLOW, 21600.0 * ts, 259200.0 * ts, 1.0, TICKET))


@dataclasses.dataclass(frozen=True)
class Cause:
    """One ranked probable cause of a regression."""
    label: str            # "chaos:thermal" / "decision:health_fail"
    score: float
    detail: str = ""


@dataclasses.dataclass(frozen=True)
class Attribution:
    """Which component regressed, by how much, and why (ranked)."""
    component: str
    delta_ms: float
    baseline_ms: float
    causes: Tuple[Cause, ...] = ()

    @property
    def cause(self) -> str:
        return self.causes[0].label if self.causes else "unknown"


@dataclasses.dataclass(frozen=True)
class Alert:
    """One fired burn-rate alert (rising edge only)."""
    t: float
    cls: str
    window: str           # FAST / SLOW
    severity: str         # PAGE / TICKET
    burn_short: float
    burn_long: float
    budget_remaining: float   # fraction of the slow-long error budget
    exemplars: Tuple[int, ...] = ()
    attribution: Optional[Attribution] = None


class Watchtower:
    """Per-class error-budget accounting + burn-rate alerting.

    Feed it outcome counts with :meth:`observe` (cumulative
    time-series, virtual or wall seconds), then call :meth:`evaluate`
    periodically; it returns newly-fired :class:`Alert`\\ s, keeps
    ``active`` state per (class, window), and exposes
    :meth:`pressure` — the actuation signal the arbiter/rebalancer
    consume.  With ``tracer``/``registry`` wired it also attributes
    each alert and attaches histogram-bucket exemplars.
    """

    def __init__(self, targets: Union[Dict[str, float],
                                      Iterable[SLOTarget]], *,
                 windows: Optional[Sequence[BurnWindow]] = None,
                 time_scale: float = 1.0,
                 tracer: Optional[Tracer] = None,
                 registry=None,
                 hist_name: str = "cluster_request_ms",
                 actuate: bool = True,
                 rebalance_on_alert: bool = False,
                 hold_s: Optional[float] = None,
                 min_total: int = 8,
                 max_alerts: int = 1024):
        if isinstance(targets, dict):
            self.targets = {c: SLOTarget(c, o) for c, o in targets.items()}
        else:
            self.targets = {t.cls: t for t in targets}
        self.windows = tuple(windows if windows is not None
                             else default_windows(time_scale))
        self.tracer = tracer
        self.registry = registry
        self.hist_name = hist_name
        self.actuate = actuate
        self.rebalance_on_alert = rebalance_on_alert
        # hold: once firing, an alert stays active until its condition
        # has been clear for the window's own short_s (or this
        # override) — without it, one good sampling interval clears the
        # alert, the actuation it triggered is withdrawn, the bad state
        # returns, and the loop flaps every epoch
        self.hold_s = hold_s
        # minimum traffic in a window before its burn is trusted — two
        # bad requests out of two at cold start is not an 800x burn
        self.min_total = min_total
        self.max_alerts = max_alerts
        self.alerts: List[Alert] = []
        self.alerts_dropped = 0
        # cumulative per-class series: sample times + running good/bad
        self._ts: Dict[str, List[float]] = {}
        self._good: Dict[str, List[int]] = {}
        self._bad: Dict[str, List[int]] = {}
        self._active: Dict[Tuple[str, str], bool] = {}
        self._last_true: Dict[Tuple[str, str], float] = {}
        self._burn: Dict[Tuple[str, str], Tuple[float, float]] = {}
        # chaos injections noted for cause correlation
        self._injections: List[Tuple[float, str, str, float]] = []
        # time-in-SLO bookkeeping: evaluate ticks without a fast alert
        self._ticks: Dict[str, int] = {}
        self._ok: Dict[str, int] = {}

    # --- feeding -----------------------------------------------------------

    def observe(self, t: float, cls: str, good: int = 0, bad: int = 0):
        """Append one outcome sample (counts since the previous
        sample).  ``bad`` counts SLO violations: late completions,
        drops, and failures alike."""
        ts = self._ts.setdefault(cls, [])
        g = self._good.setdefault(cls, [])
        b = self._bad.setdefault(cls, [])
        if ts and t < ts[-1]:
            raise ValueError(f"samples must be time-ordered: {t} < "
                             f"{ts[-1]}")
        ts.append(float(t))
        g.append((g[-1] if g else 0) + int(good))
        b.append((b[-1] if b else 0) + int(bad))

    def note_injection(self, t: float, kind: str, node: str = "",
                       duration_s: float = 0.0):
        """Record a chaos injection for cause correlation (plain
        strings — the sim's chaos schedule calls this as it fires)."""
        self._injections.append((float(t), str(kind), str(node or ""),
                                 float(duration_s)))

    # --- window math -------------------------------------------------------

    def _window_counts(self, cls: str, t: float,
                       window_s: float) -> Tuple[int, int]:
        """(bad, total) over ``(t - window_s, t]``; when the window is
        narrower than the sampling interval, fall back to the latest
        sample delta so a coarse feeder still gets a signal."""
        ts = self._ts.get(cls)
        if not ts:
            return 0, 0
        hi = bisect.bisect_right(ts, t) - 1
        if hi < 0:
            return 0, 0
        lo = bisect.bisect_right(ts, t - window_s, 0, hi + 1) - 1
        if lo == hi:
            lo = hi - 1   # sub-interval window: use the last delta
        g, b = self._good[cls], self._bad[cls]
        g0 = g[lo] if lo >= 0 else 0
        b0 = b[lo] if lo >= 0 else 0
        bad = b[hi] - b0
        total = (g[hi] - g0) + bad
        return bad, total

    def burn(self, cls: str, t: float, window_s: float) -> float:
        """Error-budget burn rate over one window: bad fraction divided
        by the budget (1 - objective).  0.0 when there was no traffic."""
        tgt = self.targets.get(cls)
        if tgt is None:
            return 0.0
        bad, total = self._window_counts(cls, t, window_s)
        if total <= 0 or total < self.min_total:
            return 0.0
        return (bad / total) / (1.0 - tgt.objective)

    def budget_remaining(self, cls: str, t: float) -> float:
        """Fraction of the error budget left over the slowest long
        window (1.0 = untouched, 0.0 = fully burned)."""
        w = max(self.windows, key=lambda w: w.long_s)
        return max(0.0, 1.0 - self.burn(cls, t, w.long_s))

    # --- evaluation --------------------------------------------------------

    def evaluate(self, t: float) -> List[Alert]:
        """Advance the monitors to time ``t``; returns newly-fired
        alerts (rising edges only — an alert that stays firing across
        evaluations is reported once)."""
        fired: List[Alert] = []
        for cls in self.targets:
            for w in self.windows:
                key = (cls, w.name)
                bs = self.burn(cls, t, w.short_s)
                bl = self.burn(cls, t, w.long_s)
                self._burn[key] = (bs, bl)
                over = bs >= w.burn and bl >= w.burn
                if over:
                    self._last_true[key] = t
                hold = self.hold_s if self.hold_s is not None else w.short_s
                was = self._active.get(key, False)
                firing = over or (was and t - self._last_true.get(
                    key, float("-inf")) <= hold)
                self._active[key] = firing
                if self.registry is not None:
                    self.registry.gauge("watchtower_burn", cls=cls,
                                        window=w.name).set(bs)
                if firing and not was:
                    alert = Alert(
                        t=t, cls=cls, window=w.name, severity=w.severity,
                        burn_short=bs, burn_long=bl,
                        budget_remaining=self.budget_remaining(cls, t),
                        exemplars=self._exemplars(cls),
                        attribution=self.attribute(t, cls, w.long_s))
                    if len(self.alerts) < self.max_alerts:
                        self.alerts.append(alert)
                    else:
                        self.alerts_dropped += 1
                    fired.append(alert)
                    if self.registry is not None:
                        self.registry.counter(
                            "watchtower_alerts_total", cls=cls,
                            window=w.name, severity=w.severity).inc()
            # time-in-SLO: a tick is in SLO iff no fast alert is active
            self._ticks[cls] = self._ticks.get(cls, 0) + 1
            if not self._active.get((cls, FAST), False):
                self._ok[cls] = self._ok.get(cls, 0) + 1
        return fired

    def active(self, cls: str, window: str = FAST) -> bool:
        return self._active.get((cls, window), False)

    def pressure(self, cls: str) -> float:
        """Actuation signal: 0.0 when healthy; while a fast alert is
        active, the short-window burn normalised by its threshold
        (clipped to 4.0) — the arbiter scales the class's backlog by
        ``1 + pressure``."""
        if not self.active(cls, FAST):
            return 0.0
        bs, _ = self._burn.get((cls, FAST), (0.0, 0.0))
        w = next(w for w in self.windows if w.name == FAST)
        return min(bs / w.burn, 4.0)

    def time_in_slo(self, cls: str) -> float:
        """Fraction of evaluate ticks with no active fast alert."""
        ticks = self._ticks.get(cls, 0)
        return self._ok.get(cls, 0) / ticks if ticks else 1.0

    # --- attribution -------------------------------------------------------

    def attribute(self, t: float, cls: str,
                  window_s: float) -> Attribution:
        """Name the regressed component and rank probable causes.

        Component: mean per-component ms of retained traces finishing
        inside ``(t - window_s, t]`` minus the mean over older retained
        traces (the rolling baseline).  Causes: active chaos injections
        (scored 2.0, +1.0 when the kind's expected component matches)
        then decision spans in the window (0.5, +0.5 on match) — an
        injected fault always outranks the control plane's reaction to
        it.
        """
        component, delta, baseline = "unknown", 0.0, 0.0
        if self.tracer is not None:
            win: Dict[str, float] = {c: 0.0 for c in COMPONENTS}
            base: Dict[str, float] = {c: 0.0 for c in COMPONENTS}
            n_win = n_base = 0
            for tr in self.tracer.requests():
                if tr.cls != cls:
                    continue
                comp = tr.component_ms()
                if t - window_s < tr.t1 <= t + 1e-9:
                    n_win += 1
                    for c, ms in comp.items():
                        win[c] += ms
                elif tr.t1 <= t - window_s:
                    n_base += 1
                    for c, ms in comp.items():
                        base[c] += ms
            if n_win:
                deltas = {}
                for c in COMPONENTS:
                    w_ms = win[c] / n_win
                    b_ms = base[c] / n_base if n_base else 0.0
                    deltas[c] = (w_ms - b_ms, b_ms)
                component = max(COMPONENTS,
                                key=lambda c: deltas[c][0])
                delta, baseline = deltas[component]

        causes: Dict[str, Cause] = {}

        def _add(label: str, score: float, detail: str):
            prev = causes.get(label)
            if prev is None or score > prev.score:
                causes[label] = Cause(label, score, detail)

        for ti, kind, node, dur in self._injections:
            if ti > t:
                continue
            if kind in _TRANSIENT_KINDS and t > ti + dur + window_s:
                continue   # transient fault long over: not a suspect
            score = 2.0
            if EXPECTED_COMPONENT.get(kind) == component:
                score += 1.0
            _add(f"chaos:{kind}", score,
                 f"node={node} t={ti:.3f} dur={dur:.3f}")
        if self.tracer is not None:
            for sp in self.tracer.spans():
                if sp.name not in _DECISION_COMPONENT:
                    continue
                if not (t - 2.0 * window_s < sp.t0 <= t):
                    continue
                score = 0.5
                if _DECISION_COMPONENT[sp.name] == component:
                    score += 0.5
                _add(f"decision:{sp.name}", score,
                     f"node={sp.node or ''} t={sp.t0:.3f}")
        ranked = tuple(sorted(causes.values(),
                              key=lambda c: (-c.score, c.label)))
        return Attribution(component=component, delta_ms=delta,
                           baseline_ms=baseline, causes=ranked)

    # --- exemplars ---------------------------------------------------------

    def _exemplars(self, cls: str, k: int = 4) -> Tuple[int, ...]:
        """Trace ids a fired alert links to: histogram-bucket exemplars
        (slowest buckets first) that are still retained in the tracer,
        topped up from the tracer's tail (slowest retained traces)."""
        retained = set()
        if self.tracer is not None:
            retained = {tr.trace_id for tr in self.tracer.requests()}
        out: List[int] = []
        if self.registry is not None:
            for row in self.registry.snapshot():
                if row["name"] != self.hist_name:
                    continue
                if cls not in row["labels"].values():
                    continue
                for _edge, x in reversed(row.get("exemplars", [])):
                    if x is None or x in out:
                        continue
                    if retained and x not in retained:
                        continue
                    out.append(x)
                    if len(out) >= k:
                        return tuple(out)
        if self.tracer is not None:
            for tr in self.tracer.tail_requests():
                if tr.cls == cls and tr.trace_id not in out:
                    out.append(tr.trace_id)
                    if len(out) >= k:
                        break
        return tuple(out)

    # --- convenience -------------------------------------------------------

    def ingest(self, report, t: float) -> List[Alert]:
        """One-shot feed from a finished ``TrafficReport`` /
        ``ClusterReport``: fold each class's terminal counts into one
        sample at ``t`` and evaluate."""
        for cn, st in report.classes.items():
            late = st.completed - st.good
            self.observe(t, cn, good=st.good,
                         bad=late + st.dropped + st.failed)
        return self.evaluate(t)

    def summary(self) -> dict:
        return {
            "alerts": len(self.alerts),
            "alerts_dropped": self.alerts_dropped,
            "active": sorted(f"{c}/{w}" for (c, w), on
                             in self._active.items() if on),
            "time_in_slo": {c: round(self.time_in_slo(c), 4)
                            for c in sorted(self.targets)},
            "budget_remaining": {
                c: round(self.budget_remaining(
                    c, self._ts[c][-1] if self._ts.get(c) else 0.0), 4)
                for c in sorted(self.targets)},
        }


def format_alerts(alerts: Sequence[Alert]) -> str:
    """Human-readable alert log — serve.py's ``--alerts-out`` sidecar
    and the example's act 8 print this."""
    lines = []
    for a in alerts:
        attr = a.attribution
        why = ""
        if attr is not None:
            why = (f" | {attr.component} +{attr.delta_ms:.2f}ms"
                   f" (base {attr.baseline_ms:.2f}ms) <- {attr.cause}")
        ex = (f" exemplars={list(a.exemplars)}" if a.exemplars else "")
        lines.append(f"[{a.t:8.3f}s] {a.severity.upper():6s} {a.cls} "
                     f"{a.window}-burn short={a.burn_short:.1f}x "
                     f"long={a.burn_long:.1f}x "
                     f"budget={a.budget_remaining:.0%}{why}{ex}")
    return "\n".join(lines)
