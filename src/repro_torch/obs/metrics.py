"""Metrics registry: counters / gauges / fixed-bucket histograms.

One :class:`MetricsRegistry` replaces the ad-hoc per-subsystem dict
plumbing (``ResourceArbiter._stats``, ``ClusterRouter.routed``, the
sim's ``energy``/``completions`` dicts): instrumented code increments
named, labelled series; the owners' ``summary()`` methods keep their
public shapes by *reading back* from the registry.  A point-in-time
:meth:`MetricsRegistry.snapshot` plus Prometheus-text and JSON exports
make the same numbers scrapeable from ``launch/serve.py
--metrics-out``.

This module is also the home of the ONE shared quantile implementation
(:func:`quantile`, nearest-rank, no interpolation) — the traffic
layer's ``TrafficReport`` percentiles and the histogram percentiles
here both route through it, so a latency percentile means the same
thing wherever it is printed.

Stdlib-only on purpose: every layer of the stack imports this, so it
must never create an import cycle or pull in torch.
"""
from __future__ import annotations

import json
import math
import re
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# --- the one quantile implementation ----------------------------------------


def quantile(values: Sequence[float], q: float) -> float:
    """Nearest-rank quantile (q in [0, 100]) on a finite sample.

    No interpolation: the answer is always an observed value, so
    hand-built traces in tests have exact expected percentiles.  The
    traffic layer's p50/p95/p99 reporting and the histogram percentiles
    below both go through here (q=0 -> min, q=100 -> max, empty -> nan).
    """
    if not values:
        return float("nan")
    xs = sorted(values)
    k = max(1, math.ceil(q / 100.0 * len(xs)))
    return float(xs[min(k, len(xs)) - 1])


def weighted_quantile(values: Sequence[float],
                      weights: Sequence[float], q: float) -> float:
    """Nearest-rank quantile over (value, weight) pairs — the same rank
    rule as :func:`quantile` with each value repeated ``weight`` times,
    without materialising the repeats.  Histogram percentiles use this
    with bucket upper edges as values and bucket counts as weights."""
    pairs = sorted((v, w) for v, w in zip(values, weights) if w > 0)
    total = sum(w for _, w in pairs)
    if not pairs or total <= 0:
        return float("nan")
    k = max(1.0, math.ceil(q / 100.0 * total))
    acc = 0.0
    for v, w in pairs:
        acc += w
        if acc >= k:
            return float(v)
    return float(pairs[-1][0])


# latency histogram edges (ms); +inf catches the pathological tail
DEFAULT_BUCKETS_MS: Tuple[float, ...] = (
    1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0, 500.0,
    1000.0, 2000.0, 5000.0, float("inf"))


class Counter:
    """Monotonic count.  ``inc`` only; resets only by removal."""
    kind = "counter"

    def __init__(self):
        self.value = 0.0

    def inc(self, v: float = 1.0):
        if v < 0:
            raise ValueError("counters only go up")
        self.value += v


class Gauge:
    """Point-in-time level (queue depth, granted chips, watts)."""
    kind = "gauge"

    def __init__(self):
        self.value = 0.0

    def set(self, v: float):
        self.value = float(v)

    def inc(self, v: float = 1.0):
        self.value += v

    def dec(self, v: float = 1.0):
        self.value -= v


class Histogram:
    """Fixed-bucket histogram (cumulative-style export, upper-edge
    percentiles).  Buckets are upper edges, last edge +inf; tracked
    min/max tighten the q=0/q=100 answers to observed values.

    Each bucket can carry one **exemplar** — an opaque id (a trace id)
    of the latest observation that landed in it — so a p99 bucket links
    to a concrete retained trace.  Keep-latest is deterministic under
    virtual time and costs one slot per bucket."""
    kind = "histogram"

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS_MS):
        edges = tuple(sorted(buckets))
        if not edges or edges[-1] != float("inf"):
            edges = edges + (float("inf"),)
        self.edges = edges
        self.counts = [0] * len(edges)
        self.exemplars: List[object] = [None] * len(edges)
        self.sum = 0.0
        self.count = 0
        self._min = float("inf")
        self._max = float("-inf")

    def observe(self, v: float, exemplar=None):
        for i, edge in enumerate(self.edges):
            if v <= edge:
                self.counts[i] += 1
                if exemplar is not None:
                    self.exemplars[i] = exemplar
                break
        self.sum += v
        self.count += 1
        self._min = min(self._min, v)
        self._max = max(self._max, v)

    def percentile(self, q: float) -> float:
        """Upper-edge nearest-rank percentile; the +inf bucket answers
        with the observed max (there is no finite edge to report)."""
        if self.count == 0:
            return float("nan")
        if q <= 0:
            return self._min
        values = [self._max if e == float("inf") else e
                  for e in self.edges]
        got = weighted_quantile(values, self.counts, q)
        return min(got, self._max)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else float("nan")


def _labels_key(labels: dict) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """Named, labelled series with get-or-create accessors.

    ``counter("requests_total", cls="interactive", node="n0")`` returns
    the same :class:`Counter` on every call with the same name+labels,
    so hot paths hold a reference and skip the dict lookup entirely.
    """

    def __init__(self):
        self._lock = threading.Lock()
        # name -> labels_key -> series object
        self._series: Dict[str, Dict[tuple, object]] = {}

    def _get(self, name: str, factory, labels: dict):
        key = _labels_key(labels)
        with self._lock:
            by_label = self._series.setdefault(name, {})
            s = by_label.get(key)
            if s is None:
                s = by_label[key] = factory()
            return s

    def counter(self, name: str, **labels) -> Counter:
        return self._get(name, Counter, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(name, Gauge, labels)

    def histogram(self, name: str,
                  buckets: Sequence[float] = DEFAULT_BUCKETS_MS,
                  **labels) -> Histogram:
        return self._get(name, lambda: Histogram(buckets), labels)

    # --- reads ---------------------------------------------------------------

    def value(self, name: str, default: float = 0.0, **labels) -> float:
        """Current value of one series, ``default`` if it was never
        created — summary() readers use this so absent == zero."""
        with self._lock:
            s = self._series.get(name, {}).get(_labels_key(labels))
        if s is None:
            return default
        return s.sum if isinstance(s, Histogram) else s.value

    def labels_of(self, name: str) -> List[dict]:
        """The label sets under one name (to reconstruct per-tenant /
        per-class dict shapes for legacy ``summary()`` consumers)."""
        with self._lock:
            return [dict(k) for k in self._series.get(name, {})]

    def remove(self, name: Optional[str] = None, **labels) -> int:
        """Drop series; with ``name=None`` drops every series carrying
        ALL the given labels (arbiter ``unregister(tenant)`` uses this).
        Returns the number of series removed."""
        match = _labels_key(labels)
        removed = 0
        with self._lock:
            names = [name] if name is not None else list(self._series)
            for n in names:
                by_label = self._series.get(n, {})
                for key in list(by_label):
                    if all(item in key for item in match):
                        del by_label[key]
                        removed += 1
                if not by_label:
                    self._series.pop(n, None)
        return removed

    def snapshot(self) -> List[dict]:
        """Point-in-time flat dump: one dict per series."""
        out = []
        with self._lock:
            items = [(n, dict(bl)) for n, bl in self._series.items()]
        for name, by_label in sorted(items):
            for key, s in sorted(by_label.items()):
                row = {"name": name, "labels": dict(key), "kind": s.kind}
                if isinstance(s, Histogram):
                    row.update(count=s.count, sum=s.sum,
                               buckets=[[e, c] for e, c in
                                        zip(s.edges, s.counts)],
                               exemplars=[[e, x] for e, x in
                                          zip(s.edges, s.exemplars)
                                          if x is not None],
                               p50=s.percentile(50), p95=s.percentile(95),
                               p99=s.percentile(99))
                else:
                    row["value"] = s.value
                out.append(row)
        return out

    def to_json(self, indent: Optional[int] = 1) -> str:
        def _enc(o):
            return "Infinity" if o == float("inf") else o
        rows = self.snapshot()
        for row in rows:
            if "buckets" in row:
                row["buckets"] = [[_enc(e), c] for e, c in row["buckets"]]
            if "exemplars" in row:
                row["exemplars"] = [[_enc(e), x]
                                    for e, x in row["exemplars"]]
            for k in ("p50", "p95", "p99"):
                if k in row and isinstance(row[k], float) \
                        and math.isnan(row[k]):
                    row[k] = None
        return json.dumps({"schema": 1, "series": rows}, indent=indent,
                          sort_keys=True)

    def to_prometheus(self) -> str:
        """Prometheus text exposition (counter/gauge/histogram with
        cumulative ``_bucket{le=...}`` rows).

        Names are sanitized to the exposition-format charset and label
        values are escaped (backslash, double-quote, newline) — a tenant
        named ``a"b\\nc`` must not corrupt the scrape."""
        lines: List[str] = []
        with self._lock:
            items = [(n, dict(bl)) for n, bl in self._series.items()]
        for name, by_label in sorted(items):
            pname = _prom_name(name)
            kind = next(iter(by_label.values())).kind
            lines.append(f"# TYPE {pname} {kind}")
            for key, s in sorted(by_label.items()):
                lbl = _prom_labels(key)
                if isinstance(s, Histogram):
                    cum = 0
                    for edge, c in zip(s.edges, s.counts):
                        cum += c
                        le = "+Inf" if edge == float("inf") else f"{edge:g}"
                        extra = (("le", le),) + key
                        lines.append(f"{pname}_bucket{_prom_labels(extra)}"
                                     f" {cum}")
                    lines.append(f"{pname}_sum{lbl} {s.sum:g}")
                    lines.append(f"{pname}_count{lbl} {s.count}")
                else:
                    lines.append(f"{pname}{lbl} {s.value:g}")
        return "\n".join(lines) + ("\n" if lines else "")


# Prometheus exposition charsets: metric names [a-zA-Z_:][a-zA-Z0-9_:]*,
# label names [a-zA-Z_][a-zA-Z0-9_]*; label VALUES are free text with
# backslash/quote/newline escaped.
_PROM_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")
_PROM_LABEL_BAD = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(name: str) -> str:
    name = _PROM_NAME_BAD.sub("_", name)
    if not name or name[0].isdigit():
        name = "_" + name
    return name


def _prom_label_name(name: str) -> str:
    name = _PROM_LABEL_BAD.sub("_", name)
    if not name or name[0].isdigit():
        name = "_" + name
    return name


def _prom_escape(value: str) -> str:
    return (value.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _prom_labels(key: Iterable[Tuple[str, str]]) -> str:
    key = tuple(key)
    if not key:
        return ""
    body = ",".join(f'{_prom_label_name(k)}="{_prom_escape(v)}"'
                    for k, v in sorted(key))
    return "{" + body + "}"
