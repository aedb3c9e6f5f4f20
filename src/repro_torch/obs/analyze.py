"""Latency decomposition: WHERE did the p95 go?

:func:`decompose_latency` takes a span source (a
:class:`~repro_torch.obs.trace.Tracer`, an iterable of
:class:`~repro_torch.obs.trace.RequestTrace`, or any report object carrying a
``.tracer``) and answers, per SLO class and per percentile, how the
measured latency splits into ``queue`` / ``collect`` (batching window)
/ ``stack`` / ``dispatch`` / ``device`` / ``warming`` (migration
warmup) components.

Two honesty rules, both enforced here rather than trusted:

* the percentile request is a *real* request — the nearest-rank rule
  (shared :func:`repro_torch.obs.metrics.quantile`) picks an actual trace, so
  the breakdown is one request's true story, not an average of
  incomparable requests;
* components must SUM to the measured latency within ``tol`` (default
  5%) — every trace is checked and violations raise, because a
  decomposition that doesn't add up is a lie about where the time went.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Sequence, Union

from repro_torch.obs.metrics import quantile
from repro_torch.obs.trace import COMPONENTS, RequestTrace, Tracer


class DecompositionError(AssertionError):
    """A trace's components do not sum to its measured latency."""


def _traces_of(source) -> List[RequestTrace]:
    if isinstance(source, Tracer):
        return source.requests()
    tracer = getattr(source, "tracer", None)
    if tracer is not None and not isinstance(source, Iterable):
        return _traces_of(tracer)
    return list(source)


def check_trace(tr: RequestTrace, tol: float = 0.05) -> Dict[str, float]:
    """One trace's component breakdown; raises
    :class:`DecompositionError` if it doesn't sum to ``total_ms``
    within ``tol`` (relative, with a 0.05 ms absolute floor so
    microsecond-scale requests don't trip on rounding)."""
    comp = tr.component_ms()
    got = sum(comp.values())
    want = tr.total_ms
    if abs(got - want) > max(tol * want, 0.05):
        raise DecompositionError(
            f"trace {tr.trace_id} [{tr.cls}]: components sum to "
            f"{got:.3f} ms but measured latency is {want:.3f} ms "
            f"(>{tol:.0%} apart): {comp}")
    return comp


def decompose_latency(source, qs: Sequence[float] = (50, 95),
                      tol: float = 0.05) -> Dict[str, dict]:
    """Per-class percentile decomposition.

    Returns ``{cls: {"n": int, "p50": {...}, "p95": {...}}}`` where each
    percentile entry holds ``total_ms``, ``trace_id``, ``node``, and one
    entry per component (ms, zero when the component didn't occur for
    that request).  Every retained trace is sum-checked against ``tol``
    first — the whole buffer must be honest, not just the percentile
    picks.
    """
    traces = _traces_of(source)
    by_cls: Dict[str, List[RequestTrace]] = {}
    for tr in traces:
        check_trace(tr, tol=tol)
        by_cls.setdefault(tr.cls, []).append(tr)

    out: Dict[str, dict] = {}
    for cls, trs in sorted(by_cls.items()):
        totals = [t.total_ms for t in trs]
        row: dict = {"n": len(trs)}
        for q in qs:
            target = quantile(totals, q)
            # nearest-rank guarantees the percentile IS an observed
            # request; find it and tell that request's story
            pick = min(trs, key=lambda t: (abs(t.total_ms - target),
                                           t.trace_id))
            comp = pick.component_ms()
            entry = {"total_ms": round(pick.total_ms, 3),
                     "trace_id": pick.trace_id, "node": pick.node}
            for name in COMPONENTS:
                entry[name + "_ms"] = round(comp.get(name, 0.0), 3)
            row[f"p{q:g}"] = entry
        out[cls] = row
    return out


def format_decomposition(dec: Dict[str, dict]) -> str:
    """Human-readable table of a :func:`decompose_latency` result —
    the example's act 6 and ``serve.py`` print this."""
    lines = []
    for cls, row in dec.items():
        lines.append(f"{cls} (n={row['n']}):")
        for key, entry in row.items():
            if key == "n":
                continue
            total = entry["total_ms"]
            parts = []
            for name in COMPONENTS:
                ms = entry[name + "_ms"]
                if ms <= 0 or not math.isfinite(total) or total <= 0:
                    continue
                parts.append(f"{name} {ms:.2f}ms ({ms / total:.0%})")
            where = f" @{entry['node']}" if entry.get("node") else ""
            lines.append(f"  {key}: {total:.2f} ms "
                         f"(req {entry['trace_id']}{where}) = "
                         + (" + ".join(parts) if parts else "(empty)"))
    return "\n".join(lines)


def mean_components(source, cls: Union[str, None] = None
                    ) -> Dict[str, float]:
    """Buffer-wide mean ms per component (optionally one class) — the
    benchmark's aggregate view next to the percentile stories."""
    traces = _traces_of(source)
    if cls is not None:
        traces = [t for t in traces if t.cls == cls]
    if not traces:
        return {}
    acc: Dict[str, float] = {name: 0.0 for name in COMPONENTS}
    for tr in traces:
        for name, ms in tr.component_ms().items():
            acc[name] += ms
    return {name: v / len(traces) for name, v in acc.items()}
