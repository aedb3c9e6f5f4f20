"""Continuous device profiling from retained DEVICE spans.

The span pipeline records every device dispatch with its ``(subnet,
bucket)`` executable key (on the card a CUDA graph of the sub-network's
forward) and its measured device time, and the analytic model
(``launch/flops.py`` / ``runtime/hwmodel.py``) knows how many FLOPs and
HBM bytes that executable moves.  Joining the two gives a
per-executable **analytic profile**: achieved fraction of the peak
FLOP/s and roofline position (arithmetic intensity vs. the ridge point)
— where each executable sits on the roofline, continuously, from
production traces instead of a one-off timing.

The utilisation column keeps the reference's key, ``mxu_util``: on the
card it is the share of the tensor-core peak (the H100's 989 TFLOP/s
bf16 dense, ``runtime/hwmodel.PEAK_FLOPS``) that the batch's device span
achieved.  The DEVICE span runs from the dispatch call's return to the
batch's ready event, so it is the device time left after the host
enqueued the graph, not a hardware counter.

A batch of ``n`` requests shares ONE device dispatch, and every request
trace in that batch carries a copy of the same DEVICE span — the
aggregation dedupes on ``(node, t0, t1, subnet, bucket)`` so a batch is
counted once, with ``items`` credited from the span's ``n``.

``flops_of(subnet, bucket)`` / ``bytes_of(subnet, bucket)`` are caller
callables returning per-batch totals (the serving layer knows its
model; this module stays model-agnostic).  Peak FLOP/s and HBM
bandwidth default to the hardware model's constants (lazy-imported —
``repro_torch.obs`` must not depend on ``repro_torch.runtime`` at import
time).
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple

from repro_torch.obs.trace import DEVICE, RequestTrace, Tracer


def _traces_of(source) -> List[RequestTrace]:
    if isinstance(source, Tracer):
        return source.requests()
    tracer = getattr(source, "tracer", None)
    if tracer is not None and not isinstance(source, Iterable):
        return tracer.requests()
    return list(source)


def _hw_defaults() -> Tuple[float, float]:
    from repro_torch.runtime import hwmodel as hm   # lazy: no import cycle
    return float(hm.PEAK_FLOPS), float(hm.HBM_BW)


def profile_devices(source, *,
                    flops_of: Optional[Callable[[str, int], float]] = None,
                    bytes_of: Optional[Callable[[str, int], float]] = None,
                    chips: int = 1, freq: float = 1.0,
                    peak_flops: Optional[float] = None,
                    hbm_bw: Optional[float] = None
                    ) -> Dict[Tuple[str, int], dict]:
    """Aggregate retained DEVICE spans into per-(subnet, bucket) rows.

    Each row carries measured aggregates (``batches``, ``items``,
    ``device_s``, ``ms_per_batch``, ``items_per_s``) and — when
    ``flops_of`` is given — the analytic join: ``flops`` per batch,
    ``mxu_util`` (achieved / peak FLOP/s across ``chips`` at ``freq``),
    and with ``bytes_of`` also ``ai`` (FLOPs/byte), ``ridge`` and
    ``bound`` ("compute" / "memory") — the roofline position.
    """
    if peak_flops is None or hbm_bw is None:
        d_peak, d_bw = _hw_defaults()
        peak_flops = d_peak if peak_flops is None else peak_flops
        hbm_bw = d_bw if hbm_bw is None else hbm_bw
    seen = set()
    agg: Dict[Tuple[str, int], dict] = {}
    for tr in _traces_of(source):
        for sp in tr.spans:
            if sp.name != DEVICE:
                continue
            attrs = sp.attrs or {}
            subnet = str(attrs.get("subnet"))
            bucket = int(attrs.get("bucket", 0) or 0)
            dedupe = (sp.node, round(sp.t0, 9), round(sp.t1, 9),
                      subnet, bucket)
            if dedupe in seen:
                continue
            seen.add(dedupe)
            row = agg.setdefault((subnet, bucket), {
                "subnet": subnet, "bucket": bucket,
                "batches": 0, "items": 0, "device_s": 0.0})
            row["batches"] += 1
            row["items"] += int(attrs.get("n", 1) or 1)
            row["device_s"] += max(sp.t1 - sp.t0, 0.0)

    for (subnet, bucket), row in agg.items():
        dev_s = row["device_s"]
        row["ms_per_batch"] = (dev_s / row["batches"] * 1e3
                               if row["batches"] else 0.0)
        row["items_per_s"] = row["items"] / dev_s if dev_s > 0 else 0.0
        if flops_of is None:
            continue
        fl = float(flops_of(subnet, bucket))
        row["flops"] = fl
        achievable = peak_flops * float(freq) * max(int(chips), 1)
        row["mxu_util"] = (fl * row["batches"] / (dev_s * achievable)
                           if dev_s > 0 and achievable > 0 else 0.0)
        if bytes_of is None:
            continue
        by = float(bytes_of(subnet, bucket))
        row["bytes"] = by
        row["ai"] = fl / by if by > 0 else float("inf")
        ridge = (peak_flops * float(freq)) / hbm_bw if hbm_bw > 0 \
            else float("inf")
        row["ridge"] = ridge
        row["bound"] = "compute" if row["ai"] >= ridge else "memory"
    return dict(sorted(agg.items()))


def export_profile(profile: Dict[Tuple[str, int], dict],
                   registry) -> None:
    """Mirror a profile into a :class:`MetricsRegistry` so it rides the
    existing ``--metrics-out`` export path."""
    for (subnet, bucket), row in profile.items():
        lbl = dict(subnet=subnet, bucket=str(bucket))
        registry.gauge("profile_device_batches", **lbl).set(row["batches"])
        registry.gauge("profile_device_items", **lbl).set(row["items"])
        registry.gauge("profile_device_ms_per_batch",
                       **lbl).set(row["ms_per_batch"])
        if "mxu_util" in row:
            registry.gauge("profile_mxu_util", **lbl).set(row["mxu_util"])
        if "ai" in row:
            registry.gauge("profile_arith_intensity",
                           **lbl).set(row["ai"])


def format_profile(profile: Dict[Tuple[str, int], dict]) -> str:
    """Human-readable profile table (example act 8 / serve.py print)."""
    lines = ["subnet               bkt batches  items  ms/batch  "
             "items/s   mxu%   bound"]
    for (subnet, bucket), row in profile.items():
        mxu = (f"{row['mxu_util'] * 100:5.1f}%"
               if "mxu_util" in row else "    --")
        bound = row.get("bound", "--")
        lines.append(f"{subnet:<20s} {bucket:>3d} {row['batches']:>7d} "
                     f"{row['items']:>6d} {row['ms_per_batch']:>9.3f} "
                     f"{row['items_per_s']:>8.1f} {mxu:>7s}  {bound}")
    return "\n".join(lines)
