"""Profiled lookup table: (sub-network x hardware state) -> cost.

The paper's runtime manager works from profiled Pareto tables (its Fig. 1
"runtime resource management" layer consults algorithm and hardware knobs
jointly).  ``measured_lut`` builds it from wall-clock measurements of
sliced-subnet forwards on the serving device (what the serve launcher
profiles).  The reference's roofline-modelled ``model_lut`` and the
per-bucket latency model of its traffic simulator come with the slices
that use them.

Accuracy per subnet is a surrogate fitted to the published OFA ImageNet
Pareto points (Cai et al. 2020, table 1: 230/389/482/595 MFLOPs at
76.0/79.1/79.6/80.0 % top-1); it is modelled, not measured.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.pareto import OpPoint
from repro_torch.core.types import SubnetSpec
from repro_torch.runtime import hwmodel as hm

def accuracy_surrogate(flops_ratio: float, top_acc: float = 80.0) -> float:
    """Monotone log-linear accuracy model through the OFA Pareto shape.

    ``flops_ratio`` is subnet_flops / full_flops in (0, 1].  Fitted to the
    spread of the published points: ~4 points of top-1 across a ~2.6x FLOPs
    range => slope ~9.6%/decade.
    """
    ratio = max(min(flops_ratio, 1.0), 1e-3)
    return top_acc + 9.6 * math.log10(ratio)


def subnet_flops_ratio(spec: SubnetSpec) -> float:
    """Analytic compute ratio of a subnet vs the full network.

    Width-like knobs scale matmul FLOPs linearly in each scaled dim;
    depth scales linearly.  Expert count does not change active compute
    (top_k does).  This is exact for sliced elastic transformers.
    """
    r = 1.0
    r *= spec.depth_mult
    # attention ~ heads x width; mlp ~ width x ffn.  Use an even blend.
    attn = spec.heads_mult * spec.width_mult
    mlp = spec.width_mult * spec.ffn_mult
    r *= 0.5 * attn + 0.5 * mlp
    return r


# The serving engine pads each request batch only up to the nearest
# power-of-two bucket (1, 2, 4, ..., max_batch) instead of always padding to
# max_batch; one executable is kept per (subnet, bucket).

def bucket_ladder(max_batch: int) -> Tuple[int, ...]:
    """Power-of-two batch buckets up to (and always including) max_batch."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    out: List[int] = []
    b = 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(dict.fromkeys(out))


@dataclasses.dataclass
class LUT:
    points: List[OpPoint]

    def feasible(self, *, max_latency_ms: float, chips_available: int,
                 power_budget_w: Optional[float] = None,
                 min_accuracy: Optional[float] = None,
                 max_freq: float = 1.0) -> List[OpPoint]:
        out = []
        for p in self.points:
            if p.latency_ms > max_latency_ms:
                continue
            if p.hw_state.chips > chips_available:
                continue
            if p.hw_state.freq > max_freq:
                continue
            if power_budget_w is not None:
                if hm.slice_power_w(p.hw_state) > power_budget_w:
                    continue
            if min_accuracy is not None and p.accuracy < min_accuracy:
                continue
            out.append(p)
        return out

    def fastest(self, chips_available: int, max_freq: float = 1.0,
                power_budget_w: Optional[float] = None) -> OpPoint:
        """Lowest-latency point within the chip/power budget and freq cap.

        ``max_freq`` < 1 is a thermal throttle and ``power_budget_w`` an
        arbiter grant: a degraded pick must still respect them, so each
        cap is only relaxed (power first, then freq, then chips) if NO
        point satisfies it.
        """
        cands = [p for p in self.points if p.hw_state.chips <= chips_available]
        capped = [p for p in cands if p.hw_state.freq <= max_freq]
        if power_budget_w is not None:
            powered = [p for p in capped or cands
                       if hm.slice_power_w(p.hw_state) <= power_budget_w]
            if powered:
                return min(powered, key=lambda p: p.latency_ms)
        return min(capped or cands or self.points, key=lambda p: p.latency_ms)


def measured_lut(specs: Sequence[SubnetSpec], measure_fn) -> LUT:
    """Build a LUT from real measurements over one card's DVFS ladder.

    ``measure_fn(spec, hw) -> (latency_ms, energy_mj)`` — the serving engine
    provides this by timing the sliced executable; accuracy is the
    surrogate.
    """
    points = []
    for spec in specs:
        acc = accuracy_surrogate(subnet_flops_ratio(spec))
        for f in hm.FREQ_LADDER:
            hw = hm.HwState(chips=1, freq=f)
            lat, en = measure_fn(spec, hw)
            points.append(OpPoint(subnet=spec, hw_state=hw, latency_ms=lat,
                                  energy_mj=en, accuracy=acc))
    return LUT(points)
