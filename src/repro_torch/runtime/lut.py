"""Profiled lookup table: (sub-network x hardware state) -> cost.

The paper's runtime manager works from profiled Pareto tables (its Fig. 1
"runtime resource management" layer consults algorithm and hardware knobs
jointly).  Two profile sources:

* ``measured_lut`` — wall-clock measurements of sliced-subnet forwards on
  the serving device (what the serve launcher profiles on the card);
* ``model_lut``    — roofline-modelled from per-subnet analytic FLOPs and
  bytes, anchored to the full network's roofline terms (the port's
  constants are the H100's, ``runtime/hwmodel.py``).

Accuracy per subnet is a surrogate fitted to the published OFA ImageNet
Pareto points (Cai et al. 2020, table 1: 230/389/482/595 MFLOPs at
76.0/79.1/79.6/80.0 % top-1); it is modelled, not measured.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.pareto import OpPoint
from repro_torch.core.types import SubnetSpec
from repro_torch.runtime import hwmodel as hm

# Published OFA ImageNet points (MFLOPs, top-1 %) — accuracy surrogate anchor.
_OFA_POINTS = ((230.0, 76.0), (389.0, 79.1), (482.0, 79.6), (595.0, 80.0))


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
    if spec.top_k is not None and spec.top_k > 0:
        r *= 1.0  # top_k handled by caller (needs full config context)
    if spec.resolution is not None:
        r *= 1.0  # resolution handled by caller
    return r


# --- batch buckets ----------------------------------------------------------
# The serving engine pads each request batch only up to the nearest
# power-of-two bucket (1, 2, 4, ..., max_batch) instead of always padding to
# max_batch; one executable is kept per (subnet, bucket).  The same
# ladder parameterises the traffic simulator's batching-aware service model:
# a bucket-sized forward costs a fixed dispatch/memory overhead plus a
# compute part linear in the bucket.

# Fraction of the full-batch latency that does NOT shrink with batch size
# (weight streaming, kernel launch, collectives on activations of the pad).
BUCKET_OVERHEAD_FRAC = 0.35


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


def bucket_for(n: int, max_batch: int) -> int:
    """Smallest bucket that fits ``n`` requests (clamped to max_batch)."""
    for b in bucket_ladder(max_batch):
        if b >= n:
            return b
    return max_batch


def _analytic_bucket_ms(full_batch_ms: float, bucket: int, max_batch: int,
                        overhead_frac: float) -> float:
    frac = overhead_frac + (1.0 - overhead_frac) * min(bucket, max_batch) \
        / max_batch
    return full_batch_ms * min(frac, 1.0)


def bucket_latency_ms(full_batch_ms: float, bucket: int, max_batch: int, *,
                      overhead_frac: float = BUCKET_OVERHEAD_FRAC,
                      calibration=None, spec: Optional[SubnetSpec] = None
                      ) -> float:
    """Latency of one bucket-sized forward, analytic or calibrated.

    ``full_batch_ms`` is the profiled pad-to-max latency (what the LUT
    stores); a smaller bucket pays the fixed overhead fraction plus the
    linearly-scaled compute part.  Monotone in ``bucket`` and equal to
    ``full_batch_ms`` at ``bucket == max_batch``.

    With a warmed :class:`repro_torch.runtime.telemetry.CalibrationStore` (and
    the ``spec`` to key it), each rung's analytic value is only the
    *prior*: the measured dispatch→ready EWMA is blended in with a
    confidence weight on its sample count, so the column converges to
    what the serving engine actually observed.  Columns are kept
    **isotonic** — a noisy measurement must never report a larger bucket
    as faster than a smaller one (that would break ``bucket_for``
    selection and the bucketed simulators' service model), so each rung
    is clamped to at least the rung below it.
    """
    if max_batch <= 0:
        return full_batch_ms
    if calibration is None or spec is None:
        # the analytic shape is monotone by construction (affine in the
        # bucket with a non-negative slope once frac is capped at 1)
        return _analytic_bucket_ms(full_batch_ms, bucket, max_batch,
                                   overhead_frac)
    # calibrated: walk the ladder up to the requested rung, carrying the
    # running max so the returned value respects the isotonic guarantee
    out = 0.0
    target = min(bucket, max_batch)
    for b in bucket_ladder(max_batch):
        prior = _analytic_bucket_ms(full_batch_ms, b, max_batch,
                                    overhead_frac)
        out = max(out, calibration.blended_latency_ms(spec, b, prior))
        if b >= target:
            break
    return out


# Chip-tier divisors of full_chips: a ~1.33x-spaced ladder down to 1/16.
# Water-filling packs concurrent tenants poorly with only {1, 1/2, 1/4}
# tiers — a tenant that needs "a bit more than 1/4" is forced to claim
# half the machine (ROADMAP: finer chip-granularity hw_states).
_CHIP_DIVISORS: Tuple[float, ...] = (1, 4 / 3, 2, 8 / 3, 4, 16 / 3, 8, 16)


def default_hw_states(full_chips: int, *,
                      freqs: Sequence[float] = hm.FREQ_LADDER
                      ) -> List[hm.HwState]:
    """Default (chips x freq) grid for LUT builders.

    Eight chip tiers from full_chips down to full_chips/16 (deduped,
    floored at 1 chip) crossed with the DVFS ladder — fine enough slice
    quanta that the arbiter can hand small shares to small tenants.
    """
    chips = sorted({max(1, int(full_chips / d)) for d in _CHIP_DIVISORS},
                   reverse=True)
    return [hm.HwState(chips=c, freq=f) for c in chips for f in freqs]


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

    def bucket_latencies(self, point: OpPoint, max_batch: int,
                         calibration=None) -> Dict[int, float]:
        """Per-bucket latency columns for one operating point (inspection
        helper).

        The stored ``latency_ms`` is the pad-to-max (full batch) cost; the
        columns expand it with :func:`bucket_latency_ms`, the same model
        the batching-aware service model in ``traffic.driver.simulate``
        applies point-wise.  With a ``calibration`` store the measured
        per-bucket EWMAs are blended over the analytic prior and the
        column is isotonic-guarded (see :func:`bucket_latency_ms`).  Use
        this to tabulate a point's whole ladder (reports); the hot paths call :func:`bucket_latency_ms`
        directly.
        """
        # single bottom-up walk: blend each rung, carry the running max
        # (bucket_latency_ms performs the same walk for one rung; calling
        # it per rung would redo the prefix each time)
        col: Dict[int, float] = {}
        run = 0.0
        for b in bucket_ladder(max_batch):
            v = _analytic_bucket_ms(point.latency_ms, b, max_batch,
                                    BUCKET_OVERHEAD_FRAC)
            if calibration is not None:
                v = calibration.blended_latency_ms(point.subnet, b, v)
            run = max(run, v)
            col[b] = run
        return col

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


def model_lut(specs: Sequence[SubnetSpec], *, full_terms: hm.RooflineTerms,
              full_chips: int,
              hw_states: Optional[Sequence[hm.HwState]] = None,
              top_accuracy: float = 80.0,
              flops_ratio_fn: Callable[[SubnetSpec], float]
              = subnet_flops_ratio) -> LUT:
    """Build a modelled LUT by scaling the full network's roofline terms.

    Compute/memory terms scale with the subnet compute ratio; the
    collective term scales with the width part only (collectives move
    activations).  Chip count scales all terms inversely (weak scaling),
    frequency scales compute only.
    """
    hw_states = list(hw_states) if hw_states is not None \
        else default_hw_states(full_chips)
    points = []
    for spec in specs:
        r = flops_ratio_fn(spec)
        r_coll = 0.5 * (spec.width_mult + spec.width_mult * spec.ffn_mult)
        for hw in hw_states:
            scale_chips = full_chips / hw.chips
            t_comp = full_terms.t_compute * r * scale_chips / hw.freq
            t_mem = full_terms.t_memory * r * scale_chips
            t_coll = full_terms.t_collective * r_coll * scale_chips
            terms = hm.RooflineTerms(t_comp, t_mem, t_coll)
            points.append(OpPoint(
                subnet=spec, hw_state=hw,
                latency_ms=terms.t_total * 1e3,
                energy_mj=hm.step_energy_mj(terms, hw),
                accuracy=accuracy_surrogate(r, top_accuracy),
            ))
    return LUT(points)


def measured_lut(specs: Sequence[SubnetSpec], measure_fn,
                 accuracy_fn=None, hw_states=None) -> LUT:
    """Build a LUT from real measurements.

    ``measure_fn(spec, hw) -> (latency_ms, energy_mj)`` — the serving engine
    provides this by timing the sliced executable;
    ``accuracy_fn(spec) -> float`` — measured (examples) or surrogate.
    """
    hw_states = list(hw_states or [hm.HwState(chips=1, freq=f)
                                   for f in hm.FREQ_LADDER])
    points = []
    for spec in specs:
        for hw in hw_states:
            lat, en = measure_fn(spec, hw)
            acc = (accuracy_fn(spec) if accuracy_fn
                   else accuracy_surrogate(subnet_flops_ratio(spec)))
            points.append(OpPoint(subnet=spec, hw_state=hw, latency_ms=lat,
                                  energy_mj=en, accuracy=acc))
    return LUT(points)
