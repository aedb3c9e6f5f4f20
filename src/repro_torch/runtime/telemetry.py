"""Telemetry store closing the measurement loop (ROADMAP "feed
measurement back" items).

The paper's runtime layer "monitors the dynamically changing algorithms'
performance targets as well as hardware resources" — but a planner that
only ever consults its *offline* profile drifts from the machine it
actually runs on.  Dynamic-OFA (Lou & Xun et al., 2021) re-profiles
per-architecture latency at runtime; this module is that feedback path
for the whole stack:

* the serving engine (:class:`repro_torch.runtime.engine.DynamicServer`)
  records per-``(SubnetSpec, bucket)`` dispatch→ready latency EWMAs and
  per-tenant measured energy/busy integrals into a
  :class:`CalibrationStore`;
* the LUT layer (:func:`repro_torch.runtime.lut.bucket_latency_ms`,
  :meth:`repro_torch.runtime.lut.LUT.bucket_latencies`) blends those measured
  EWMAs into its analytic bucket columns — the analytic model is the
  *prior*, the measurement takes over as samples accumulate;
* the arbiter (:class:`repro_torch.runtime.arbiter.ResourceArbiter`) plans its
  water-filling off the calibrated point latencies and prices each
  candidate slice with the tenant's *measured* watts
  (:meth:`CalibrationStore.power_scale`) instead of the raw modelled
  ``slice_power_w``;
* the replay simulator (``traffic.driver.simulate``) accepts a warmed store so a recorded
  trace predicts with measured numbers.

Blending uses a confidence weight on sample count:

    blended = w * measured_ewma + (1 - w) * prior,   w = n / (n + K)

so one noisy batch cannot yank a column, and a well-sampled bucket
converges to its measured value.  All methods are thread-safe (the
engine's completer, the arbiter clock and report readers all touch the
store concurrently).
"""
from __future__ import annotations

import dataclasses
import json
import threading
from typing import Dict, Optional, Tuple

from repro_torch.core.types import SubnetSpec

# EWMA smoothing for measured samples (matches the arbiter's arrival-rate
# beta: new = beta * old + (1 - beta) * sample)
EWMA_BETA = 0.6
# K in the confidence weight n / (n + K): how many measured samples it
# takes before measurement and prior carry equal weight
PRIOR_WEIGHT = 8.0


@dataclasses.dataclass
class _Ewma:
    """One smoothed scalar with its sample count."""
    value: float = 0.0
    count: int = 0

    def observe(self, sample: float, beta: float) -> None:
        if self.count == 0:
            self.value = sample
        else:
            self.value = beta * self.value + (1.0 - beta) * sample
        self.count += 1


class CalibrationStore:
    """Measured-performance store shared by engine, arbiter and simulators.

    Latency is keyed by ``(SubnetSpec, bucket)`` — exactly the engine's
    executable-cache key, so every dispatched batch calibrates the column
    the planner will consult for that architecture at that batch size.
    ``max_batch`` is remembered per key so a bucket observation can be
    projected to a full-batch estimate through the analytic bucket shape
    (:meth:`point_latency_ms`).

    Power is per tenant, two views:

    * :meth:`busy_power_w` — energy/busy: the board power of the slices
      the tenant actually ran on, averaged over its busy time;
    * :meth:`power_scale` — measured watts / modelled watts of the
      granted slice, EWMA-smoothed.  This is the tenant's *duty cycle*:
      a tenant granted a 200 W slice but busy 30 % of the wall clock
      draws 60 W.  The arbiter multiplies ``slice_power_w`` by it, so
      the energy objective the paper optimises is driven by observed
      energy (ROADMAP: feed measured energy back into the water-filling
      objective).
    """

    def __init__(self, *, beta: float = EWMA_BETA,
                 prior_weight: float = PRIOR_WEIGHT):
        self.beta = beta
        self.prior_weight = prior_weight
        self._lock = threading.Lock()
        # (spec, bucket) -> (_Ewma latency_ms, max_batch seen at record)
        self._latency: Dict[Tuple[SubnetSpec, int], Tuple[_Ewma, int]] = {}
        # tenant -> duty-cycle ratio EWMA (measured_w / modelled_w)
        self._power_ratio: Dict[str, _Ewma] = {}
        # tenant -> cumulative (energy_mj, busy_s)
        self._energy: Dict[str, Tuple[float, float]] = {}
        self._version = 0

    # --- latency ------------------------------------------------------------

    def note_latency(self, spec: SubnetSpec, bucket: int, latency_ms: float,
                     *, max_batch: Optional[int] = None) -> None:
        """One measured dispatch→ready batch latency (the engine's hook)."""
        if latency_ms < 0:
            return
        with self._lock:
            ewma, mb = self._latency.get((spec, bucket), (None, bucket))
            if ewma is None:
                ewma = _Ewma()
            ewma.observe(float(latency_ms), self.beta)
            self._latency[(spec, bucket)] = (
                ewma, int(max_batch) if max_batch else max(mb, bucket))
            self._version += 1

    def latency_ms(self, spec: SubnetSpec, bucket: int) -> Optional[float]:
        """Raw measured EWMA for one (spec, bucket), or None."""
        with self._lock:
            entry = self._latency.get((spec, bucket))
            return entry[0].value if entry else None

    def latency_samples(self, spec: SubnetSpec, bucket: int) -> int:
        with self._lock:
            entry = self._latency.get((spec, bucket))
            return entry[0].count if entry else 0

    def _weight(self, n: int) -> float:
        return n / (n + self.prior_weight)

    def blended_latency_ms(self, spec: SubnetSpec, bucket: int,
                           prior_ms: float) -> float:
        """Measured EWMA blended into the analytic prior by confidence."""
        with self._lock:
            entry = self._latency.get((spec, bucket))
            if entry is None:
                return prior_ms
            ewma, _ = entry
            w = self._weight(ewma.count)
            return w * ewma.value + (1.0 - w) * prior_ms

    def point_latency_ms(self, spec: SubnetSpec, prior_ms: float,
                         *, overhead_frac: Optional[float] = None) -> float:
        """Full-batch (pad-to-max) latency estimate for one subnet.

        Every measured bucket contributes: an observation at bucket ``b``
        of a ``max_batch`` ladder is projected to a full-batch estimate
        through the analytic bucket shape (divide by the bucket's cost
        fraction), then the projections are count-weighted and blended
        with the analytic ``prior_ms``.  The arbiter plans feasibility
        off this number, so its water-filling runs on measured latency
        once the serving engine has seen the subnet.
        """
        # local import: lut imports this module for the column blend
        from repro_torch.runtime.lut import BUCKET_OVERHEAD_FRAC
        of = BUCKET_OVERHEAD_FRAC if overhead_frac is None else overhead_frac
        with self._lock:
            total_n = 0
            acc = 0.0
            for (sp, b), (ewma, mb) in self._latency.items():
                if sp != spec or mb <= 0:
                    continue
                frac = min(1.0, of + (1.0 - of) * min(b, mb) / mb)
                acc += ewma.count * (ewma.value / frac)
                total_n += ewma.count
            if not total_n:
                return prior_ms
            measured_full = acc / total_n
            w = self._weight(total_n)
            return w * measured_full + (1.0 - w) * prior_ms

    # --- power / energy -----------------------------------------------------

    def note_energy(self, tenant: str, energy_mj: float,
                    busy_s: float) -> None:
        """Accumulate one batch's measured energy/busy (the engine's hook).

        Does not bump :meth:`version`: energy totals feed power pricing
        (read fresh every arbitration), not the derived latency tables
        the version counter invalidates."""
        if energy_mj < 0 or busy_s < 0:
            return
        with self._lock:
            e, b = self._energy.get(tenant, (0.0, 0.0))
            self._energy[tenant] = (e + energy_mj, b + busy_s)

    def busy_power_w(self, tenant: str) -> Optional[float]:
        """Measured energy / busy time — watts while actually computing."""
        with self._lock:
            e, b = self._energy.get(tenant, (0.0, 0.0))
            return (e / 1e3) / b if b > 0 else None

    def note_power(self, tenant: str, measured_w: float,
                   modelled_w: float) -> None:
        """One wall-clock power observation against the granted slice's
        modelled watts (the arbiter's per-tick hook)."""
        if modelled_w <= 0 or measured_w < 0:
            return
        with self._lock:
            ratio = self._power_ratio.setdefault(tenant, _Ewma())
            ratio.observe(measured_w / modelled_w, self.beta)

    def power_scale(self, tenant: str) -> float:
        """Blended measured/modelled watts ratio (prior 1.0).

        Multiplying ``slice_power_w(hw)`` by this prices a candidate
        point at the tenant's *observed* draw — the measured-energy
        objective.  1.0 until samples accumulate.
        """
        with self._lock:
            ratio = self._power_ratio.get(tenant)
            if ratio is None or ratio.count == 0:
                return 1.0
            w = self._weight(ratio.count)
            return w * ratio.value + (1.0 - w) * 1.0

    def power_samples(self, tenant: str) -> int:
        with self._lock:
            ratio = self._power_ratio.get(tenant)
            return ratio.count if ratio else 0

    # --- bookkeeping --------------------------------------------------------

    def version(self) -> int:
        """Monotone LATENCY-observation counter.

        Derived tables (the arbiter's calibrated LUTs) key their caches
        off it; only :meth:`note_latency` bumps it, since power/energy
        observations are read fresh at use and don't invalidate any
        derived latency table."""
        with self._lock:
            return self._version

    def summary(self) -> dict:
        with self._lock:
            lat = {f"{sp.name()}/b{b}": {"ms": round(e.value, 4),
                                         "n": e.count, "max_batch": mb}
                   for (sp, b), (e, mb) in sorted(
                       self._latency.items(),
                       key=lambda kv: (kv[0][0].name(), kv[0][1]))}
            power = {}
            for tenant in set(self._power_ratio) | set(self._energy):
                row = {}
                ratio = self._power_ratio.get(tenant)
                if ratio is not None and ratio.count:
                    row["scale"] = round(ratio.value, 4)
                    row["n"] = ratio.count
                e, b = self._energy.get(tenant, (0.0, 0.0))
                if b > 0:
                    row["busy_power_w"] = round((e / 1e3) / b, 2)
                    row["energy_mj"] = round(e, 2)
                power[tenant] = row
            return {"latency": lat, "power": power,
                    "version": self._version}

    # --- persistence (bench/CLI: warm a store from a recorded run) ---------

    def save(self, path: str) -> None:
        with self._lock:
            payload = {
                "schema": 1, "beta": self.beta,
                "prior_weight": self.prior_weight,
                "latency": [
                    {"spec": dataclasses.asdict(sp), "bucket": b,
                     "ms": e.value, "n": e.count, "max_batch": mb}
                    for (sp, b), (e, mb) in self._latency.items()],
                "power_ratio": {t: {"value": r.value, "n": r.count}
                                for t, r in self._power_ratio.items()},
                "energy": {t: list(eb) for t, eb in self._energy.items()},
            }
        with open(path, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)

    @classmethod
    def load(cls, path: str) -> "CalibrationStore":
        with open(path) as f:
            payload = json.load(f)
        store = cls(beta=payload.get("beta", EWMA_BETA),
                    prior_weight=payload.get("prior_weight", PRIOR_WEIGHT))
        for row in payload.get("latency", ()):
            spec = SubnetSpec(**row["spec"])
            store._latency[(spec, int(row["bucket"]))] = (
                _Ewma(value=float(row["ms"]), count=int(row["n"])),
                int(row["max_batch"]))
        for tenant, r in payload.get("power_ratio", {}).items():
            store._power_ratio[tenant] = _Ewma(value=float(r["value"]),
                                               count=int(r["n"]))
        for tenant, (e, b) in payload.get("energy", {}).items():
            store._energy[tenant] = (float(e), float(b))
        store._version = 1
        return store
