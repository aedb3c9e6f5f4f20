"""H100 hardware model: roofline terms, DVFS ladder, energy.

Same surface as the reference model, with the constants of one NVIDIA
H100 SXM card (NVIDIA H100 Tensor Core GPU data sheet, SXM5 column,
dense rates without sparsity).  The latency the serve launcher's governor
plans with is MEASURED on the card (``measured_lut`` times the served
forward); these constants only price the modelled terms: energy, and
latency at a modelled clock fraction.

DVFS: the governor's hardware knob is a ladder of clock fractions where
compute scales ~f and power ~f·V² (V roughly ∝ f above the knee).  On the
card the ladder corresponds to locked SM clocks; this module models it,
it does not set clocks.  The SM-clock ladder, MIG slices and the
SXM/PCIe split of a fuller H100 model are later work.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

# --- H100 SXM per-card constants (data sheet) --------------------------------
PEAK_FLOPS = 989e12          # FLOP/s, bf16 dense tensor-core peak
HBM_BW = 3.35e12             # B/s, HBM3
ICI_BW = 450e9               # B/s, NVLink 4: 900 GB/s total, 450 GB/s each way
TDP_W = 700.0                # board power limit at f=1.0 (data sheet max TDP)
IDLE_W = 100.0               # static / uncore power (modelled, not measured)


@dataclasses.dataclass(frozen=True)
class HwState:
    """One hardware operating point (the governor's hardware knob)."""
    chips: int = 1             # cards in the slice
    freq: float = 1.0          # DVFS ladder fraction

    def name(self) -> str:
        return f"c{self.chips}-f{self.freq:g}"


# modelled DVFS ladder (fractions of the nominal clock)
FREQ_LADDER: Tuple[float, ...] = (0.4, 0.55, 0.7, 0.85, 1.0)


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    """The three roofline terms, in seconds (per step, per device)."""
    t_compute: float
    t_memory: float
    t_collective: float

    @property
    def t_total(self) -> float:
        # compute and memory overlap; collectives partially overlap — the
        # roofline estimate is max(compute, memory) + collective tail
        return max(self.t_compute, self.t_memory) + self.t_collective

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)


def roofline(flops_per_dev: float, bytes_per_dev: float,
             coll_bytes_per_dev: float, hw: HwState) -> RooflineTerms:
    f = hw.freq
    return RooflineTerms(
        t_compute=flops_per_dev / (PEAK_FLOPS * f),
        t_memory=bytes_per_dev / HBM_BW,          # HBM clock ~ independent
        t_collective=coll_bytes_per_dev / ICI_BW,
    )


def power_w(hw: HwState, utilization: float = 0.8) -> float:
    """Modelled per-card power at a DVFS point: P = P_idle + P_dyn·f·V²,
    V ∝ max(f, 0.6) above the knee."""
    v = max(hw.freq, 0.6)
    return IDLE_W + (TDP_W - IDLE_W) * utilization * hw.freq * v * v


def slice_power_w(hw: HwState, utilization: float = 0.8) -> float:
    """Total board power of a hardware slice (all cards at the DVFS point)."""
    return power_w(hw, utilization) * hw.chips


def step_energy_mj(terms: RooflineTerms, hw: HwState,
                   utilization: float = 0.8) -> float:
    """Energy per step over the whole slice (millijoules)."""
    return power_w(hw, utilization) * hw.chips * terms.t_total * 1e3
