"""Operating points over (latency, accuracy, energy).

The runtime manager chooses among (sub-network x hw-state) points — the
paper's "pre-selected sub-networks with different latency-accuracy
trade-offs".  The reference's Pareto filters come with the slice that
uses them.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class OpPoint:
    """One operating point: a sub-network under a hardware state."""
    subnet: object            # SubnetSpec
    hw_state: object          # HwState
    latency_ms: float
    energy_mj: float
    accuracy: float
