"""Runtime resource management layer of the port.

hwmodel  — H100 roofline/DVFS/energy model
lut      — (subnet x hw-state) profile tables, measured on the device
governor — joint algorithm+hardware governor and Linux-governor baselines
monitor  — latency/energy accounting and the paper's workload traces
engine   — dynamic serving engine over the port's ViT on the card
"""
from repro_torch.runtime.hwmodel import HwState, RooflineTerms, roofline, FREQ_LADDER
from repro_torch.runtime.lut import (LUT, measured_lut, accuracy_surrogate,
                                     bucket_ladder)
from repro_torch.runtime.governor import (Constraints, JointGovernor,
                                          PerformanceGovernor,
                                          SchedutilGovernor,
                                          StaticPrunedGovernor)
from repro_torch.runtime.monitor import Monitor, paper_trace, run_governor
from repro_torch.runtime.engine import DynamicServer
