"""Runtime resource management layer of the port.

hwmodel  — H100 roofline/DVFS/energy model
lut      — (subnet x hw-state) profile tables (measured on the device,
           or roofline-modelled)
governor — joint algorithm+hardware governor and Linux-governor baselines
monitor  — latency/energy accounting and the paper's workload traces
engine   — dynamic serving engine over the port's ViT on the card
waterfill— level-agnostic water-filling solver: min-share +
           backlog-first surplus over priced points
arbiter  — multi-workload water-filling arbiter over shared chips/power
           (delegates its objective to waterfill)
telemetry— measured-performance CalibrationStore closing the loop:
           engine-recorded (subnet, bucket) latency EWMAs and measured
           tenant watts feed the LUT columns and the arbiter's energy
           objective
"""
from repro_torch.runtime.hwmodel import HwState, RooflineTerms, roofline, FREQ_LADDER
from repro_torch.runtime.lut import (LUT, model_lut, measured_lut,
                                     accuracy_surrogate, default_hw_states,
                                     bucket_ladder, bucket_for,
                                     bucket_latency_ms)
from repro_torch.runtime.governor import (Constraints, JointGovernor,
                                          PerformanceGovernor,
                                          SchedutilGovernor,
                                          StaticPrunedGovernor)
from repro_torch.runtime.monitor import Monitor, paper_trace, run_governor
from repro_torch.runtime.engine import DynamicServer
from repro_torch.runtime.telemetry import CalibrationStore
# NOTE: the solver function itself stays namespaced
# (``waterfill.waterfill``) — re-exporting the bare name here would
# shadow the submodule attribute and break ``from repro_torch.runtime
# import waterfill`` module imports
from repro_torch.runtime.waterfill import Demand, Grant, PricedPoint
from repro_torch.runtime.arbiter import (AdmissionError, Allocation,
                                         GlobalConstraints, Headroom,
                                         ResourceArbiter, Workload)
