"""Observability of the port: the shared quantile (tracer and metrics later)."""
from repro_torch.obs.metrics import quantile
