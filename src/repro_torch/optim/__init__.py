"""Optimizers over the port's parameter trees."""
from repro_torch.optim.api import clip_by_global_norm, make_optimizer
