"""Diffusion substrate: DDPM noise schedule, training loss, DDIM sampler.

Counterpart of the reference ``models/diffusion.py``.  The sampler step
count is a first-class latency knob for the runtime governor (the
diffusion-native analogue of the paper's depth scaling): a 50-step
schedule and a distilled 4-step schedule trade quality for time.

Noise comes from an explicit ``torch.Generator`` (the reference splits a
JAX key).  The DDIM loop (:func:`ddim_loop`, the reference's ``body``
under ``fori_loop``) is separate from the initial draw, so the same x_T
can be fed to both implementations.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch


def make_schedule(n_train_steps: int = 1000, beta_start: float = 1e-4,
                  beta_end: float = 0.02, device=None) -> dict:
    betas = torch.linspace(beta_start, beta_end, n_train_steps,
                           dtype=torch.float32, device=device)
    alphas = 1.0 - betas
    abar = torch.cumprod(alphas, 0)
    return {"betas": betas, "alphas": alphas, "alphas_bar": abar}


def schedule_on(sched: dict, device: torch.device) -> dict:
    """``sched`` with its tables on ``device`` (the same dict when they
    are there already)."""
    if sched["alphas_bar"].device == device:
        return sched
    return {k: v.to(device) for k, v in sched.items()}


def q_sample(sched: dict, x0: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """Forward-noise x0 at integer timesteps t."""
    ab = sched["alphas_bar"][t.long()]
    shape = (-1,) + (1,) * (x0.ndim - 1)
    return (torch.sqrt(ab).reshape(shape) * x0
            + torch.sqrt(1.0 - ab).reshape(shape) * noise)


def ddpm_loss(denoise_fn: Callable, sched: dict, x0: torch.Tensor,
              generator: torch.Generator) -> torch.Tensor:
    """Standard epsilon-prediction MSE. denoise_fn(x_t, t) -> eps_hat; t
    and the noise drawn from ``generator`` (on its device) and moved to
    x0's."""
    n = sched["betas"].shape[0]
    dev = generator.device
    t = torch.randint(0, n, (x0.shape[0],), generator=generator,
                      device=dev).to(x0.device)
    noise = torch.randn(x0.shape, generator=generator, device=dev,
                        dtype=torch.float32).to(x0.device, x0.dtype)
    x_t = q_sample(sched, x0, t, noise)
    eps = denoise_fn(x_t, t)
    eps = eps[..., : x0.shape[-1]]          # models may emit (eps, var)
    return torch.mean(torch.square(eps.float() - noise))


def ddim_timesteps(n: int, steps: int) -> list:
    """The reference's ``linspace(n - 1, 0, steps).astype(int32)``: the
    timestep of each model evaluation, first to last.  JAX's fp32
    linspace computes ``start * (1 - i / div) + stop * (i / div)``, whose
    round-off truncates some steps one below the exact value (4 steps:
    999, 665, 332, 0); the same IEEE fp32 arithmetic here keeps them.
    XLA's CPU code rounds differently at a few counts (28, 38, 55, 64,
    75 and 82 of 1 to 100, one step one off): none the repo samples with
    (4 and 50)."""
    if steps == 1:
        return [n - 1]
    div = steps - 1
    frac = torch.arange(div, dtype=torch.float32) / div
    out = float(n - 1) * (1 - frac) + 0.0 * frac
    return out.to(torch.int32).tolist() + [0]


def ddim_loop(denoise_fn: Callable, sched: dict, x: torch.Tensor, *,
              steps: int = 50, dtype=torch.float32) -> torch.Tensor:
    """DDIM (eta 0) from x = x_T: ``steps`` model evaluations, each
    ``denoise_fn(x, t (B,) int32) -> eps`` (first ``x.shape[-1]`` channels
    kept), the update in fp32 and the iterate cast to ``dtype``."""
    abar = sched["alphas_bar"]
    ts = ddim_timesteps(abar.shape[0], steps)
    B = x.shape[0]
    for i, t in enumerate(ts):
        ab_t = abar[t]
        ab_n = abar[ts[i + 1]] if i + 1 < steps else \
            torch.ones((), dtype=torch.float32, device=abar.device)
        eps = denoise_fn(x, torch.full((B,), t, dtype=torch.int32,
                                       device=x.device))
        eps = eps[..., : x.shape[-1]].float()
        xf = x.float()
        x0 = (xf - torch.sqrt(1 - ab_t) * eps) / torch.sqrt(ab_t)
        x = (torch.sqrt(ab_n) * x0 + torch.sqrt(1 - ab_n) * eps).to(dtype)
    return x


def ddim_sample(denoise_fn: Callable, sched: dict, shape: tuple,
                generator: torch.Generator, *, steps: int = 50,
                dtype=torch.float32,
                device: Optional[torch.device] = None) -> torch.Tensor:
    """DDIM sampling: x_T ~ N(0, I) of ``shape`` drawn from ``generator``
    (on its device, then placed on ``device``), then :func:`ddim_loop`."""
    x = torch.randn(shape, generator=generator, device=generator.device,
                    dtype=torch.float32).to(device or generator.device,
                                            dtype)
    return ddim_loop(denoise_fn, schedule_on(sched, x.device), x,
                     steps=steps, dtype=dtype)
