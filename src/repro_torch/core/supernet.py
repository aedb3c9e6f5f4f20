"""Sandwich-rule supernet training step (the paper's training recipe).

Counterpart of the reference ``core/supernet.py``: every step evaluates
the max sub-network (teacher, CE on labels), the min sub-network and
``n_random`` random sub-networks (students, in-place distillation from the
teacher) in masked mode -- Slimmable Networks' sandwich rule as used by
Dynamic-OFA.  The host samples the specs; their widths enter as 0-d int32
CPU tensors, so one eager graph covers the whole elastic space.

The loss is the reference's: ``ce(teacher) + kd_weight * sum_i kd(student_i,
teacher) / n_students`` with the teacher's logits detached in every KD
term.  Because they are detached, the four terms share no graph, and the
port takes the gradient term by term: the teacher's forward and backward,
then each student's, summing into the parameters' ``.grad``.  The
gradient is the same sum as the reference's single backward; only one
forward's activations are alive at a time (a quarter of the memory).
"""
from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

from repro_torch.core.distill import ce_loss, kd_loss
from repro_torch.core.elastic import spec_to_dynamic
from repro_torch.core.types import ElasticSpace
from repro_torch.optim.api import clip_by_global_norm, pop_grads


def make_sandwich_step(apply_fn: Callable, update_fn: Callable,
                       dims: Dict[str, int], *, n_random: int = 2,
                       kd_weight: float = 1.0, temperature: float = 1.0,
                       clip: float = 1.0):
    """Returns (step_fn, sample_fn).

    ``apply_fn(params, batch, E) -> logits``;
    ``step_fn(params, opt, batch, E_stack, step) -> (params, opt,
    {"loss", "gnorm"})``, the parameters (leaves that require grad) and
    the optimizer state updated in place, the metrics device scalars;
    ``sample_fn(space, rng) -> E_stack`` host-side sandwich sampling: a
    dict of stacked int32 CPU tensors with leading dim (1 + n_random)
    [min, random...] -- the teacher (max) runs unmasked.
    """
    n_students = 1 + n_random

    def step_fn(params, opt, batch, E_stack, step):
        pop_grads(params)
        loss = sandwich_backward(apply_fn, params, batch, E_stack,
                                 kd_weight=kd_weight, temperature=temperature)
        grads, gn = clip_by_global_norm(pop_grads(params), clip)
        params, opt = update_fn(params, grads, opt, step)
        return params, opt, {"loss": loss, "gnorm": gn}

    def sample_fn(space: ElasticSpace, rng: np.random.Generator):
        specs = [space.min_spec()] + [space.sample(rng)
                                      for _ in range(n_random)]
        stacks: Dict[str, List[torch.Tensor]] = {}
        for spec in specs:
            for k, v in spec_to_dynamic(spec, dims).items():
                stacks.setdefault(k, []).append(v)
        return {k: torch.stack(v) for k, v in stacks.items()}

    return step_fn, sample_fn



def sandwich_backward(apply_fn: Callable, params, batch, E_stack, *,
                      kd_weight: float = 1.0,
                      temperature: float = 1.0) -> torch.Tensor:
    """The sandwich loss of one batch (a detached device scalar), its
    gradient accumulated into the parameters' ``.grad`` term by term: the
    teacher's CE, then each student's KD against the detached teacher
    logits, ``E_stack`` holding one row per student."""
    n_students = len(next(iter(E_stack.values())))
    teacher = apply_fn(params, batch, None)
    loss_t = ce_loss(teacher, batch["labels"])
    loss_t.backward()
    teacher = teacher.detach()
    loss = loss_t.detach()
    for i in range(n_students):
        E = {k: v[i] for k, v in E_stack.items()}
        logits = apply_fn(params, batch, E)
        l_kd = kd_weight * kd_loss(logits, teacher, temperature) / n_students
        l_kd.backward()
        loss = loss + l_kd.detach()
    return loss
