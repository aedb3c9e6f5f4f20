"""In-place distillation for supernet training (sandwich rule).

Counterpart of the reference ``core/distill.py``: the largest sub-network
acts as the teacher within the same training step (Yu et al. 2019; Cai et
al. 2020 progressive shrinking): sub-network logits are trained against
soft teacher targets, the teacher against ground truth.  Plain tensor ops,
in the same order and dtypes as the reference.
"""
from __future__ import annotations

from typing import Optional

import torch


def kd_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
            temperature: float = 1.0) -> torch.Tensor:
    """KL(teacher || student) with a detached teacher, mean over tokens."""
    t = teacher_logits.detach() / temperature
    s = student_logits / temperature
    p_t = torch.softmax(t, -1)
    logp_t = torch.log_softmax(t, -1)
    logp_s = torch.log_softmax(s, -1)
    kl = torch.sum(p_t * (logp_t - logp_s), dim=-1)
    return torch.mean(kl) * temperature ** 2


def ce_loss(logits: torch.Tensor, labels: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-mean cross entropy in fp32; labels int, optional validity
    mask."""
    logp = torch.log_softmax(logits.float(), -1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)
    return torch.mean(nll)


def sandwich_loss(apply_fn, params, batch, specs, *, kd_weight: float = 1.0,
                  temperature: float = 1.0):
    """Sandwich-rule loss: teacher (max) on labels + students on KD.

    ``apply_fn(params, batch, spec) -> logits``.  ``specs`` must start with
    the max spec.  Returns (total_loss, metrics).
    """
    teacher_logits = apply_fn(params, batch, specs[0])
    loss = ce_loss(teacher_logits, batch["labels"])
    metrics = {"loss_teacher": loss}
    for i, spec in enumerate(specs[1:]):
        logits = apply_fn(params, batch, spec)
        l_kd = kd_loss(logits, teacher_logits, temperature)
        l_ce = ce_loss(logits, batch["labels"])
        loss = loss + kd_weight * l_kd + (1.0 - min(kd_weight, 1.0)) * l_ce
        metrics[f"loss_subnet{i}"] = l_kd
    return loss, metrics
