"""The LM's prefill and decode steps and the ViT's train step.

Counterparts of the ``prefill`` and ``decode`` closures of the reference's
``launch/steps.py:_lm_cell`` and the ``train_step`` of its ``_vis_cell``,
without mesh or sharding (one card, eager).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.distill import ce_loss
from repro_torch.models.transformer import (LMConfig, check_decodable,
                                            lm_apply, make_decode_caches)
from repro_torch.models.vit import ViTConfig, vit_apply
from repro_torch.optim.api import clip_by_global_norm, pop_grads


def make_vit_train_step(cfg: ViTConfig, update_fn: Callable) -> Callable:
    """The reference's ``vis_train`` step for the ViTs: cross entropy of
    the full net on the labels, the gradient clipped to global norm 1.0,
    one optimizer update.

    ``step(params, opt, batch, step) -> (params, opt, {"loss", "gnorm"})``
    with the parameters (leaves that require grad) and the optimizer state
    updated in place and the metrics as device scalars."""
    def step(params, opt, batch, step):
        pop_grads(params)
        logits, _ = vit_apply(params, batch["images"], cfg)
        loss = ce_loss(logits, batch["labels"])
        loss.backward()
        grads, gn = clip_by_global_norm(pop_grads(params), 1.0)
        params, opt = update_fn(params, grads, opt, step)
        return params, opt, {"loss": loss.detach(), "gnorm": gn}
    return step


def lm_prefill(params: dict, tokens: torch.Tensor, cfg: LMConfig, *,
               E=None, max_len: Optional[int] = None):
    """tokens (B, S) -> last-position logits (B, V), as the reference's
    prefill returns them.  With ``max_len``, also returns decode caches of
    ``max_len`` slots holding this prefill's k and v (filled to S), ready
    for :func:`lm_decode`: (logits, caches).  Like decode, that raises at a
    sliced depth or head count (fault F4)."""
    if max_len is not None:
        check_decodable(cfg, E)
    logits, _, kv = lm_apply(params, tokens, cfg, E=E,
                             return_kv=max_len is not None)
    # a copy, not a view: a view would keep the (B, S, V) logits alive
    last = logits[:, -1, :].clone()
    if max_len is None:
        return last
    B, S = tokens.shape
    caches = make_decode_caches(cfg, B, max_len, dtype=cfg.cdtype(),
                                filled=S, device=tokens.device)
    for name, layers in kv.items():
        for c, new in zip(caches[name], layers):
            c["k"][:, :S] = new["k"]
            c["v"][:, :S] = new["v"]
    return last, caches


def lm_decode(params: dict, caches: dict, tokens: torch.Tensor,
              cfg: LMConfig, *, E=None):
    """One decode step: tokens (B, 1) against ``caches`` (updated in place)
    -> (logits (B, V), caches).  Raises NotImplementedError at a sliced
    depth or head count, where the reference's decode fails (fault F4)."""
    logits, _, caches = lm_apply(params, tokens, cfg, E=E, caches=caches)
    return logits[:, -1, :], caches
