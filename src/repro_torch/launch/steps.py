"""The LM's prefill and decode steps.

Counterparts of the ``prefill`` and ``decode`` closures of the reference's
``launch/steps.py:_lm_cell``, without mesh or sharding (one card, eager).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.transformer import (LMConfig, check_decodable,
                                            lm_apply, make_decode_caches)


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
