"""Plain PyTorch oracles for the kernels (the allclose ground truth).

Line-for-line counterparts of the reference ``kernels/ref.py``: the same
masks, the same dtype casts, on any device.
"""
from __future__ import annotations

import math

import torch


def elastic_matmul_ref(x: torch.Tensor, w: torch.Tensor, k_act,
                       n_act) -> torch.Tensor:
    """y = x[:, :k_act] @ w[:k_act, :n_act], zero beyond n_act."""
    K = x.shape[1]
    N = w.shape[1]
    kmask = (torch.arange(K, device=x.device) < k_act).to(x.dtype)
    nmask = (torch.arange(N, device=x.device) < n_act).to(x.dtype)
    y = (x * kmask[None, :]) @ w.to(x.dtype)
    return y * nmask[None, :]


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True) -> torch.Tensor:
    """Naive attention: q/k/v (BH, S|T, D)."""
    D = q.shape[-1]
    s = torch.einsum("bsd,btd->bst", q, k).float()
    s = s / math.sqrt(D)
    if causal:
        S, T = q.shape[1], k.shape[1]
        mask = (torch.arange(S, device=q.device)[:, None]
                >= torch.arange(T, device=q.device)[None, :])
        s = torch.where(mask[None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bst,btd->bsd", p.to(q.dtype), v)
