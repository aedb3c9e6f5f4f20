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
                        causal: bool = True,
                        kv_len=None) -> torch.Tensor:
    """Naive attention: q/k/v (BH, S|T, D).  ``kv_len`` (an int or a 0-d
    tensor) masks the keys at or past it, as the reference's decode
    (``core/layers.py:_attn_core``) masks the cache past its fill."""
    D = q.shape[-1]
    s = torch.einsum("bsd,btd->bst", q, k).float()
    s = s / math.sqrt(D)
    S, T = q.shape[1], k.shape[1]
    if causal:
        mask = (torch.arange(S, device=q.device)[:, None]
                >= torch.arange(T, device=q.device)[None, :])
        s = torch.where(mask[None], s, torch.full_like(s, -1e30))
    if kv_len is not None:
        live = torch.arange(T, device=q.device) < kv_len
        s = torch.where(live[None, None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bst,btd->bsd", p.to(q.dtype), v)


def expert_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                      counts: torch.Tensor) -> torch.Tensor:
    """out[e, c] = x[e, c] @ w[e] for c < counts[e], else 0."""
    C = x.shape[1]
    mask = (torch.arange(C, device=x.device)[None, :]
            < counts[:, None]).to(x.dtype)
    return torch.einsum("ecd,edf->ecf", x * mask[..., None], w.to(x.dtype))
