"""Elastic layers of the serving path (functional: params dict, apply).

Counterparts of the reference ``core/layers.py`` with the same parameter
layouts (dense kernels ``(d_in, d_out)``, conv kernels HWIO) and the same
order of operations and dtypes.  Widths are ``None`` (full) or static
``int`` (sliced mode: the compute shrinks).  Masked mode (tensor widths)
comes with the training slice; passing a tensor width raises.

Every matrix product goes through ``kernels.ops``: the dense layers (and
the patch embed, written as an unfold followed by a dense product) through
the elastic matmul, the attention core through flash attention.  The
products read the FULL resident weights at their active widths; bias adds
and activations stay plain torch ops.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.elastic import take_dim
from repro_torch.core.types import is_static
from repro_torch.kernels.ops import elastic_matmul_op, flash_attention_op


def _cast(p: torch.Tensor, dtype) -> torch.Tensor:
    return p.to(dtype) if p.dtype != dtype else p


def _static(a, name: str):
    if not is_static(a):
        raise NotImplementedError(
            f"{name}: tensor (masked-mode) widths come with the training "
            f"slice of the port; serve with static int widths")
    return None if a is None else int(a)


def _normal(gen: torch.Generator, shape, scale: float, dtype, device):
    t = torch.randn(shape, generator=gen, dtype=torch.float32) * scale
    return t.to(dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Dense
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = True, dtype=torch.float32, device=None,
               scale: Optional[float] = None) -> dict:
    if scale is None:
        scale = 1.0 / math.sqrt(d_in)
    p = {"kernel": _normal(gen, (d_in, d_out), scale, dtype, device)}
    if bias:
        p["bias"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def dense_apply(p: dict, x: torch.Tensor, *, a_in=None,
                a_out=None) -> torch.Tensor:
    """x: (..., a_in). Elastic in/out channels (sliced mode).

    The product reads the active block of the full resident kernel; only
    the active output columns are computed and written.
    """
    w, b = p["kernel"], p.get("bias")
    k_act = _static(a_in, "dense_apply")
    n_act = _static(a_out, "dense_apply")
    k_act = w.shape[0] if k_act is None else k_act
    n_act = w.shape[1] if n_act is None else n_act
    if x.shape[-1] != k_act:
        raise ValueError(f"dense_apply: x width {x.shape[-1]} != active "
                         f"input width {k_act}")
    y = elastic_matmul_op(x, _cast(w, x.dtype), k_act, n_act, n_out=n_act)
    if b is not None:
        y = y + _cast(take_dim(b, n_act, 0), x.dtype)
    return y


# ---------------------------------------------------------------------------
# Normalisation
# ---------------------------------------------------------------------------

def layernorm_init(d: int, dtype=torch.float32, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm_apply(p: dict, x: torch.Tensor, *, a=None,
                    eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last dim with the reference's eps of 1e-6."""
    scale, bias = p["scale"], p["bias"]
    a = _static(a, "layernorm_apply")
    if a is not None:
        # sliced mode: caller already sliced x to (..., a)
        scale, bias = take_dim(scale, a, 0), take_dim(bias, a, 0)
    mean = torch.mean(x, -1, keepdim=True)
    var = torch.mean(torch.square(x - mean), -1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    return y * _cast(scale, x.dtype) + _cast(bias, x.dtype)


# ---------------------------------------------------------------------------
# MLP blocks (dense FFN)
# ---------------------------------------------------------------------------

_ACTS = {
    "silu": F.silu,
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda h: F.gelu(h, approximate="tanh"),
    "relu": F.relu,
}


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, *,
             gated: bool = True, bias: bool = False, dtype=torch.float32,
             device=None) -> dict:
    p = {"wi": dense_init(gen, d_model, d_ff, bias=bias, dtype=dtype,
                          device=device),
         "wo": dense_init(gen, d_ff, d_model, bias=bias, dtype=dtype,
                          device=device)}
    if gated:
        p["wg"] = dense_init(gen, d_model, d_ff, bias=bias, dtype=dtype,
                             device=device)
    return p


def mlp_apply(p: dict, x: torch.Tensor, *, a_model=None, a_ff=None,
              act: str = "silu") -> torch.Tensor:
    """Gated (SwiGLU) or plain FFN with elastic hidden and model dims."""
    h = dense_apply(p["wi"], x, a_in=a_model, a_out=a_ff)
    fn = _ACTS[act]
    if "wg" in p:
        g = dense_apply(p["wg"], x, a_in=a_model, a_out=a_ff)
        h = fn(g) * h
    else:
        h = fn(h)
    return dense_apply(p["wo"], h, a_in=a_ff, a_out=a_model)


# ---------------------------------------------------------------------------
# Attention (MHA/GQA, elastic query heads)
# ---------------------------------------------------------------------------
#
# Query heads are laid out as (R groups, K kv-heads): flat head h = r*K + k,
# as in the reference.  Slicing the first ``a_heads`` heads then keeps every
# kv head with an equal number of groups.

def attention_init(gen: torch.Generator, d_model: int, n_heads: int,
                   n_kv: int, d_head: int, *, qkv_bias: bool = False,
                   dtype=torch.float32, device=None) -> dict:
    kw = dict(bias=qkv_bias, dtype=dtype, device=device)
    return {
        "q": dense_init(gen, d_model, n_heads * d_head, **kw),
        "k": dense_init(gen, d_model, n_kv * d_head, **kw),
        "v": dense_init(gen, d_model, n_kv * d_head, **kw),
        "o": dense_init(gen, n_heads * d_head, d_model, **kw),
    }


def attention_apply(p: dict, x: torch.Tensor, *, n_heads: int, n_kv: int,
                    d_head: int, causal: bool = True,
                    rope_theta: Optional[float] = None,
                    a_model=None, a_heads=None) -> tuple:
    """Returns (out (B, S, d_model_active), None).

    The reference's ``impl="ref"`` prefill path with static head slicing.
    Rotary embeddings and the KV cache come with the LM slice of the port,
    so ``rope_theta`` defaults to None here and any other value raises.
    """
    if rope_theta is not None:
        raise NotImplementedError("rope comes with the LM slice of the port")
    B, S, _ = x.shape
    H = n_heads
    mha = n_kv == n_heads
    # MHA: kv heads shrink together with query heads.  GQA/MQA: kv heads stay
    # (they are cheap); query groups per kv head shrink.
    sliced_heads = _static(a_heads, "attention_apply")
    kv_active = n_kv
    if sliced_heads is not None:
        H = sliced_heads
        if mha:
            kv_active = sliced_heads
        elif sliced_heads % n_kv:
            raise ValueError("active heads must keep GQA groups even")
    R = H // kv_active

    q = dense_apply(p["q"], x, a_in=a_model,
                    a_out=None if sliced_heads is None
                    else sliced_heads * d_head)
    a_kv = None if (sliced_heads is None or not mha) else kv_active * d_head
    k = dense_apply(p["k"], x, a_in=a_model, a_out=a_kv)
    v = dense_apply(p["v"], x, a_in=a_model, a_out=a_kv)
    k = k.reshape(B, S, kv_active, d_head)
    v = v.reshape(B, S, kv_active, d_head)
    if R == 1:
        out = flash_attention_op(q.reshape(B, S, H, d_head), k, v,
                                 causal=causal)
    else:
        # the kernel groups query heads by kv head (h // R): reorder the
        # reference's (R, K) head layout to (K, R) and back
        qg = q.reshape(B, S, R, kv_active, d_head).transpose(2, 3)
        out = flash_attention_op(qg.reshape(B, S, H, d_head), k, v,
                                 causal=causal)
        out = out.reshape(B, S, kv_active, R, d_head).transpose(2, 3)
    out = out.reshape(B, S, H * d_head)
    a_in_o = None if sliced_heads is None else sliced_heads * d_head
    y = dense_apply(p["o"], out, a_in=a_in_o, a_out=a_model)
    return y, None


# ---------------------------------------------------------------------------
# Convolution: the patch embed (stride == kernel, VALID)
# ---------------------------------------------------------------------------

def conv_init(gen: torch.Generator, ksize: int, c_in: int, c_out: int, *,
              bias: bool = False, dtype=torch.float32, device=None) -> dict:
    fan_in = ksize * ksize * c_in
    p = {"kernel": _normal(gen, (ksize, ksize, c_in, c_out),
                           1.0 / math.sqrt(fan_in), dtype, device)}
    if bias:
        p["bias"] = torch.zeros((c_out,), dtype=dtype, device=device)
    return p


def conv_apply(p: dict, x: torch.Tensor, *, stride: int,
               padding: str = "VALID") -> torch.Tensor:
    """NHWC conv with an HWIO kernel whose stride equals its size (VALID):
    the ViT patch embed.  Written as a non-overlapping unfold into
    (B*N, P*P*C) in HWIO order and one elastic matmul, which keeps cuDNN
    (and its TF32 default) out of the path.  Other convolutions come with
    the conv-net slice of the port."""
    w, b = p["kernel"], p.get("bias")
    P, P2, C, O = w.shape
    if padding != "VALID" or stride != P or P2 != P or x.shape[-1] != C:
        raise NotImplementedError(
            "only the patch embed (stride == kernel size, VALID) is ported")
    B, Hh, Ww, _ = x.shape
    gh, gw = Hh // P, Ww // P
    x = x[:, :gh * P, :gw * P]
    patches = (x.reshape(B, gh, P, gw, P, C).permute(0, 1, 3, 2, 4, 5)
               .reshape(B * gh * gw, P * P * C))
    wk = _cast(w, x.dtype).reshape(P * P * C, O)
    y = elastic_matmul_op(patches, wk, P * P * C, O, n_out=O)
    y = y.reshape(B, gh, gw, O)
    if b is not None:
        y = y + _cast(b, x.dtype)
    return y
