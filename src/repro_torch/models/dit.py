"""DiT (Diffusion Transformer, Peebles & Xie) with adaLN-zero conditioning.

Counterpart of the reference ``models/dit.py``.  Assigned `dit-l2`: patch
2, 24 layers, d_model 1024, 16 heads, over VAE latents (img_res/8).
Elastic width/depth apply as in the ViT (a static ``E`` slices, a masked
``E`` of 0-d tensors keeps full widths with zeros past the active
channels and skips the layers past ``a_layers``, as ``models/vit.py``
does); the diffusion-native latency knob is the sampler step count (see
``models/diffusion.py``).  The layer stack is a list of per-layer dicts
(the reference stacks them on a leading axis for ``jax.lax.scan``).

Every product is K1 or K2 (``kernels.ops``): the patch embed (a 2x2
stride-2 VALID conv: unfold + K1), the timestep and class MLPs, the
adaLN modulations, attention and the MLPs.  With ``remat`` on and a
gradient wanted, each block runs under ``torch.utils.checkpoint`` (the
reference's ``jax.checkpoint`` of the scan body); the recompute takes the
forward's route (kernel or plain).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core import layers as L
from repro_torch.core.elastic import active_mask, mask_dim
from repro_torch.core.types import ElasticSpace, is_static
from repro_torch.device import resolve_device
from repro_torch.kernels import ops


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    name: str
    img_res: int = 256
    patch: int = 2
    in_channels: int = 4          # VAE latent channels
    n_layers: int = 24
    d_model: int = 1024
    n_heads: int = 16
    n_classes: int = 1000
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "none"
    elastic: ElasticSpace = ElasticSpace()

    @property
    def latent_res(self) -> int:
        return self.img_res // 8

    @property
    def d_ff(self) -> int:
        return self.d_model * 4

    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.to(torch.float32)[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _zero_dense(d_in: int, d_out: int, dtype, device) -> dict:
    """adaLN-zero's modulation (and the UNet's ``proj_out``): zero kernel
    and bias, so every block starts as the identity."""
    return {"kernel": torch.zeros((d_in, d_out), dtype=dtype, device=device),
            "bias": torch.zeros((d_out,), dtype=dtype, device=device)}


def _block_init(gen: torch.Generator, cfg: DiTConfig, device) -> dict:
    d_head = cfg.d_model // cfg.n_heads
    kw = dict(dtype=cfg.pdtype(), device=device)
    return {
        "ln1": L.layernorm_init(cfg.d_model, **kw),
        "attn": L.attention_init(gen, cfg.d_model, cfg.n_heads, cfg.n_heads,
                                 d_head, qkv_bias=True, **kw),
        "ln2": L.layernorm_init(cfg.d_model, **kw),
        "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, gated=False, bias=True,
                          **kw),
        # adaLN-zero: 6 x d_model modulation from conditioning (zero-init)
        "ada": _zero_dense(cfg.d_model, 6 * cfg.d_model, **kw),
    }


def dit_init(gen: torch.Generator, cfg: DiTConfig, *,
             device: Optional[torch.device] = None) -> dict:
    """Random parameters with the reference's distributions (normal
    kernels scaled by 1/sqrt(fan_in), 0.02-scaled position and class
    tables, zero biases, unit LayerNorm scales, zero adaLN modulations),
    drawn from ``gen`` on its device.  The parameters live on the card
    unless the caller passes ``"cpu"``."""
    device = resolve_device(device)
    pd = cfg.pdtype()
    kw = dict(dtype=pd, device=device)
    np_ = (cfg.latent_res // cfg.patch) ** 2
    params = {
        "patch_embed": L.conv_init(gen, cfg.patch, cfg.in_channels,
                                   cfg.d_model, bias=True, **kw),
        "pos": L._normal(gen, (np_, cfg.d_model), 0.02, pd, device),
        "t_mlp1": L.dense_init(gen, 256, cfg.d_model, **kw),
        "t_mlp2": L.dense_init(gen, cfg.d_model, cfg.d_model, **kw),
        "y_embed": L.embedding_init(gen, cfg.n_classes + 1, cfg.d_model,
                                    **kw),
        "final_ln": L.layernorm_init(cfg.d_model, **kw),
        "final": L.dense_init(gen, cfg.d_model,
                              cfg.patch * cfg.patch * cfg.in_channels * 2,
                              **kw),
        "final_ada": _zero_dense(cfg.d_model, 2 * cfg.d_model, **kw),
    }
    params["layers"] = [_block_init(gen, cfg, device)
                        for _ in range(cfg.n_layers)]
    return params


def _modulate(x: torch.Tensor, shift: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    return x * (1 + scale[:, None]) + shift[:, None]


def _ada(pp: dict, c: torch.Tensor, n_chunks: int, am) -> list:
    """The reference's ``ada``: the (d, n_chunks * d) modulation of c split
    into its n_chunks chunks of d.  Sliced (static ``am``): each chunk cut
    to its first ``am`` columns from the first ``am`` rows, one K1 call per
    chunk on the chunk's column view of the resident kernel (the active
    block is not a prefix of the kernel's columns).  Masked: the full
    product, zero past ``am`` in every chunk."""
    w = L._cast(pp["kernel"], c.dtype)
    b = L._cast(pp["bias"], c.dtype)
    d = w.shape[0]
    if am is not None and is_static(am):
        a = int(am)
        return [ops.elastic_matmul_op(c, w[:, i * d:(i + 1) * d], a, a,
                                      n_out=a) + b[i * d:i * d + a]
                for i in range(n_chunks)]
    y = ops.elastic_matmul_op(c, w, d, w.shape[1]) + b
    if am is not None:
        y = y * active_mask(int(am), d, y.dtype, y.device).repeat(n_chunks)
    return list(torch.split(y, d, dim=-1))


def _block(h: torch.Tensor, lp: dict, c: torch.Tensor, cfg: DiTConfig,
           am, a_heads, a_ff) -> torch.Tensor:
    sh1, sc1, g1, sh2, sc2, g2 = _ada(lp["ada"], c, 6, am)
    hn = _modulate(L.layernorm_apply(lp["ln1"], h, a=am), sh1, sc1)
    att, _ = L.attention_apply(lp["attn"], hn, n_heads=cfg.n_heads,
                               n_kv=cfg.n_heads,
                               d_head=cfg.d_model // cfg.n_heads,
                               causal=False, a_model=am, a_heads=a_heads)
    h = h + att * g1[:, None]
    hn = _modulate(L.layernorm_apply(lp["ln2"], h, a=am), sh2, sc2)
    ff = L.mlp_apply(lp["mlp"], hn, a_model=am, a_ff=a_ff, act="gelu")
    return h + ff * g2[:, None]


def dit_apply(params: dict, latents: torch.Tensor, t: torch.Tensor,
              y: torch.Tensor, cfg: DiTConfig, *, E=None) -> torch.Tensor:
    """latents (B,H,W,C), t (B,), y (B,) labels -> noise/var pred (B,H,W,2C)."""
    E = dict(E or {})
    a_model = E.get("a_model")
    a_layers = E.get("a_layers")
    B = latents.shape[0]
    cdt = cfg.cdtype()

    x = L.conv_apply(params["patch_embed"], latents.to(cdt),
                     stride=cfg.patch, padding="VALID")
    x = x.reshape(B, -1, cfg.d_model) + params["pos"].to(cdt)[None]

    temb = timestep_embedding(t, 256).to(cdt)
    c = L.dense_apply(params["t_mlp2"],
                      F.silu(L.dense_apply(params["t_mlp1"], temb)))
    c = c + L.embedding_apply(params["y_embed"], y.long(), dtype=cdt)
    c = F.silu(c)

    if a_model is not None:
        if is_static(a_model):
            x, c = x[..., : int(a_model)], c[..., : int(a_model)]
        else:
            x, c = mask_dim(x, a_model, -1), mask_dim(c, a_model, -1)

    # masked depth: the layers past a_layers add exact zeros in the
    # reference (gate 0); the port skips them (see models/vit.py)
    stack = params["layers"]
    if a_layers is not None:
        stack = stack[: int(a_layers)]
    knobs = (a_model, E.get("a_heads"), E.get("a_ff"))
    remat = cfg.remat != "none" and torch.is_grad_enabled()
    for lp in stack:
        if remat:
            x = checkpoint(_block, x, lp, c, cfg, *knobs, use_reentrant=False,
                           context_fn=ops.route_contexts)
        else:
            x = _block(x, lp, c, cfg, *knobs)

    sh, sc = _ada(params["final_ada"], c, 2, a_model)
    x = _modulate(L.layernorm_apply(params["final_ln"], x, a=a_model), sh, sc)
    out = L.dense_apply(params["final"], x, a_in=a_model)
    # unpatchify
    p_, C = cfg.patch, cfg.in_channels * 2
    grid = cfg.latent_res // p_
    out = out.reshape(B, grid, grid, p_, p_, C)
    return out.permute(0, 1, 3, 2, 4, 5).reshape(B, grid * p_, grid * p_, C)
