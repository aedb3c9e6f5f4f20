"""ViT / DeiT encoder with elastic width/depth and early-exit heads.

Counterpart of the reference ``models/vit.py`` (the backbone of the paper's
Dynamic-OFA vision experiments) in sliced mode: a static ``E`` slices the
widths, the heads and the layer stack.  Parameters are a dict in the
reference layout, except that the layer stack is a list of per-layer dicts
(the reference stacks them on a leading axis for ``jax.lax.scan``; here the
scan is a Python loop).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import layers as L
from repro_torch.core.types import ElasticSpace, is_static
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    name: str
    img_res: int
    patch: int
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    n_classes: int = 1000
    distill_token: bool = False      # DeiT
    exit_layers: Tuple[int, ...] = ()  # early-exit heads (layer scaling)
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "none"              # the reference's field; unused here
    elastic: ElasticSpace = ElasticSpace()

    @property
    def n_tokens(self) -> int:
        n = (self.img_res // self.patch) ** 2 + 1
        return n + 1 if self.distill_token else n

    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


def _block_init(gen: torch.Generator, cfg: ViTConfig, device) -> dict:
    d_head = cfg.d_model // cfg.n_heads
    kw = dict(dtype=cfg.pdtype(), device=device)
    return {
        "ln1": L.layernorm_init(cfg.d_model, **kw),
        "attn": L.attention_init(gen, cfg.d_model, cfg.n_heads, cfg.n_heads,
                                 d_head, qkv_bias=True, **kw),
        "ln2": L.layernorm_init(cfg.d_model, **kw),
        "mlp": L.mlp_init(gen, cfg.d_model, cfg.d_ff, gated=False, bias=True,
                          **kw),
    }


def vit_init(gen: torch.Generator, cfg: ViTConfig, *,
             device: Optional[torch.device] = None) -> dict:
    """Random parameters with the reference's distributions (normal dense
    and conv kernels scaled by 1/sqrt(fan_in), zero biases, unit LayerNorm
    scales, 0.02-scaled class/position tokens), drawn from ``gen`` on the
    CPU so a seed gives the same weights on every device.

    The parameters live on the card unless the caller passes ``"cpu"``;
    with no card and no explicit request this raises."""
    device = resolve_device(device)
    n_special = 2 if cfg.distill_token else 1
    pd = cfg.pdtype()
    params = {
        "patch_embed": L.conv_init(gen, cfg.patch, 3, cfg.d_model, bias=True,
                                   dtype=pd, device=device),
        "cls": L._normal(gen, (n_special, cfg.d_model), 0.02, pd, device),
        "pos": L._normal(gen, (cfg.n_tokens, cfg.d_model), 0.02, pd, device),
        "final_ln": L.layernorm_init(cfg.d_model, dtype=pd, device=device),
        "head": L.dense_init(gen, cfg.d_model, cfg.n_classes, dtype=pd,
                             device=device),
    }
    params["layers"] = [_block_init(gen, cfg, device)
                        for _ in range(cfg.n_layers)]
    if cfg.distill_token:
        params["head_dist"] = L.dense_init(gen, cfg.d_model, cfg.n_classes,
                                           dtype=pd, device=device)
    if cfg.exit_layers:
        params["exit_heads"] = [
            L.dense_init(gen, cfg.d_model, cfg.n_classes, dtype=pd,
                         device=device)
            for _ in cfg.exit_layers]
    return params


def cast_params(params, dtype: torch.dtype):
    """Every floating tensor of a param tree in ``dtype``.

    ``vit_apply`` casts each weight to the compute dtype where it is used,
    so a server that keeps its resident weights in the compute dtype gets
    the same numbers without a copy per call.
    """
    if isinstance(params, dict):
        return {k: cast_params(v, dtype) for k, v in params.items()}
    if isinstance(params, list):
        return [cast_params(v, dtype) for v in params]
    return params.to(dtype) if params.is_floating_point() else params


def _encode(params, x, cfg: ViTConfig, E) -> tuple:
    """images (B,H,W,3) -> (tokens (B,N,a_model), per-layer hiddens|None)."""
    a_model = E.get("a_model")
    a_layers = E.get("a_layers")
    for name in ("a_model", "a_layers", "a_heads", "a_ff"):
        if not is_static(E.get(name)):
            raise NotImplementedError(
                f"vit_apply: tensor {name} (masked mode) comes with the "
                f"training slice of the port")
    B = x.shape[0]
    # patch conv keeps full d_model; slicing happens after pos-embed so the
    # position table stays uniform across sub-networks.
    h = L.conv_apply(params["patch_embed"], x.to(cfg.cdtype()),
                     stride=cfg.patch, padding="VALID")
    h = h.reshape(B, -1, cfg.d_model)
    cls = params["cls"].to(h.dtype)
    h = torch.cat([cls[None].expand(B, -1, -1), h], dim=1)
    h = h + params["pos"].to(h.dtype)[None, : h.shape[1]]
    if a_model is not None:
        h = h[..., : int(a_model)]

    stack = params["layers"]
    if a_layers is not None:
        stack = stack[: int(a_layers)]
    d_head = cfg.d_model // cfg.n_heads
    hiddens = [] if cfg.exit_layers else None
    for lp in stack:
        hn = L.layernorm_apply(lp["ln1"], h, a=a_model)
        att, _ = L.attention_apply(lp["attn"], hn, n_heads=cfg.n_heads,
                                   n_kv=cfg.n_heads, d_head=d_head,
                                   causal=False, a_model=a_model,
                                   a_heads=E.get("a_heads"))
        h = h + att
        hn = L.layernorm_apply(lp["ln2"], h, a=a_model)
        h = h + L.mlp_apply(lp["mlp"], hn, a_model=a_model,
                            a_ff=E.get("a_ff"), act="gelu")
        if hiddens is not None:
            hiddens.append(h)
    return h, hiddens


def vit_apply(params: dict, images: torch.Tensor, cfg: ViTConfig, *, E=None,
              return_exits: bool = False):
    """Returns (logits (B,n_classes), aux) — aux carries exit logits/distill."""
    E = dict(E or {})
    a_model = E.get("a_model")
    h, hiddens = _encode(params, images, cfg, E)
    h = L.layernorm_apply(params["final_ln"], h, a=a_model)
    logits = L.dense_apply(params["head"], h[:, 0], a_in=a_model)
    aux = {}
    if cfg.distill_token:
        aux["logits_dist"] = L.dense_apply(params["head_dist"], h[:, 1],
                                           a_in=a_model)
    if return_exits and cfg.exit_layers and hiddens is not None:
        outs = []
        for i, layer in enumerate(cfg.exit_layers):
            # a static index past a sliced stack clamps to its last layer,
            # as indexing the reference's stacked hiddens does
            hexit = hiddens[min(layer, len(hiddens) - 1)][:, 0]
            outs.append(L.dense_apply(params["exit_heads"][i], hexit,
                                      a_in=a_model))
        aux["exit_logits"] = outs
    return logits, aux
