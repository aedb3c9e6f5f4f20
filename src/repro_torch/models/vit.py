"""ViT / DeiT encoder with elastic width/depth and early-exit heads.

Counterpart of the reference ``models/vit.py`` (the backbone of the paper's
Dynamic-OFA vision experiments).  A static ``E`` slices the widths, the
heads and the layer stack (serving); a masked ``E`` of 0-d tensors keeps
full widths with zeros past the active channels and gates the layers past
``a_layers`` (training: one graph for every subnet).  Parameters are a
dict in the reference layout, except that the layer stack is a list of
per-layer dicts (the reference stacks them on a leading axis for
``jax.lax.scan``; here the scan is a Python loop).

Under a device mesh (``vit_apply(..., mesh=, specs=)``: one rank of the
training placement, ``distributed.sharding.vision_train_spec_fn``) the
attention and the MLP run tensor parallel where their kernels are split
over ``"model"`` (whole heads a rank); the patch embed, the class and
position tokens, the norms and the heads are replicated.

The depth gate: the reference computes every layer and adds
``gate * f(x)`` with ``gate = (idx < a_layers)``, so a gated layer adds
exact zeros and its parameters get zero gradients.  The port skips the
gated layers' compute: the output is the same, and their parameters get
no gradient, which the optimizer and the gradient clip take as zeros.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import layers as L
from repro_torch.core.elastic import mask_dim
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


def _encode(params, x, cfg: ViTConfig, E, mesh=None, specs=None) -> tuple:
    """images (B,H,W,3) -> (tokens (B,N,a_model), per-layer hiddens|None);
    ``specs`` (with ``mesh``): the training placement of ``params``."""
    a_model = E.get("a_model")
    a_layers = E.get("a_layers")
    B = x.shape[0]
    # patch conv keeps full d_model; masking/slicing happens after pos-embed
    # so the position table stays uniform across sub-networks.
    h = L.conv_apply(params["patch_embed"], x.to(cfg.cdtype()),
                     stride=cfg.patch, padding="VALID")
    h = h.reshape(B, -1, cfg.d_model)
    cls = params["cls"].to(h.dtype)
    h = torch.cat([cls[None].expand(B, -1, -1), h], dim=1)
    h = h + params["pos"].to(h.dtype)[None, : h.shape[1]]
    if a_model is not None:
        if is_static(a_model):
            h = h[..., : int(a_model)]
        else:
            h = mask_dim(h, a_model, -1)

    stack = params["layers"]
    n_gated = 0                 # masked depth: layers past a_layers add 0
    if a_layers is not None:
        n_run = int(a_layers)
        if not is_static(a_layers):
            n_gated = max(0, len(stack) - n_run)
        stack = stack[:n_run]
    d_head = cfg.d_model // cfg.n_heads
    hiddens = [] if cfg.exit_layers else None
    for i, lp in enumerate(stack):
        tp_attn = tp_mlp = None
        if specs is not None:
            tp_attn = L.tp_mesh(specs["layers"][i]["attn"], "q", "o", mesh)
            tp_mlp = L.tp_mesh(specs["layers"][i]["mlp"], "wi", "wo", mesh)
        hn = L.layernorm_apply(lp["ln1"], h, a=a_model)
        att, _ = L.attention_apply(lp["attn"], hn, n_heads=cfg.n_heads,
                                   n_kv=cfg.n_heads, d_head=d_head,
                                   causal=False, a_model=a_model,
                                   a_heads=E.get("a_heads"), tp=tp_attn)
        h = h + att
        hn = L.layernorm_apply(lp["ln2"], h, a=a_model)
        h = h + L.mlp_apply(lp["mlp"], hn, a_model=a_model,
                            a_ff=E.get("a_ff"), act="gelu", tp=tp_mlp)
        if hiddens is not None:
            hiddens.append(h)
    if hiddens is not None:
        hiddens.extend([h] * n_gated)
    return h, hiddens


def vit_apply(params: dict, images: torch.Tensor, cfg: ViTConfig, *, E=None,
              return_exits: bool = False, mesh=None, specs=None):
    """Returns (logits (B,n_classes), aux) — aux carries exit logits/distill.
    ``mesh`` with ``specs`` (the training placement's spec of every leaf,
    a tree beside ``params``): one rank's forward of its blocks, at full
    width (module note)."""
    E = dict(E or {})
    if specs is not None and E:
        raise NotImplementedError("the ViT under the training placement "
                                  "runs at full width")
    a_model = E.get("a_model")
    h, hiddens = _encode(params, images, cfg, E, mesh, specs)
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
