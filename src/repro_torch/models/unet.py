"""SDXL-style UNet (ResBlocks + cross-attention transformer stages).

Counterpart of the reference ``models/unet.py``.  Assigned `unet-sdxl`:
ch=320, ch_mult=(1,2,4), 2 res blocks per stage, transformer depth
(0,2,10) [stage0 has no attention in SDXL -- depth applies to stages 1
and 2], ctx_dim 2048.  Text/pooled conditioning enters as precomputed
stub embeddings per the assignment brief.

Elastic knobs: transformer-depth scaling (``depth_mult``: layer scaling
inside attention stages), FFN width scaling in the transformer blocks
(``a_ff``, static), and the sampler step count at the runtime level.

Routes (``core/layers.py``): the 3x3 and stride-2 convs go to cuDNN, the
1x1 skips, the dense layers and the GEGLU FF to K1, self-attention to K2.
The cross-attention over the 77 context tokens is a plain einsum softmax
in the reference, outside any Pallas kernel; the port runs it on K2 too
(non-causal, S queries over T = 77 keys), so the (B, H, S, 77) fp32
scores are never stored (ROADMAP, deliberate differences).  The upsample
is nearest at exactly 2x: output row i reads input row i // 2.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import layers as L
from repro_torch.core.types import ElasticSpace
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import flash_attention_op
from repro_torch.models.dit import _zero_dense, timestep_embedding


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    name: str
    img_res: int = 1024
    in_channels: int = 4
    ch: int = 320
    ch_mult: Tuple[int, ...] = (1, 2, 4)
    n_res_blocks: int = 2
    transformer_depth: Tuple[int, ...] = (0, 2, 10)   # per stage (0 = no attn)
    ctx_dim: int = 2048
    d_head: int = 64
    pooled_dim: int = 1280
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    elastic: ElasticSpace = ElasticSpace()

    @property
    def latent_res(self) -> int:
        return self.img_res // 8

    @property
    def temb_dim(self) -> int:
        return self.ch * 4

    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


# --- blocks ----------------------------------------------------------------

def _resblock_init(gen, c_in, c_out, temb_dim, kw) -> dict:
    p = {
        "gn1": L.groupnorm_init(c_in, **kw),
        "conv1": L.conv_init(gen, 3, c_in, c_out, bias=True, **kw),
        "temb": L.dense_init(gen, temb_dim, c_out, **kw),
        "gn2": L.groupnorm_init(c_out, **kw),
        "conv2": L.conv_init(gen, 3, c_out, c_out, bias=True, **kw),
    }
    if c_in != c_out:
        p["skip"] = L.conv_init(gen, 1, c_in, c_out, bias=True, **kw)
    return p


def _resblock_apply(p, x, temb):
    h = F.silu(L.groupnorm_apply(p["gn1"], x))
    h = L.conv_apply(p["conv1"], h)
    h = h + L.dense_apply(p["temb"], F.silu(temb))[:, None, None]
    h = F.silu(L.groupnorm_apply(p["gn2"], h))
    h = L.conv_apply(p["conv2"], h)
    skip = L.conv_apply(p["skip"], x) if "skip" in p else x
    return h + skip


def _basic_tblock_init(gen, d, ctx_dim, d_head, kw) -> dict:
    heads = d // d_head
    return {
        "ln1": L.layernorm_init(d, **kw),
        "attn1": L.attention_init(gen, d, heads, heads, d_head, **kw),
        "ln2": L.layernorm_init(d, **kw),
        # cross-attn: kv projected from ctx_dim
        "q2": L.dense_init(gen, d, d, bias=False, **kw),
        "kv2": L.dense_init(gen, ctx_dim, 2 * d, bias=False, **kw),
        "o2": L.dense_init(gen, d, d, bias=False, **kw),
        "ln3": L.layernorm_init(d, **kw),
        "mlp": L.mlp_init(gen, d, d * 4, gated=True, bias=True, **kw),
    }


def _basic_tblock_apply(p, x, ctx, *, heads, d_head, a_ff=None):
    # self-attention
    hn = L.layernorm_apply(p["ln1"], x)
    att, _ = L.attention_apply(p["attn1"], hn, n_heads=heads, n_kv=heads,
                               d_head=d_head, causal=False)
    x = x + att
    # cross-attention over ctx tokens, on K2
    hn = L.layernorm_apply(p["ln2"], x)
    q = L.dense_apply(p["q2"], hn)
    kv = L.dense_apply(p["kv2"], ctx.to(x.dtype))
    k, v = torch.split(kv, kv.shape[-1] // 2, dim=-1)
    B, S, d = q.shape
    T = k.shape[1]
    att = flash_attention_op(q.reshape(B, S, heads, d_head),
                             k.reshape(B, T, heads, d_head),
                             v.reshape(B, T, heads, d_head), causal=False)
    x = x + L.dense_apply(p["o2"], att.reshape(B, S, d))
    # geglu-style FF
    hn = L.layernorm_apply(p["ln3"], x)
    return x + L.mlp_apply(p["mlp"], hn, a_ff=a_ff, act="gelu")


def _transformer2d_init(gen, c, depth, ctx_dim, d_head, kw) -> dict:
    return {
        "gn": L.groupnorm_init(c, **kw),
        "proj_in": L.dense_init(gen, c, c, bias=True, **kw),
        "blocks": [_basic_tblock_init(gen, c, ctx_dim, d_head, kw)
                   for _ in range(depth)],
        "proj_out": _zero_dense(c, c, **kw),
    }


def _transformer2d_apply(p, x, ctx, *, d_head, depth_mult=1.0, a_ff=None):
    B, H, W, C = x.shape
    heads = C // d_head
    h = L.groupnorm_apply(p["gn"], x)
    h = h.reshape(B, H * W, C)
    h = L.dense_apply(p["proj_in"], h)
    n_active = max(1, int(round(len(p["blocks"]) * depth_mult)))
    for blk in p["blocks"][:n_active]:
        h = _basic_tblock_apply(blk, h, ctx, heads=heads, d_head=d_head,
                                a_ff=a_ff)
    h = L.dense_apply(p["proj_out"], h)
    return x + h.reshape(B, H, W, C)


def _upsample2x(h: torch.Tensor) -> torch.Tensor:
    """Nearest 2x of NHWC ``h`` (``jax.image.resize(..., "nearest")`` at
    exactly twice the size): output (i, j) reads input (i // 2, j // 2)."""
    B, H, W, C = h.shape
    return (h[:, :, None, :, None, :].expand(B, H, 2, W, 2, C)
            .reshape(B, 2 * H, 2 * W, C))


# --- full UNet ---------------------------------------------------------------

def unet_init(gen: torch.Generator, cfg: UNetConfig, *,
              device: Optional[torch.device] = None) -> dict:
    """Random parameters with the reference's distributions and tree (each
    stage a dict of lists of blocks), drawn from ``gen`` on its device.
    The parameters live on the card unless the caller passes ``"cpu"``."""
    device = resolve_device(device)
    kw = dict(dtype=cfg.pdtype(), device=device)
    td = cfg.temb_dim
    params = {
        "conv_in": L.conv_init(gen, 3, cfg.in_channels, cfg.ch, bias=True,
                               **kw),
        "t_mlp1": L.dense_init(gen, cfg.ch, td, **kw),
        "t_mlp2": L.dense_init(gen, td, td, **kw),
        "pool_mlp": L.dense_init(gen, cfg.pooled_dim, td, **kw),
        "gn_out": L.groupnorm_init(cfg.ch, **kw),
        "conv_out": L.conv_init(gen, 3, cfg.ch, cfg.in_channels, bias=True,
                                **kw),
    }
    chs = [cfg.ch * m for m in cfg.ch_mult]
    # down path
    down = []
    skip_chs = [cfg.ch]
    c_prev = cfg.ch
    for s, c in enumerate(chs):
        stage = {"res": [], "attn": []}
        for _ in range(cfg.n_res_blocks):
            stage["res"].append(_resblock_init(gen, c_prev, c, td, kw))
            c_prev = c
            if cfg.transformer_depth[s]:
                stage["attn"].append(_transformer2d_init(
                    gen, c, cfg.transformer_depth[s], cfg.ctx_dim,
                    cfg.d_head, kw))
            skip_chs.append(c)
        if s < len(chs) - 1:
            stage["down"] = L.conv_init(gen, 3, c, c, bias=True, **kw)
            skip_chs.append(c)
        down.append(stage)
    params["down"] = down
    # mid
    params["mid"] = {
        "res1": _resblock_init(gen, chs[-1], chs[-1], td, kw),
        "attn": _transformer2d_init(gen, chs[-1], cfg.transformer_depth[-1],
                                    cfg.ctx_dim, cfg.d_head, kw),
        "res2": _resblock_init(gen, chs[-1], chs[-1], td, kw),
    }
    # up path
    up = []
    for s in reversed(range(len(chs))):
        c = chs[s]
        stage = {"res": [], "attn": []}
        for _ in range(cfg.n_res_blocks + 1):
            c_skip = skip_chs.pop()
            stage["res"].append(_resblock_init(gen, c_prev + c_skip, c, td,
                                               kw))
            c_prev = c
            if cfg.transformer_depth[s]:
                stage["attn"].append(_transformer2d_init(
                    gen, c, cfg.transformer_depth[s], cfg.ctx_dim,
                    cfg.d_head, kw))
        if s > 0:
            stage["up"] = L.conv_init(gen, 3, c, c, bias=True, **kw)
        up.append(stage)
    params["up"] = up
    return params


def unet_apply(params: dict, latents: torch.Tensor, t: torch.Tensor,
               ctx: torch.Tensor, pooled: torch.Tensor, cfg: UNetConfig, *,
               E=None) -> torch.Tensor:
    """latents (B,h,w,4), t (B,), ctx (B,77,ctx_dim), pooled (B,pooled_dim)
    -> noise prediction (B,h,w,4)."""
    E = dict(E or {})
    depth_mult = E.get("depth_mult", 1.0)
    a_ff = E.get("a_ff")
    cdt = cfg.cdtype()
    x = latents.to(cdt)
    ctx = ctx.to(cdt)

    temb = timestep_embedding(t, cfg.ch).to(cdt)
    temb = L.dense_apply(params["t_mlp2"],
                         F.silu(L.dense_apply(params["t_mlp1"], temb)))
    temb = temb + L.dense_apply(params["pool_mlp"], pooled.to(cdt))

    def attn(p, h):
        return _transformer2d_apply(p, h, ctx, d_head=cfg.d_head,
                                    depth_mult=depth_mult, a_ff=a_ff)

    h = L.conv_apply(params["conv_in"], x)
    skips = [h]
    for stage in params["down"]:
        for b, res in enumerate(stage["res"]):
            h = _resblock_apply(res, h, temb)
            if stage["attn"]:
                h = attn(stage["attn"][b], h)
            skips.append(h)
        if "down" in stage:
            h = L.conv_apply(stage["down"], h, stride=2)
            skips.append(h)

    h = _resblock_apply(params["mid"]["res1"], h, temb)
    h = attn(params["mid"]["attn"], h)
    h = _resblock_apply(params["mid"]["res2"], h, temb)

    for stage in params["up"]:
        for b, res in enumerate(stage["res"]):
            h = _resblock_apply(res, torch.cat([h, skips.pop()], -1), temb)
            if stage["attn"]:
                h = attn(stage["attn"][b], h)
        if "up" in stage:
            h = L.conv_apply(stage["up"], _upsample2x(h))

    h = F.silu(L.groupnorm_apply(params["gn_out"], h))
    return L.conv_apply(params["conv_out"], h)
