"""EfficientNet (MBConv + SE) with compound scaling: ``efficientnet-b7``
(width_mult 2.0, depth_mult 3.1, 600px).

Counterpart of the reference ``models/efficientnet.py``.  EfficientNet
*is* a statically-scaled family; the paper's dynamic technique adds
runtime width settings (slimmable, switchable BN) and depth and kernel
settings on top of the compound-scaled B7 supernet.  The 1x1 convs
(expand, project, head, the squeeze-excite pair at M = batch) and the
classifier run on K1; the stem and the depthwise convs on cuDNN
(``core/layers.py:conv_apply``).  Under a device mesh
(``effnet_apply(..., mesh=, specs=)``, one rank of the training
placement) each conv whose kernel is split over ``"model"`` computes the
rank's output channels (a depthwise conv from the input's matching
channels) and gathers them, the classifier is row-split, and batch norm
takes the statistics of the whole batch.  The active widths are read
from the BN parameters, which are never split.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import layers as L
from repro_torch.core.types import ElasticSpace, round_channels
from repro_torch.device import resolve_device

# (expand_ratio, channels, repeats, stride, kernel) — EfficientNet-B0 stages
B0_STAGES = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)


@dataclasses.dataclass(frozen=True)
class EffNetConfig:
    name: str
    width_mult: float = 1.0
    depth_mult: float = 1.0
    img_res: int = 224
    n_classes: int = 1000
    se_ratio: float = 0.25
    width_settings: Tuple[float, ...] = (1.0,)   # runtime slimmable widths
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    elastic: ElasticSpace = ElasticSpace()

    def round_filters(self, c: int) -> int:
        c = c * self.width_mult
        new_c = max(8, int(c + 4) // 8 * 8)
        if new_c < 0.9 * c:
            new_c += 8
        return new_c

    def round_repeats(self, r: int) -> int:
        return int(math.ceil(r * self.depth_mult))

    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


def _mbconv_init(gen, c_in, c_out, expand, ksize, se_ratio, n_set, dtype,
                 device):
    kw = dict(dtype=dtype, device=device)
    c_mid = c_in * expand
    c_se = max(1, int(c_in * se_ratio))
    p = {}
    if expand != 1:
        p["expand"] = L.conv_init(gen, 1, c_in, c_mid, **kw)
        p["bn0"] = L.sbn_init(c_mid, n_set, **kw)
    p["dw"] = L.conv_init(gen, ksize, c_mid, c_mid, groups=c_mid, **kw)
    p["bn1"] = L.sbn_init(c_mid, n_set, **kw)
    p["se_reduce"] = L.conv_init(gen, 1, c_mid, c_se, bias=True, **kw)
    p["se_expand"] = L.conv_init(gen, 1, c_se, c_mid, bias=True, **kw)
    p["project"] = L.conv_init(gen, 1, c_mid, c_out, **kw)
    p["bn2"] = L.sbn_init(c_out, n_set, **kw)
    return p


def effnet_init(gen: torch.Generator, cfg: EffNetConfig, *,
                device: Optional[torch.device] = None) -> dict:
    """Random parameters with the reference's distributions, drawn from
    ``gen``; on the card unless the caller passes ``"cpu"``."""
    device = resolve_device(device)
    n_set = len(cfg.width_settings)
    stem_c = cfg.round_filters(32)
    head_c = cfg.round_filters(1280)
    kw = dict(dtype=cfg.pdtype(), device=device)
    params = {
        "stem": L.conv_init(gen, 3, 3, stem_c, **kw),
        "bn_stem": L.sbn_init(stem_c, n_set, **kw),
        "head": L.conv_init(gen, 1, cfg.round_filters(B0_STAGES[-1][1]),
                            head_c, **kw),
        "bn_head": L.sbn_init(head_c, n_set, **kw),
        "fc": L.dense_init(gen, head_c, cfg.n_classes, **kw),
    }
    c_in = stem_c
    for s, (expand, c, r, stride, ksz) in enumerate(B0_STAGES):
        c_out = cfg.round_filters(c)
        blocks = []
        for _ in range(cfg.round_repeats(r)):
            blocks.append(_mbconv_init(gen, c_in, c_out, expand, ksz,
                                       cfg.se_ratio, n_set, cfg.pdtype(),
                                       device))
            c_in = c_out
        params[f"stage{s}"] = blocks
    return params


def _width(bn: dict) -> int:
    """A BN's channel count: the whole width of the conv before it (BN
    parameters are never split, a conv kernel may be)."""
    return bn["scale"].shape[-1]


def _mbconv_apply(p, x, *, stride, setting, train, wm, stats,
                  a_kernel=None, mesh=None, specs=None):
    def bn(name, h, a):
        y, st = L.sbn_apply(p[name], h, setting=setting, train=train, a=a,
                            mesh=mesh)
        if stats is not None:
            stats.append((name, st))
        return y

    def tp(name):
        return L.model_tp(None if specs is None else specs[name], mesh)

    h = x
    expand = "expand" in p
    if expand:
        a_mid = round_channels(_width(p["bn0"]), wm, 8)
        h = L.conv_apply(p["expand"], h, a_out=a_mid, tp=tp("expand"))
        h = F.silu(bn("bn0", h, a_mid))
    # without an expand conv the depthwise conv takes x's width as its
    # groups and keeps its full kernel: at a sliced width its groups see
    # 2+ output channels each and the block runs at full width (F5)
    h = L.conv_apply(p["dw"], h, stride=stride, groups=h.shape[-1],
                     a_in=a_mid if expand else None,
                     a_out=a_mid if expand else None, a_kernel=a_kernel,
                     tp=tp("dw"))
    h = F.silu(bn("bn1", h, a_mid if expand else None))
    # squeeze-excite (kernel dims sliced to match the active mid width)
    se = torch.mean(h, (1, 2), keepdim=True)
    se = F.silu(L.conv_apply(p["se_reduce"], se, a_in=se.shape[-1],
                             tp=tp("se_reduce")))
    se = torch.sigmoid(L.conv_apply(p["se_expand"], se, a_out=h.shape[-1],
                                    tp=tp("se_expand")))
    h = h * se
    a_out = round_channels(_width(p["bn2"]), wm, 8)
    h = L.conv_apply(p["project"], h, a_in=h.shape[-1], a_out=a_out,
                     tp=tp("project"))
    h = bn("bn2", h, a_out)
    if stride == 1 and h.shape[-1] == x.shape[-1]:
        h = h + x
    return h


def effnet_apply(params, images, cfg: EffNetConfig, *, setting: int = 0,
                 depth_mult: float = 1.0, kernel_size=None,
                 train: bool = False, collect_stats: bool = False,
                 mesh=None, specs=None):
    """images (B,H,W,3) -> (logits, stats|None).  ``mesh`` with ``specs``
    (the training placement, a tree beside ``params``): one rank's
    forward of its blocks on its rows of the batch, at full width and
    kernel size (module note)."""
    wm = cfg.width_settings[setting]
    sp = specs or {}
    if specs is not None and (wm != 1.0 or kernel_size is not None):
        raise NotImplementedError("an EfficientNet under the training "
                                  "placement runs at full width")
    stats = [] if (train and collect_stats) else None
    x = images.to(cfg.cdtype())
    a_stem = round_channels(_width(params["bn_stem"]), wm, 8)
    h = L.conv_apply(params["stem"], x, stride=2, a_out=a_stem,
                     tp=L.model_tp(sp.get("stem"), mesh))
    hb, st = L.sbn_apply(params["bn_stem"], h, setting=setting, train=train,
                         a=a_stem, mesh=mesh)
    if stats is not None:
        stats.append(("bn_stem", st))
    h = F.silu(hb)
    for s, (_, _, _, stride, ksz) in enumerate(B0_STAGES):
        blocks = params[f"stage{s}"]
        n_active = max(1, int(round(len(blocks) * depth_mult)))
        for b, blk in enumerate(blocks):
            if b >= n_active and b > 0:
                continue
            ak = None
            if kernel_size is not None and ksz > kernel_size:
                ak = kernel_size
            h = _mbconv_apply(blk, h, stride=stride if b == 0 else 1,
                              setting=setting, train=train, wm=wm,
                              stats=stats, a_kernel=ak, mesh=mesh,
                              specs=sp[f"stage{s}"][b] if sp else None)
    a_head = round_channels(_width(params["bn_head"]), wm, 8)
    h = L.conv_apply(params["head"], h, a_in=h.shape[-1], a_out=a_head,
                     tp=L.model_tp(sp.get("head"), mesh))
    hb, st = L.sbn_apply(params["bn_head"], h, setting=setting, train=train,
                         a=a_head, mesh=mesh)
    if stats is not None:
        stats.append(("bn_head", st))
    h = F.silu(hb)
    pooled = torch.mean(h, (1, 2))
    if L.model_tp(sp.get("fc"), mesh) is not None:
        fc = params["fc"]
        return L._row_parallel(fc, L.model_cols(
            pooled, fc["kernel"].shape[0], mesh), mesh), stats
    logits = L.dense_apply(params["fc"], pooled, a_in=a_head)
    return logits, stats
