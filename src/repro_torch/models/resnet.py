"""ResNet (bottleneck) with slimmable width via switchable BatchNorm.

Counterpart of the reference ``models/resnet.py``.  Channel scaling follows
the slimmable-networks recipe: a discrete set of width settings, each with
its own BN statistics (calibrated post-training).  Depth scaling drops
trailing blocks per stage.  Parameters are a dict in the reference layout
(HWIO conv kernels, ``(n_settings, C)`` BN arrays, each stage a list of
block dicts).  The 1x1 convs and the classifier run on K1, the stem and
the 3x3 convs on cuDNN (``core/layers.py:conv_apply``).  Under a device
mesh (``resnet_apply(..., mesh=, specs=)``, one rank of the training
placement) each conv whose kernel is split over ``"model"`` computes the
rank's output channels and gathers them, the classifier is row-split,
and batch norm takes the statistics of the whole batch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import layers as L
from repro_torch.core.types import ElasticSpace, round_channels
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    name: str
    depths: Tuple[int, ...] = (3, 8, 36, 3)
    width: int = 64
    n_classes: int = 1000
    img_res: int = 224
    width_settings: Tuple[float, ...] = (1.0,)   # slimmable widths
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    elastic: ElasticSpace = ElasticSpace()

    def stage_channels(self, i: int) -> int:
        return self.width * (2 ** i) * 4          # bottleneck expansion 4

    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)


def _bottleneck_init(gen, c_in, c_mid, c_out, n_set, dtype, device):
    kw = dict(dtype=dtype, device=device)
    p = {
        "conv1": L.conv_init(gen, 1, c_in, c_mid, **kw),
        "bn1": L.sbn_init(c_mid, n_set, **kw),
        "conv2": L.conv_init(gen, 3, c_mid, c_mid, **kw),
        "bn2": L.sbn_init(c_mid, n_set, **kw),
        "conv3": L.conv_init(gen, 1, c_mid, c_out, **kw),
        "bn3": L.sbn_init(c_out, n_set, **kw),
    }
    if c_in != c_out:
        p["proj"] = L.conv_init(gen, 1, c_in, c_out, **kw)
        p["bn_proj"] = L.sbn_init(c_out, n_set, **kw)
    return p


def resnet_init(gen: torch.Generator, cfg: ResNetConfig, *,
                device: Optional[torch.device] = None) -> dict:
    """Random parameters with the reference's distributions (normal conv
    and dense kernels scaled by 1/sqrt(fan_in), zero biases, unit BN
    scales and variances), drawn from ``gen``; on the card unless the
    caller passes ``"cpu"`` (with no card and no explicit request this
    raises)."""
    device = resolve_device(device)
    n_set = len(cfg.width_settings)
    kw = dict(dtype=cfg.pdtype(), device=device)
    params = {
        "stem": L.conv_init(gen, 7, 3, cfg.width, **kw),
        "bn_stem": L.sbn_init(cfg.width, n_set, **kw),
        "fc": L.dense_init(gen, cfg.stage_channels(len(cfg.depths) - 1),
                           cfg.n_classes, **kw),
    }
    c_in = cfg.width
    for s, depth in enumerate(cfg.depths):
        c_out = cfg.stage_channels(s)
        blocks = []
        for _ in range(depth):
            blocks.append(_bottleneck_init(gen, c_in, c_out // 4, c_out,
                                           n_set, cfg.pdtype(), device))
            c_in = c_out
        params[f"stage{s}"] = blocks
    return params


def _bottleneck_apply(p, x, *, stride, setting, train, widths, stats,
                      mesh=None, specs=None):
    """widths = (a_mid, a_out) active channels (static, from width setting);
    ``specs``: the block's training placement under ``mesh``."""
    a_mid, a_out = widths

    def bn(name, h, a):
        y, st = L.sbn_apply(p[name], h, setting=setting, train=train, a=a,
                            mesh=mesh)
        if train and stats is not None:
            stats.append((name, st))
        return y

    def tp(name):
        return L.model_tp(None if specs is None else specs[name], mesh)

    h = L.conv_apply(p["conv1"], x, a_out=a_mid, tp=tp("conv1"))
    h = F.relu(bn("bn1", h, a_mid))
    h = L.conv_apply(p["conv2"], h, stride=stride, a_in=a_mid, a_out=a_mid,
                     tp=tp("conv2"))
    h = F.relu(bn("bn2", h, a_mid))
    h = L.conv_apply(p["conv3"], h, a_in=a_mid, a_out=a_out, tp=tp("conv3"))
    h = bn("bn3", h, a_out)
    if "proj" in p:
        sc = L.conv_apply(p["proj"], x, stride=stride, a_out=a_out,
                          tp=tp("proj"))
        sc = bn("bn_proj", sc, a_out)
    else:
        sc = x if stride == 1 else x[:, ::stride, ::stride]
    return F.relu(h + sc)


def resnet_apply(params, images, cfg: ResNetConfig, *, setting: int = 0,
                 depth_mult: float = 1.0, train: bool = False,
                 collect_stats: bool = False, mesh=None, specs=None):
    """images (B,H,W,3) -> (logits, stats|None).

    ``setting`` indexes cfg.width_settings (slimmable width + its BN set);
    ``depth_mult`` drops trailing non-transition blocks per stage.
    ``mesh`` with ``specs`` (the training placement, a tree beside
    ``params``): one rank's forward of its blocks on its rows of the
    batch, at full width (module note).
    """
    wm = cfg.width_settings[setting]
    sp = specs or {}
    if specs is not None and wm != 1.0:
        raise NotImplementedError("a ResNet under the training placement "
                                  "runs at full width")
    stats = [] if (train and collect_stats) else None
    x = images.to(cfg.cdtype())
    a_stem = round_channels(cfg.width, wm, 8)
    h = L.conv_apply(params["stem"], x, stride=2, a_out=a_stem,
                     tp=L.model_tp(sp.get("stem"), mesh))
    hbn, st = L.sbn_apply(params["bn_stem"], h, setting=setting, train=train,
                          a=a_stem, mesh=mesh)
    if stats is not None:
        stats.append(("bn_stem", st))
    h = L.max_pool_apply(F.relu(hbn), window=3, stride=2)
    prev_a = a_stem
    for s, depth in enumerate(cfg.depths):
        c_out = cfg.stage_channels(s)
        a_mid = round_channels(c_out // 4, wm, 8)
        a_out = round_channels(c_out, wm, 8)
        n_active = max(1, int(round(depth * depth_mult)))
        for b in range(depth):
            if b >= n_active and b > 0:
                continue  # layer scaling: drop trailing blocks
            stride = 2 if (b == 0 and s > 0) else 1
            h = _bottleneck_apply(params[f"stage{s}"][b], h, stride=stride,
                                  setting=setting, train=train,
                                  widths=(a_mid, a_out), stats=stats,
                                  mesh=mesh,
                                  specs=sp[f"stage{s}"][b] if sp else None)
        prev_a = a_out
    pooled = torch.mean(h, (1, 2))
    if L.model_tp(sp.get("fc"), mesh) is not None:
        fc = params["fc"]
        return L._row_parallel(fc, L.model_cols(
            pooled, fc["kernel"].shape[0], mesh), mesh), stats
    logits = L.dense_apply(params["fc"], pooled, a_in=prev_a)
    return logits, stats
