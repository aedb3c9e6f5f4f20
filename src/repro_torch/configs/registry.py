"""Architecture registry: ``--arch <id>`` resolves here.

Each architecture module registers an :class:`ArchDef` with its FULL
(paper-table) config, a reduced smoke config of the same family, its
assigned input-shape set, and its optimizer/precision policy.  Same
surface and the same architectures as the reference registry.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str                  # train | prefill | decode | diff_train | diff_gen
    #                            | vis_train | vis_serve
    seq_len: int = 0
    global_batch: int = 0
    img_res: int = 0
    steps: int = 0
    note: str = ""


@dataclasses.dataclass(frozen=True)
class ArchDef:
    arch_id: str
    family: str                # lm | diffusion | vision
    make_config: Callable      # () -> full model config
    make_smoke: Callable       # () -> reduced model config
    shapes: Dict[str, ShapeSpec]
    optimizer: str = "adamw"   # adamw | adafactor | sgdm
    source: str = ""

    def shape(self, name: str) -> ShapeSpec:
        return self.shapes[name]


_REGISTRY: Dict[str, ArchDef] = {}

# every architecture of the reference: the vision transformers, the conv
# nets, the diffusion nets, the MoE LMs and the dense LMs
_MODULES = ("deit_b", "vit_l16", "resnet_152", "efficientnet_b7",
            "dynamic_ofa_supernet", "deepseek_moe_16b", "dit_l2",
            "unet_sdxl", "qwen1_5_110b", "granite_20b", "kimi_k2_1t_a32b")


# the vision families the port runs, by arch-id prefix: what the init,
# the vis_train forward and the model-FLOPs count dispatch on
VISION_FAMILIES = (("vit", ("deit", "vit", "dynamic-ofa")),
                   ("resnet", ("resnet",)),
                   ("effnet", ("efficientnet",)))


def vision_family(arch_id: str) -> Optional[str]:
    """"vit", "resnet" or "effnet" for a vision arch the port runs, else
    None."""
    return next((fam for fam, prefixes in VISION_FAMILIES
                 if arch_id.startswith(prefixes)), None)


def register(arch: ArchDef) -> ArchDef:
    _REGISTRY[arch.arch_id] = arch
    return arch


def get_arch(arch_id: str) -> ArchDef:
    load_all()      # cached imports: cheap after the first call
    key = arch_id.replace("-", "_").replace(".", "_")
    for k, v in _REGISTRY.items():
        if k == arch_id or k.replace("-", "_").replace(".", "_") == key:
            return v
    raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")


def list_archs():
    load_all()
    return sorted(_REGISTRY)


def load_all():
    for m in _MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")


# ---------------------------------------------------------------------------
# shared shape sets (assigned per family)
# ---------------------------------------------------------------------------

LM_SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", seq_len=4096, global_batch=256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", seq_len=32768,
                             global_batch=32),
    "decode_32k": ShapeSpec("decode_32k", "decode", seq_len=32768,
                            global_batch=128),
    "long_500k": ShapeSpec(
        "long_500k", "decode", seq_len=524288, global_batch=1,
        note="decode vs a 512k KV cache is O(S); run for all LM archs "
             "(full-attention only at prefill, which is out of scope here)"),
}

DIFF_SHAPES = {
    "train_256": ShapeSpec("train_256", "diff_train", img_res=256,
                           global_batch=256, steps=1000),
    "gen_1024": ShapeSpec("gen_1024", "diff_gen", img_res=1024,
                          global_batch=4, steps=50),
    "gen_fast": ShapeSpec("gen_fast", "diff_gen", img_res=512,
                          global_batch=16, steps=4),
    "train_1024": ShapeSpec("train_1024", "diff_train", img_res=1024,
                            global_batch=32, steps=1000),
}

VIS_SHAPES = {
    "cls_224": ShapeSpec("cls_224", "vis_train", img_res=224, global_batch=256),
    "cls_384": ShapeSpec("cls_384", "vis_train", img_res=384, global_batch=64),
    "serve_b1": ShapeSpec("serve_b1", "vis_serve", img_res=224, global_batch=1),
    "serve_b128": ShapeSpec("serve_b128", "vis_serve", img_res=224,
                            global_batch=128),
}
