"""Architecture registry: ``--arch <id>`` resolves here.

Each architecture module registers an :class:`ArchDef` with its FULL
(paper-table) config, a reduced smoke config of the same family, its
assigned input-shape set, and its optimizer/precision policy.  Same
surface as the reference registry, for the vision transformers.
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

# the vision transformers of the serving slice; the other families come
# with their slices of the port
_MODULES = ("deit_b", "vit_l16", "dynamic_ofa_supernet")


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

VIS_SHAPES = {
    "cls_224": ShapeSpec("cls_224", "vis_train", img_res=224, global_batch=256),
    "cls_384": ShapeSpec("cls_384", "vis_train", img_res=384, global_batch=64),
    "serve_b1": ShapeSpec("serve_b1", "vis_serve", img_res=224, global_batch=1),
    "serve_b128": ShapeSpec("serve_b128", "vis_serve", img_res=224,
                            global_batch=128),
}
