"""vit-l16 — ViT-Large/16 [arXiv:2010.11929; paper tier].

img_res=224 patch=16 24L d_model=1024 16H d_ff=4096.
"""
from repro_torch.configs.registry import ArchDef, VIS_SHAPES, register
from repro_torch.core.types import ElasticSpace
from repro_torch.models.vit import ViTConfig

ELASTIC = ElasticSpace(
    width_mults=(0.5, 0.75, 1.0),
    ffn_mults=(0.25, 0.5, 0.75, 1.0),
    heads_mults=(0.5, 0.75, 1.0),
    depth_mults=(0.25, 0.5, 0.75, 1.0),
)


def make_config() -> ViTConfig:
    return ViTConfig(
        name="vit-l16", img_res=224, patch=16, n_layers=24, d_model=1024,
        n_heads=16, d_ff=4096, exit_layers=(7, 15, 23),
        param_dtype="float32", compute_dtype="bfloat16", elastic=ELASTIC,
    )


def make_smoke() -> ViTConfig:
    return ViTConfig(
        name="vit-smoke", img_res=32, patch=8, n_layers=4, d_model=32,
        n_heads=4, d_ff=64, n_classes=10, param_dtype="float32",
        compute_dtype="float32",
        elastic=ElasticSpace(width_mults=(0.5, 1.0), ffn_mults=(0.5, 1.0),
                             heads_mults=(0.5, 1.0), depth_mults=(0.5, 1.0)),
    )


register(ArchDef(
    arch_id="vit-l16", family="vision",
    make_config=make_config, make_smoke=make_smoke,
    shapes=VIS_SHAPES, optimizer="adamw",
    source="arXiv:2010.11929 (paper tier)",
))
