"""deit-b — DeiT-Base with distillation token [arXiv:2012.12877; paper tier].

img_res=224 patch=16 12L d_model=768 12H d_ff=3072 + distill token.
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
        name="deit-b", img_res=224, patch=16, n_layers=12, d_model=768,
        n_heads=12, d_ff=3072, distill_token=True, exit_layers=(3, 7, 11),
        param_dtype="float32", compute_dtype="bfloat16", elastic=ELASTIC,
    )


def make_smoke() -> ViTConfig:
    return ViTConfig(
        name="deit-smoke", img_res=32, patch=8, n_layers=4, d_model=32,
        n_heads=4, d_ff=64, n_classes=10, distill_token=True,
        exit_layers=(1, 3), param_dtype="float32", compute_dtype="float32",
        elastic=ElasticSpace(width_mults=(0.5, 1.0), ffn_mults=(0.5, 1.0),
                             heads_mults=(0.5, 1.0), depth_mults=(0.5, 1.0)),
    )


register(ArchDef(
    arch_id="deit-b", family="vision",
    make_config=make_config, make_smoke=make_smoke,
    shapes=VIS_SHAPES, optimizer="adamw",
    source="arXiv:2012.12877 (paper tier)",
))
