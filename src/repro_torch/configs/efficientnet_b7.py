"""efficientnet-b7 — compound-scaled MBConv net [arXiv:1905.11946; paper].

width_mult=2.0 depth_mult=3.1 img_res=600.  Runtime slimmable width
settings + elastic depth/kernel on top (the paper technique's native fit:
EfficientNet already parameterises width/depth/resolution).
"""
from repro_torch.configs.registry import ArchDef, VIS_SHAPES, register
from repro_torch.core.types import ElasticSpace
from repro_torch.models.efficientnet import EffNetConfig

WIDTH_SETTINGS = (1.0, 0.75, 0.5)

ELASTIC = ElasticSpace(
    width_mults=WIDTH_SETTINGS,
    depth_mults=(0.5, 0.75, 1.0),
    kernel_sizes=(3, 5),
)


def make_config() -> EffNetConfig:
    return EffNetConfig(
        name="efficientnet-b7", width_mult=2.0, depth_mult=3.1, img_res=600,
        width_settings=WIDTH_SETTINGS,
        param_dtype="float32", compute_dtype="bfloat16", elastic=ELASTIC,
    )


def make_smoke() -> EffNetConfig:
    return EffNetConfig(
        name="effnet-smoke", width_mult=0.5, depth_mult=0.5, img_res=32,
        n_classes=10, width_settings=(1.0, 0.5),
        param_dtype="float32", compute_dtype="float32",
        elastic=ElasticSpace(width_mults=(1.0, 0.5), depth_mults=(0.5, 1.0),
                             kernel_sizes=(3, 5)),
    )


register(ArchDef(
    arch_id="efficientnet-b7", family="vision",
    make_config=make_config, make_smoke=make_smoke,
    shapes=VIS_SHAPES, optimizer="sgdm",
    source="arXiv:1905.11946 (paper tier)",
))
