"""resnet-152 — bottleneck ResNet [arXiv:1512.03385; paper tier].

depths (3,8,36,3), width 64, bottleneck x4.  Slimmable width settings with
switchable BN per the slimmable-networks recipe.
"""
from repro_torch.configs.registry import ArchDef, VIS_SHAPES, register
from repro_torch.core.types import ElasticSpace
from repro_torch.models.resnet import ResNetConfig

WIDTH_SETTINGS = (1.0, 0.75, 0.5, 0.25)

ELASTIC = ElasticSpace(
    width_mults=WIDTH_SETTINGS,
    depth_mults=(0.5, 0.75, 1.0),
)


def make_config() -> ResNetConfig:
    return ResNetConfig(
        name="resnet-152", depths=(3, 8, 36, 3), width=64, img_res=224,
        width_settings=WIDTH_SETTINGS,
        param_dtype="float32", compute_dtype="bfloat16", elastic=ELASTIC,
    )


def make_smoke() -> ResNetConfig:
    return ResNetConfig(
        name="resnet-smoke", depths=(2, 2), width=16, img_res=32,
        n_classes=10, width_settings=(1.0, 0.5),
        param_dtype="float32", compute_dtype="float32",
        elastic=ElasticSpace(width_mults=(1.0, 0.5), depth_mults=(0.5, 1.0)),
    )


register(ArchDef(
    arch_id="resnet-152", family="vision",
    make_config=make_config, make_smoke=make_smoke,
    shapes=VIS_SHAPES, optimizer="sgdm",
    source="arXiv:1512.03385 (paper tier)",
))
