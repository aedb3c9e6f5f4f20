"""dynamic-ofa-supernet — the PAPER's own architecture.

The paper deploys Dynamic-OFA: a ViT/ConvNet supernet whose Pareto-optimal
sub-networks are switched at runtime ([6] Lou et al. CVPRW'21 for ConvNets,
[8] Parry et al. MLCAD'21 for Transformers).  We model it as a ViT-S-sized
supernet with the full elastic space (width/ffn/heads/depth), trained with
the sandwich rule + in-place distillation, and serve it through the runtime
governor.  This is the config the paper-reproduction benchmarks use.
"""
from repro_torch.configs.registry import ArchDef, VIS_SHAPES, register
from repro_torch.core.types import ElasticSpace
from repro_torch.models.vit import ViTConfig

ELASTIC = ElasticSpace(
    width_mults=(0.5, 0.75, 1.0),
    ffn_mults=(0.25, 0.5, 0.75, 1.0),
    heads_mults=(0.5, 0.75, 1.0),
    depth_mults=(1.0 / 3.0, 0.5, 2.0 / 3.0, 5.0 / 6.0, 1.0),
)


def make_config() -> ViTConfig:
    return ViTConfig(
        name="dynamic-ofa-supernet", img_res=224, patch=16, n_layers=12,
        d_model=384, n_heads=6, d_ff=1536, exit_layers=(3, 5, 7, 9, 11),
        param_dtype="float32", compute_dtype="bfloat16", elastic=ELASTIC,
    )


def make_smoke() -> ViTConfig:
    return ViTConfig(
        name="dynamic-ofa-smoke", img_res=32, patch=8, n_layers=6,
        d_model=64, n_heads=4, d_ff=256, n_classes=10,
        exit_layers=(1, 3, 5), param_dtype="float32", compute_dtype="float32",
        elastic=ElasticSpace(width_mults=(0.5, 1.0), ffn_mults=(0.25, 0.5, 1.0),
                             heads_mults=(0.5, 1.0),
                             depth_mults=(1.0 / 3.0, 2.0 / 3.0, 1.0)),
    )


register(ArchDef(
    arch_id="dynamic-ofa-supernet", family="vision",
    make_config=make_config, make_smoke=make_smoke,
    shapes=VIS_SHAPES, optimizer="adamw",
    source="paper [6,7,8]: Dynamic-OFA / OFA / Dynamic Transformer",
))
