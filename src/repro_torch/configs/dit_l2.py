"""dit-l2 — Diffusion Transformer L/2 [arXiv:2212.09748; paper tier].

img_res=256 (latent 32), patch=2, 24L d_model=1024 16H.
"""
from repro_torch.configs.registry import ArchDef, DIFF_SHAPES, register
from repro_torch.core.types import ElasticSpace
from repro_torch.models.dit import DiTConfig

ELASTIC = ElasticSpace(
    width_mults=(0.5, 0.75, 1.0),
    ffn_mults=(0.5, 0.75, 1.0),
    heads_mults=(0.5, 0.75, 1.0),
    depth_mults=(0.5, 0.75, 1.0),
)


def make_config() -> DiTConfig:
    return DiTConfig(
        name="dit-l2", img_res=256, patch=2, n_layers=24, d_model=1024,
        n_heads=16, remat="dots",
        param_dtype="float32", compute_dtype="bfloat16", elastic=ELASTIC,
    )


def make_smoke() -> DiTConfig:
    return DiTConfig(
        name="dit-smoke", img_res=64, patch=2, n_layers=2, d_model=32,
        n_heads=4, n_classes=10, param_dtype="float32",
        compute_dtype="float32",
        elastic=ElasticSpace(width_mults=(0.5, 1.0), ffn_mults=(0.5, 1.0),
                             heads_mults=(0.5, 1.0), depth_mults=(0.5, 1.0)),
    )


register(ArchDef(
    arch_id="dit-l2", family="diffusion",
    make_config=make_config, make_smoke=make_smoke,
    shapes=DIFF_SHAPES, optimizer="adamw",
    source="arXiv:2212.09748 (paper tier)",
))
