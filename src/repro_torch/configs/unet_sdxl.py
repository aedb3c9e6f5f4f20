"""unet-sdxl — SDXL UNet backbone [arXiv:2307.01952; paper tier].

img_res=1024 latent=128, ch=320, ch_mult=(1,2,4), 2 res blocks,
transformer_depth (0,2,10) [SDXL stage0 has no attention], ctx_dim=2048.
The text-encoder frontend is a stub: ctx/pooled embeddings are inputs.
"""
from repro_torch.configs.registry import ArchDef, DIFF_SHAPES, register
from repro_torch.core.types import ElasticSpace
from repro_torch.models.unet import UNetConfig

ELASTIC = ElasticSpace(
    ffn_mults=(0.5, 0.75, 1.0),
    depth_mults=(0.3, 0.5, 1.0),      # transformer-depth scaling (10 -> 3/5/10)
)


def make_config() -> UNetConfig:
    return UNetConfig(
        name="unet-sdxl", img_res=1024, ch=320, ch_mult=(1, 2, 4),
        n_res_blocks=2, transformer_depth=(0, 2, 10), ctx_dim=2048,
        d_head=64, pooled_dim=1280,
        param_dtype="float32", compute_dtype="bfloat16",
        elastic=ELASTIC,
    )


def make_smoke() -> UNetConfig:
    return UNetConfig(
        name="unet-smoke", img_res=64, ch=32, ch_mult=(1, 2),
        n_res_blocks=1, transformer_depth=(0, 2), ctx_dim=64, d_head=16,
        pooled_dim=32, param_dtype="float32", compute_dtype="float32",
        elastic=ElasticSpace(ffn_mults=(0.5, 1.0), depth_mults=(0.5, 1.0)),
    )


register(ArchDef(
    arch_id="unet-sdxl", family="diffusion",
    make_config=make_config, make_smoke=make_smoke,
    shapes=DIFF_SHAPES, optimizer="adamw",
    source="arXiv:2307.01952 (paper tier)",
))
