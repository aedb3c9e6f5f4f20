"""granite-20b — dense code LM, MQA [arXiv:2405.04324; hf tier].

52L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152.  GPT-BigCode-style:
non-gated 4x GELU MLP with biases.  Field for field the reference's config
(``tests/test_torch_lm_configs.py`` checks it); its 48 query heads on one
kv head decode on K2's ``decode`` kernel in 6 groups of 8.
"""
from repro_torch.configs.registry import ArchDef, LM_SHAPES, register
from repro_torch.core.types import ElasticSpace
from repro_torch.models.transformer import LMConfig

ELASTIC = ElasticSpace(
    ffn_mults=(0.25, 0.5, 0.75, 1.0),
    heads_mults=(2.0 / 3.0, 1.0),        # 32 / 48 heads: divisible by mesh 16
    depth_mults=(0.5, 0.75, 1.0),
)


def make_config() -> LMConfig:
    return LMConfig(
        name="granite-20b",
        n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1, d_head=128,
        d_ff=24576, vocab_size=49152, qkv_bias=True, gated_mlp=False,
        act="gelu",
        attn_impl="blocked_causal", block_q=512, block_kv=512,
        remat="dots_nb", param_dtype="float32", compute_dtype="bfloat16",
        elastic=ELASTIC,
    )


def make_smoke() -> LMConfig:
    return LMConfig(
        name="granite-smoke",
        n_layers=4, d_model=64, n_heads=8, n_kv_heads=1, d_head=8,
        d_ff=256, vocab_size=512, qkv_bias=True, gated_mlp=False, act="gelu",
        attn_impl="ref", param_dtype="float32", compute_dtype="float32",
        elastic=ElasticSpace(ffn_mults=(0.5, 1.0), heads_mults=(0.5, 1.0),
                             depth_mults=(0.5, 1.0)),
    )


register(ArchDef(
    arch_id="granite-20b", family="lm",
    make_config=make_config, make_smoke=make_smoke,
    shapes=LM_SHAPES, optimizer="adamw",
    source="arXiv:2405.04324 (hf tier)",
))
