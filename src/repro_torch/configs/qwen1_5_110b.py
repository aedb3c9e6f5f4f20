"""qwen1.5-110b — dense LM with QKV bias [hf:Qwen/Qwen1.5; hf tier].

80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064.
Field for field the reference's config (``tests/test_torch_lm_configs.py``
checks it).  The port serves it on one card cut to 8 of its 80 layers
(``launch/steps.py:ONE_CARD_CUT``).
"""
from repro_torch.configs.registry import ArchDef, LM_SHAPES, register
from repro_torch.core.types import ElasticSpace
from repro_torch.models.transformer import LMConfig

ELASTIC = ElasticSpace(
    ffn_mults=(0.25, 0.5, 0.75, 1.0),   # 12288/24576/36864/49152 — all /16 even
    heads_mults=(0.5, 0.75, 1.0),       # 32/48/64 heads, GQA groups stay even
    depth_mults=(0.5, 0.75, 1.0),
)


def make_config() -> LMConfig:
    return LMConfig(
        name="qwen1.5-110b",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
        d_ff=49152, vocab_size=152064, qkv_bias=True,
        attn_impl="blocked_causal", block_q=512, block_kv=512,
        remat="dots_nb", param_dtype="float32", compute_dtype="bfloat16",
        elastic=ELASTIC,
    )


def make_smoke() -> LMConfig:
    return LMConfig(
        name="qwen1.5-smoke",
        n_layers=4, d_model=64, n_heads=8, n_kv_heads=2, d_head=8,
        d_ff=256, vocab_size=512, qkv_bias=True,
        attn_impl="ref", param_dtype="float32", compute_dtype="float32",
        elastic=ElasticSpace(ffn_mults=(0.5, 1.0), heads_mults=(0.5, 1.0),
                             depth_mults=(0.5, 1.0)),
    )


register(ArchDef(
    arch_id="qwen1.5-110b", family="lm",
    make_config=make_config, make_smoke=make_smoke,
    shapes=LM_SHAPES, optimizer="adamw",
    source="hf:Qwen/Qwen1.5 (hf tier)",
))
