"""kimi-k2-1t-a32b — trillion-param MoE LM [arXiv:2501.kimi2; unverified].

61L d_model=7168 64H (GQA kv=8) d_ff=2048/expert vocab=163840,
MoE 384 experts top-8 (+1 shared, first layer dense — DeepSeek-V3-style
layout; the dense-layer FFN width is an approximation the reference
makes).  Field for field the reference's config
(``tests/test_torch_lm_configs.py`` checks it), attention included: GQA
with 8 kv heads of head dim 112 (the published model's latent attention
is not modelled by the reference, nor here).

Precision/optimizer policy as the reference's: bf16 params + Adafactor
(factored second moment).  The port serves it on one card cut to 2 of its
61 layers, the dense first layer and one MoE layer, and trains it there
cut to the dense first layer (``launch/steps.py:ONE_CARD_CUT``).
"""
from repro_torch.configs.registry import ArchDef, LM_SHAPES, register
from repro_torch.core.types import ElasticSpace
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

ELASTIC = ElasticSpace(
    ffn_mults=(0.5, 0.75, 1.0),
    heads_mults=(0.5, 0.75, 1.0),
    depth_mults=(0.5, 0.75, 1.0),
    expert_counts=(192, 256, 384),
    top_ks=(4, 6, 8),
)


def make_config() -> LMConfig:
    return LMConfig(
        name="kimi-k2-1t-a32b",
        n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_head=112,
        d_ff=2048, vocab_size=163840,
        moe=MoEConfig(n_experts=384, top_k=8, d_ff=2048, n_shared=1,
                      capacity_factor=1.25, group_size=256),
        first_k_dense=1, d_ff_dense=18432,
        attn_impl="blocked_causal", block_q=512, block_kv=512,
        remat="dots_nb", param_dtype="bfloat16", compute_dtype="bfloat16",
        elastic=ELASTIC,
    )


def make_smoke() -> LMConfig:
    return LMConfig(
        name="kimi-k2-smoke",
        n_layers=4, d_model=64, n_heads=8, n_kv_heads=2, d_head=8,
        d_ff=32, vocab_size=512,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=32, n_shared=1,
                      capacity_factor=2.0, group_size=32),
        first_k_dense=1, d_ff_dense=128,
        attn_impl="ref", param_dtype="float32", compute_dtype="float32",
        elastic=ElasticSpace(ffn_mults=(0.5, 1.0), heads_mults=(0.5, 1.0),
                             depth_mults=(0.5, 1.0), expert_counts=(4, 8),
                             top_ks=(1, 2)),
    )


register(ArchDef(
    arch_id="kimi-k2-1t-a32b", family="lm",
    make_config=make_config, make_smoke=make_smoke,
    shapes=LM_SHAPES, optimizer="adafactor",
    source="arXiv:2501.kimi2 (paper-table; unverified tier)",
))
