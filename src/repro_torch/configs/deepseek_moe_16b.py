"""deepseek-moe-16b — fine-grained MoE [arXiv:2401.06066; hf].

28L d_model=2048 16H (MHA kv=16) d_ff=1408/expert vocab=102400,
64 routed experts top-6 + 2 shared, first layer dense (d_ff 10944).
Field for field the reference's config (``tests/test_torch_lm.py``
checks it).
"""
from repro_torch.configs.registry import ArchDef, LM_SHAPES, register
from repro_torch.core.types import ElasticSpace
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

ELASTIC = ElasticSpace(
    ffn_mults=(0.5, 0.75, 1.0),
    heads_mults=(0.5, 0.75, 1.0),
    depth_mults=(0.5, 0.75, 1.0),
    expert_counts=(32, 48, 64),
    top_ks=(2, 4, 6),
)


def make_config() -> LMConfig:
    return LMConfig(
        name="deepseek-moe-16b",
        n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
        d_ff=1408, vocab_size=102400,
        moe=MoEConfig(n_experts=64, top_k=6, d_ff=1408, n_shared=2,
                      capacity_factor=1.25, group_size=256),
        first_k_dense=1, d_ff_dense=10944,
        attn_impl="blocked_causal", block_q=512, block_kv=512,
        remat="dots_nb", param_dtype="float32", compute_dtype="bfloat16",
        elastic=ELASTIC,
    )


def make_smoke() -> LMConfig:
    return LMConfig(
        name="deepseek-moe-smoke",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
        d_ff=32, vocab_size=512,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=32, n_shared=2,
                      capacity_factor=2.0, group_size=32),
        first_k_dense=1, d_ff_dense=128,
        attn_impl="ref", param_dtype="float32", compute_dtype="float32",
        elastic=ElasticSpace(ffn_mults=(0.5, 1.0), heads_mults=(0.5, 1.0),
                             depth_mults=(0.5, 1.0), expert_counts=(4, 8),
                             top_ks=(1, 2)),
    )


register(ArchDef(
    arch_id="deepseek-moe-16b", family="lm",
    make_config=make_config, make_smoke=make_smoke,
    shapes=LM_SHAPES, optimizer="adamw",
    source="arXiv:2401.06066 (hf tier)",
))
