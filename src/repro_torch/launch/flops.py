"""Analytic model FLOPs of the LM (the 'useful compute' yardstick).

Counterpart of the reference ``launch/flops.py:lm_param_counts`` and
``lm_model_flops``:

  LM prefill  : 2·N_active·T + (4·H·Dh)·S·T·L / 2
  LM decode   : 2·N_active·B + 4·B·L·H·Dh·S_cache

N_active counts MoE experts at top_k (+shared) of n_experts.  The
elastic launcher's "rel flops" column and ``chip_smoke.py``'s
model-FLOPs bound of each prefill use them.  The training count comes
with LM training (ROADMAP item 15 (c)).
"""
from __future__ import annotations


def lm_param_counts(cfg) -> dict:
    d, H, K, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    attn = d * H * Dh + 2 * d * K * Dh + H * Dh * d

    def ffn(f, gated):
        return (3 if gated else 2) * d * f

    if cfg.moe:
        E, k, ns, fe = (cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.n_shared,
                        cfg.moe.d_ff)
        per_expert = 3 * d * fe
        moe_act = d * E + (k + ns) * per_expert
        moe_tot = d * E + (E + ns) * per_expert
        fd = cfg.d_ff_dense or cfg.d_ff
        dense = cfg.n_dense_layers * (attn + ffn(fd, cfg.gated_mlp))
        n_body_act = cfg.n_moe_layers * (attn + moe_act) + dense
        n_body_tot = cfg.n_moe_layers * (attn + moe_tot) + dense
    else:
        per = attn + ffn(cfg.d_ff, cfg.gated_mlp)
        n_body_act = n_body_tot = cfg.n_layers * per
    unemb = cfg.d_model * cfg.vocab_size
    return {"body_active": n_body_act, "body_total": n_body_tot,
            "unembed": unemb}


def lm_model_flops(cfg, kind: str, B: int, S: int) -> float:
    n = lm_param_counts(cfg)
    N_act = n["body_active"] + n["unembed"]
    L, H, Dh = cfg.n_layers, cfg.n_heads, cfg.d_head
    if kind == "prefill":
        T = B * S
        return 2.0 * N_act * T + (4 * H * Dh) * S * T * L / 2
    if kind == "decode":      # one token against an S-entry cache
        return 2.0 * N_act * B + 4.0 * B * L * H * Dh * S
    raise ValueError(f"lm_model_flops: kind {kind!r} is not 'prefill' or "
                     f"'decode'")
