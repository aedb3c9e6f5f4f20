"""Analytic model FLOPs (the 'useful compute' yardstick).

Counterpart of the reference ``launch/flops.py`` for the families the
port runs:

  LM train    : 6·N_active·T + 3·(4·H·Dh)·S·T·L / 2 (causal attention half)
  LM prefill  : 2·N_active·T + (4·H·Dh)·S·T·L / 2
  LM decode   : 2·N_active·B + 4·B·L·H·Dh·S_cache
  ViT/DiT     : token-matmul params x tokens (+ attention quadratic term)
  CNNs        : conv MAC walk over the stage geometry
  UNet        : conv + transformer walk over the stage geometry

N_active counts MoE experts at top_k (+shared) of n_experts; a training
step counts 3x its forward.  The elastic launcher's "rel flops" column
and ``chip_smoke.py``'s model-FLOPs bound of each prefill and its
model-FLOPs rate of the conv nets', the diffusion nets' and the LM's
training steps use them.
"""
from __future__ import annotations

from repro_torch.configs.registry import vision_family


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
    if kind == "train":
        T = B * S
        return 6.0 * N_act * T + 3.0 * (4 * H * Dh) * S * T * L / 2
    if kind == "prefill":
        T = B * S
        return 2.0 * N_act * T + (4 * H * Dh) * S * T * L / 2
    if kind == "decode":      # one token against an S-entry cache
        return 2.0 * N_act * B + 4.0 * B * L * H * Dh * S
    raise ValueError(f"lm_model_flops: kind {kind!r} is not 'train', "
                     f"'prefill' or 'decode'")


# --- ViT -----------------------------------------------------------------------

def vit_model_flops(cfg, kind: str, B: int, img_res: int) -> float:
    tok = (img_res // cfg.patch) ** 2 + (2 if getattr(cfg, "distill_token",
                                                      False) else 1)
    d, L = cfg.d_model, cfg.n_layers
    per_tok = L * (4 * d * d + 2 * d * cfg.d_ff)       # attn + (plain) mlp
    attn_quad = L * 4 * d * tok                         # per token: 4·d·tok
    patch = cfg.patch * cfg.patch * 3 * d
    fwd = 2.0 * B * tok * (per_tok + patch) + 2.0 * B * tok * attn_quad
    return fwd * (3.0 if kind == "train" else 1.0)


def dit_model_flops(cfg, kind: str, B: int) -> float:
    tok = (cfg.latent_res // cfg.patch) ** 2
    d, L = cfg.d_model, cfg.n_layers
    per_tok = L * (4 * d * d + 2 * d * cfg.d_ff + 6 * d * d)   # + adaLN
    attn_quad = L * 4 * d * tok
    fwd = 2.0 * B * tok * (per_tok + attn_quad / 1.0)
    return fwd * (3.0 if kind == "train" else 1.0)


# --- CNNs ----------------------------------------------------------------------

def resnet_model_flops(cfg, kind: str, B: int, img_res: int) -> float:
    macs = 0.0
    r = img_res // 2                       # stem stride 2
    macs += r * r * 49 * 3 * cfg.width
    r = r // 2                             # maxpool
    c_in = cfg.width
    for s, depth in enumerate(cfg.depths):
        c_out = cfg.stage_channels(s)
        c_mid = c_out // 4
        for b in range(depth):
            stride = 2 if (b == 0 and s > 0) else 1
            r_out = r // stride
            macs += r * r * c_in * c_mid               # 1x1
            macs += r_out * r_out * 9 * c_mid * c_mid  # 3x3 (stride)
            macs += r_out * r_out * c_mid * c_out      # 1x1
            if c_in != c_out:
                macs += r_out * r_out * c_in * c_out
            c_in, r = c_out, r_out
    macs += c_in * cfg.n_classes
    fwd = 2.0 * B * macs
    return fwd * (3.0 if kind == "train" else 1.0)


def effnet_model_flops(cfg, kind: str, B: int, img_res: int) -> float:
    from repro_torch.models.efficientnet import B0_STAGES
    macs = 0.0
    r = img_res // 2
    stem = cfg.round_filters(32)
    macs += r * r * 9 * 3 * stem
    c_in = stem
    for (expand, c, reps, stride, k) in B0_STAGES:
        c_out = cfg.round_filters(c)
        for b in range(cfg.round_repeats(reps)):
            st = stride if b == 0 else 1
            c_mid = c_in * expand
            r_out = r // st
            if expand != 1:
                macs += r * r * c_in * c_mid
            macs += r_out * r_out * k * k * c_mid          # depthwise
            c_se = max(1, int(c_in * 0.25))
            macs += c_mid * c_se * 2                        # SE
            macs += r_out * r_out * c_mid * c_out
            c_in, r = c_out, r_out
    head = cfg.round_filters(1280)
    macs += r * r * c_in * head + head * cfg.n_classes
    fwd = 2.0 * B * macs
    return fwd * (3.0 if kind == "train" else 1.0)


# --- UNet ----------------------------------------------------------------------

def unet_model_flops(cfg, kind: str, B: int, img_res: int) -> float:
    macs = 0.0
    r = img_res // 8
    chs = [cfg.ch * m for m in cfg.ch_mult]
    macs += r * r * 9 * cfg.in_channels * cfg.ch

    def res_macs(r, cin, cout):
        return r * r * (9 * cin * cout + 9 * cout * cout
                        + (cin * cout if cin != cout else 0)) \
            + cfg.temb_dim * cout

    def tblock_macs(r, c, depth):
        tok = r * r
        # self-attn proj + quadratic + cross-attn q/o + geglu mlp (x4, gated)
        per = depth * (4 * c * c + 4 * c * tok + 2 * c * c + 12 * c * c)
        return tok * per + 2 * c * c * tok + 77 * cfg.ctx_dim * 2 * c * depth

    c_prev = cfg.ch
    skips = [cfg.ch]
    for s, c in enumerate(chs):
        for _ in range(cfg.n_res_blocks):
            macs += res_macs(r, c_prev, c)
            c_prev = c
            if cfg.transformer_depth[s]:
                macs += tblock_macs(r, c, cfg.transformer_depth[s])
            skips.append(c)
        if s < len(chs) - 1:
            macs += r * r // 4 * 9 * c * c
            skips.append(c)
            r //= 2
    macs += 2 * res_macs(r, chs[-1], chs[-1])
    macs += tblock_macs(r, chs[-1], cfg.transformer_depth[-1])
    for s in reversed(range(len(chs))):
        c = chs[s]
        for _ in range(cfg.n_res_blocks + 1):
            c_skip = skips.pop()
            macs += res_macs(r, c_prev + c_skip, c)
            c_prev = c
            if cfg.transformer_depth[s]:
                macs += tblock_macs(r, c, cfg.transformer_depth[s])
        if s > 0:
            r *= 2
            macs += r * r * 9 * c * c
    macs += r * r * 9 * cfg.ch * cfg.in_channels
    fwd = 2.0 * B * macs
    return fwd * (3.0 if kind == "train" else 1.0)


# --- dispatch -------------------------------------------------------------------

def model_flops(arch, cfg, shape) -> float:
    """The reference's dispatch by family and shape kind."""
    fam, kind = arch.family, shape.kind
    if fam == "lm":
        return lm_model_flops(cfg, kind, shape.global_batch, shape.seq_len)
    if fam == "diffusion":
        k = "train" if kind == "diff_train" else "gen"
        if arch.arch_id.startswith("dit"):
            return dit_model_flops(cfg, k, shape.global_batch)
        return unet_model_flops(cfg, k, shape.global_batch, shape.img_res)
    k = "train" if kind == "vis_train" else "serve"
    count = {"vit": vit_model_flops, "resnet": resnet_model_flops,
             "effnet": effnet_model_flops}[vision_family(arch.arch_id)]
    return count(cfg, k, shape.global_batch, shape.img_res)
