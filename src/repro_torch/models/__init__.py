"""Models of the port (elastic-aware, the paper's dynamic-DNN knobs).

transformer — decoder LMs: dense + MoE, GQA/MQA, a loop over layers
moe         — top-k routing: dense oracle / packed per-expert dispatch
vit         — ViT / DeiT (distill token, early-exit heads)
resnet / efficientnet — slimmable convnets with switchable BN
diffusion   — DDPM schedule and loss, the DDIM sampler
dit / unet  — the diffusion denoisers (DiT-L/2, the SDXL UNet)
"""
from repro_torch.models.dit import DiTConfig, dit_apply, dit_init
from repro_torch.models.efficientnet import (EffNetConfig, effnet_apply,
                                             effnet_init)
from repro_torch.models.resnet import ResNetConfig, resnet_apply, resnet_init
from repro_torch.models.transformer import LMConfig, lm_apply, lm_init
from repro_torch.models.unet import UNetConfig, unet_apply, unet_init
from repro_torch.models.vit import ViTConfig, vit_apply, vit_init

__all__ = ["EffNetConfig", "effnet_apply", "effnet_init", "ResNetConfig",
           "resnet_apply", "resnet_init", "LMConfig", "lm_apply", "lm_init",
           "ViTConfig", "vit_apply", "vit_init", "DiTConfig", "dit_apply",
           "dit_init", "UNetConfig", "unet_apply", "unet_init"]
