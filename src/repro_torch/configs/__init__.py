"""Architecture configs of the port, every one of the reference's: the
vision transformers it serves, the conv nets and diffusion nets it trains,
and the LMs it prefills and decodes (deepseek-moe-16b, qwen1.5-110b,
granite-20b and kimi-k2-1t-a32b; deepseek-moe-16b also trains)."""
from repro_torch.configs.registry import (ArchDef, ShapeSpec, get_arch,
                                          list_archs, load_all)
