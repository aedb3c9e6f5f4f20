"""Architecture configs of the port: the vision transformers it serves,
the conv nets it trains and the MoE LM it prefills and decodes."""
from repro_torch.configs.registry import (ArchDef, ShapeSpec, get_arch,
                                          list_archs, load_all)
