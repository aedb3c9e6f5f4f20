"""Architecture configs of the port: the vision transformers it serves."""
from repro_torch.configs.registry import (ArchDef, ShapeSpec, get_arch,
                                          list_archs, load_all)
