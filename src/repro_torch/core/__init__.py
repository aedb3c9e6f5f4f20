"""Elastic (dynamic) networks: sub-network types, the mask/slice duality,
the main-path layers and Pareto operating points."""
from repro_torch.core.types import SubnetSpec, ElasticSpace, FULL
from repro_torch.core.elastic import (active_mask, mask_dim, take_dim,
                                      spec_to_dynamic, spec_to_static)
