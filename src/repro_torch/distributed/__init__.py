"""Distribution substrate: mesh context, rank bring-up, collectives,
sharding rules, the sharded decode, and the launchers' fault tolerance."""
from repro_torch.distributed.ctx import (batch_axes, current_mesh, use_mesh,
                                         wsc)
