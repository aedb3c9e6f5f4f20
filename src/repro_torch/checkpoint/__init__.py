"""Checkpointing of the port's training state."""
from repro_torch.checkpoint.manager import (CheckpointManager,
                                            restore_checkpoint,
                                            save_checkpoint)
