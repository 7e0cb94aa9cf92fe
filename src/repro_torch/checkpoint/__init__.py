"""Atomic, checksummed checkpoints of the port (``checkpoint.manager``)."""
from repro_torch.checkpoint.manager import (CheckpointManager,
                                            CorruptCheckpointError,
                                            load_pytree, save_pytree)

__all__ = ["CheckpointManager", "CorruptCheckpointError", "load_pytree",
           "save_pytree"]
