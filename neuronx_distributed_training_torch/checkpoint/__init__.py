"""Checkpoint save/restore on torch.distributed.checkpoint, with integrity
sidecars and verified auto-resume."""

from neuronx_distributed_training_torch.checkpoint.integrity import (  # noqa: F401
    CheckpointIntegrityError,
    IntegrityConfig,
    inject_corruption,
)
from neuronx_distributed_training_torch.checkpoint.manager import (  # noqa: F401
    CheckpointConfig,
    Checkpointer,
    TrainState,
)
