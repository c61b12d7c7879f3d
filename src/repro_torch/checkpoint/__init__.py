"""Atomic checkpoints of a training state (``manager.CheckpointManager``)."""
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
