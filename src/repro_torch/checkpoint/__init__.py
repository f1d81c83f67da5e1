"""Checkpointing: npz shards + JSON manifest in the reference's format, async writes."""

from repro_torch.checkpoint.store import (
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = [
    "CheckpointManager",
    "save_checkpoint",
    "restore_checkpoint",
    "latest_step",
]
