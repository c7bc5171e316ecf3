"""Checkpoints of the port: npz shards and a JSON manifest, async saves,
restores onto any device (``checkpoint``)."""
from .checkpoint import (  # noqa: F401
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
