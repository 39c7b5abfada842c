"""Sharded checkpoints (port of `repro/checkpoint`), byte-compatible with
the reference's: see io.py."""
from .io import (  # noqa: F401
    CheckpointManager, StoreError, committed_steps, latest_step,
    load_checkpoint, save_checkpoint,
)
