"""Checkpoints: atomic manifest-based save / restore, the reference's
on-disk format."""
from repro_torch.checkpoint.manifest import (
    all_steps, latest_step, restore_checkpoint, save_checkpoint)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "all_steps"]
