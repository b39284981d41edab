"""Checkpoints of the training state (port of `repro.checkpoint`)."""
from .checkpoint import latest_step, restore_checkpoint, save_checkpoint

__all__ = ["latest_step", "restore_checkpoint", "save_checkpoint"]
