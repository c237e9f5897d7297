"""Checkpoints of the port (port of ``repro.checkpoint``): the same files,
so each package restores the other's."""
from .ckpt import (CheckpointManager, latest_step, restore, save, save_async,
                   wait_for_async)

__all__ = ["CheckpointManager", "latest_step", "restore", "save",
           "save_async", "wait_for_async"]
