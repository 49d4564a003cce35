"""Atomic, restartable checkpoints in the reference's on-disk format
(torch port of ``repro.checkpoint``)."""
from repro_torch.checkpoint.checkpointer import (LayoutMismatch, latest_step,
                                                 list_steps, restore,
                                                 restore_latest_valid, save)

__all__ = ["save", "restore", "restore_latest_valid", "latest_step",
           "list_steps", "LayoutMismatch"]
