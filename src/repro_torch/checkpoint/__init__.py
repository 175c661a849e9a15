"""Checkpointing of trees and of the whole collaborative train state, in
the JAX package's npz format (see :mod:`.checkpoint`)."""

from repro_torch.checkpoint.checkpoint import (
    latest_step,
    restore_checkpoint,
    restore_train_state,
    save_checkpoint,
    save_train_state,
)

__all__ = ["latest_step", "restore_checkpoint", "restore_train_state",
           "save_checkpoint", "save_train_state"]
