"""Checkpoint/restart over numpy ``.npz`` (port of ``repro.checkpoint``)."""
from .checkpoint import (AsyncCheckpointer, CheckpointCorruptError,
                         all_steps, latest_step, load_meta,
                         reshard_restore, restore_checkpoint,
                         save_checkpoint, verify_checkpoint)

__all__ = ["AsyncCheckpointer", "CheckpointCorruptError", "all_steps",
           "latest_step", "load_meta", "reshard_restore",
           "restore_checkpoint", "save_checkpoint", "verify_checkpoint"]
