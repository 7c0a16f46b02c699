"""Distributed checkpoints of the port (mirror of
``paddle_tpu/distributed/checkpoint``): the atomic, manifest-committed
saver, the verified loader with reshard-on-load, and the retention
manager."""

from .save_state_dict import save_state_dict, wait_save
from .load_state_dict import (CheckpointCorruptError, load_state_dict,
                              read_manifest, restore_arrays, restore_to_mesh,
                              verify_restored)
from .manager import CheckpointManager

__all__ = ["CheckpointCorruptError", "CheckpointManager", "load_state_dict",
           "read_manifest", "restore_arrays", "restore_to_mesh",
           "save_state_dict", "verify_restored", "wait_save"]
