"""Atomic, crc-checked, credit-bounded checkpoints of the port
(counterpart of ``repro.checkpoint``; the same on-disk layout)."""
from .store import (AsyncCheckpointer, latest_step, restore, save,
                    verify_manifest)

__all__ = ["AsyncCheckpointer", "latest_step", "restore", "save",
           "verify_manifest"]
