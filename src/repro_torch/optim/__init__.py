"""The optimizer of the port: AdamW with an fp32 master copy, updated in
place, on one card or on a mesh with its state banked over ``zero1``
(ZeRO-1; counterpart of ``repro.optim``).  The reference's cross-pod
gradient compression (``optim/compress.py``) waits for ROADMAP item
13b-2."""
from .adamw import (Bank, OptConfig, apply, banks, clip_by_global_norm,
                    init, no_decay, schedule, state_shapes, state_specs)

__all__ = ["OptConfig", "apply", "clip_by_global_norm", "init", "no_decay",
           "schedule", "state_shapes", "state_specs", "Bank", "banks"]
