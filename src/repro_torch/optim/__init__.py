"""The optimizer of the port: AdamW with an fp32 master copy, updated in
place (counterpart of ``repro.optim``).  The reference's ZeRO-1 state
specs and its cross-pod gradient compression belong to the SPMD training
slice."""
from .adamw import (OptConfig, apply, clip_by_global_norm, init, no_decay,
                    schedule)

__all__ = ["OptConfig", "apply", "clip_by_global_norm", "init", "no_decay",
           "schedule"]
