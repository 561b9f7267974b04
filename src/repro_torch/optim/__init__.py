"""The optimizer of the port: AdamW with an fp32 master copy, updated in
place, on one card or on a mesh with its state banked over ``zero1``
(ZeRO-1), and the cross-pod gradient compression with error feedback
(:mod:`.compress`) (counterpart of ``repro.optim``)."""
from .adamw import (Bank, OptConfig, apply, banks, clip_by_global_norm,
                    init, no_decay, schedule, state_shapes, state_specs)
from .compress import (compress_decompress, cross_pod_psum, dequantize_int8,
                       init_error_state, quantize_int8)

__all__ = ["OptConfig", "apply", "clip_by_global_norm", "init", "no_decay",
           "schedule", "state_shapes", "state_specs", "Bank", "banks",
           "compress_decompress", "cross_pod_psum", "dequantize_int8",
           "init_error_state", "quantize_int8"]
