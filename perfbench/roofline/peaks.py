"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), dense rates
without sparsity, at its 700 W power limit (NVIDIA's data sheet)."""

BF16_FLOPS = 989e12        # FLOP/s on the tensor cores, bf16 and fp16
HBM_BYTES = 3.35e12        # bytes/s


def least_time(flops: float, nbytes: float) -> float:
    """The least time the chip could take for ``flops`` operations and
    ``nbytes`` bytes: the larger of the two bounds, in seconds."""
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES)
