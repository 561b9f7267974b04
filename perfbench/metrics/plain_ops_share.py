"""plain_ops_share: the device time of the traced cycle spent neither in
the port's hand-written kernels nor in a library GEMM (elementwise work,
reductions, copies, indexing), as a share of all device time."""

PORT_KERNELS = ("flash_wgmma_kernel", "flash_fwd_kernel", "gmm_tma_kernel",
                "gmm_decode_kernel", "gmm_bf16_kernel", "gmm_f32_kernel",
                "ssd_state_", "ssd_pass_", "ssd_out_")
LIBRARY_GEMM = ("gemm", "cutlass", "xmma", "nvjet", "cublas")


def read(ctx):
    if ctx.trace is None or not ctx.trace.device:
        return None
    total = ctx.trace.total_s()
    named = ctx.trace.seconds(PORT_KERNELS + LIBRARY_GEMM)
    return 100.0 * (total - named) / total
