"""gmm_row_fill: the assignments the MoE kept (``moe.kept``) over the
rows of the capacity buffers the expert FFN's grouped products compute
(``moe.gmm_rows``), the program's counters over the traced cycle
(``repro_torch.obs``).  A row that holds no token is padding the GMM
computes all the same.  None where the program has no such counters."""


def read(ctx):
    if ctx.trace is None:
        return None
    try:
        from repro_torch import obs
    except ImportError:
        return None
    counts = obs.counters()
    if not counts.get("moe.gmm_rows") or "moe.kept" not in counts:
        return None
    return 100.0 * counts["moe.kept"] / counts["moe.gmm_rows"]
