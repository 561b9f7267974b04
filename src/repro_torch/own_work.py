"""Which aten ops are a kernel call's or a collective's own work.

A kernel wrapper (``kernels/flash_attention.py``, ``kernels/ssd_scan.py``,
``kernels/moe_gmm.py``) and a collective (``parallel/comm.py``) run their
body within :func:`inside`; while it is open, :func:`suppressed` is true,
so a counter of aten ops (``repro_torch.launch.costing``) can tell that
work, which it counts from the kernel's record or the collective's call,
from the code around it.  It is a module of its own so that the kernels
and the collectives both mark their work without importing each other.
"""
from __future__ import annotations

import contextlib

__all__ = ["inside", "suppressed"]

_DEPTH = 0


@contextlib.contextmanager
def inside():
    """Mark the block as a kernel's (or a collective's) own work."""
    global _DEPTH
    _DEPTH += 1
    try:
        yield
    finally:
        _DEPTH -= 1


def suppressed() -> bool:
    """Whether the current op belongs to a kernel call or a collective."""
    return _DEPTH > 0
