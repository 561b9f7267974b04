"""Records of the model kernels' calls, for the costing tools.

While :func:`recording` is active, each model kernel's wrapper
(``flash_attention``, ``ssd_scan``, ``grouped_matmul``) appends one
record per call it makes on a ``meta`` tensor (the dry run: nothing
runs) or on a CPU tensor (the plain version runs; the record says what
the card would launch): the kernel, the variant its chooser picks, the
operands' shapes, the dtype and the ``(bytes, FLOPs)`` of its
``*_bound``.  A call on a CUDA tensor records nothing: it launches and
counts on its wrapper's ``launches``.  The records give every kernel's
work from its shapes, whoever implements it.

A wrapper asks :func:`active` first and builds no record (its variant,
its bound) when no recorder is open, as in every serve or train call
outside the costing tools.  While a wrapper computes its call, it marks
the work as its own with :func:`repro_torch.own_work.inside`.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence, Tuple

import torch

__all__ = ["recording", "record", "active", "Record"]

Record = Dict[str, object]

_RECORDERS: List[List[Record]] = []


@contextlib.contextmanager
def recording():
    """Collect the kernel records of the calls made within the block into
    the list this yields (nested recorders each get every record)."""
    out: List[Record] = []
    _RECORDERS.append(out)
    try:
        yield out
    finally:
        _RECORDERS.remove(out)


def active() -> bool:
    """Whether a recorder is open (a wrapper builds its record only then)."""
    return bool(_RECORDERS)


def record(kernel: str, variant: str, operands: Sequence[torch.Tensor],
           bound: Tuple[int, int], **extra) -> None:
    """Append one call of ``kernel`` to every active recorder."""
    if not _RECORDERS:
        return
    rec = {"kernel": kernel, "variant": variant,
           "shapes": tuple(tuple(t.shape) for t in operands),
           "dtype": str(operands[0].dtype).replace("torch.", ""),
           "bytes": int(bound[0]), "flops": int(bound[1]), **extra}
    for out in _RECORDERS:
        out.append(rec)
