"""Device policy for the port: which device an entry point runs on.

Entry points run on the card unless the caller asks for the CPU:

* ``device=None`` means ``"cuda"``.  With no card visible this raises —
  the port never carries on silently on the CPU;
* ``device="cpu"`` runs the plain PyTorch versions of the kernels (the
  tests do this);
* ``device="meta"`` allocates nothing and computes nothing: the costing
  tools' dry run (``repro_torch.launch.costing``) runs a cell on it, each
  kernel wrapper recording its call (``kernels/record.py``).  It is
  never chosen for the caller: only a caller who names it gets it;
* a CUDA device must be a Hopper card (compute capability 9.0): the
  kernels are built for ``sm_90a`` only, so anything else raises here,
  before a state is allocated, instead of failing at the first launch.

This replaces the JAX package's ``kernels/backend.py``, whose policy ran
Pallas kernels in interpret mode off the TPU.  The port has no such mode:
a CUDA tensor reaches its kernel or raises.
"""
from __future__ import annotations

import torch

__all__ = ["HOPPER", "resolve_device", "require_hopper"]

HOPPER = (9, 0)


def require_hopper(device: torch.device) -> None:
    """Raise unless ``device`` is a visible Hopper (sm_90) card."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} was requested but no CUDA device is visible; "
            "pass device='cpu' to run the plain PyTorch path")
    cap = torch.cuda.get_device_capability(device)
    if tuple(cap) != HOPPER:
        raise RuntimeError(
            f"the port's CUDA kernels are built for sm_90a (Hopper, compute "
            f"capability {HOPPER}); {torch.cuda.get_device_name(device)} has "
            f"compute capability {tuple(cap)}")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` -> the card (raising
    when there is none), ``"cpu"`` -> the CPU, ``"cuda[:i]"`` -> that card
    after checking it is a Hopper, with its index (the current device's
    for a bare ``"cuda"``), so it compares equal to a tensor's device;
    ``"meta"`` -> the meta device, only when named."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; the port runs on an H100 unless "
                "the caller passes device='cpu'")
        device = "cuda"
    device = torch.device(device)
    if device.type in ("cpu", "meta"):
        return device
    if device.type != "cuda":
        raise ValueError(
            f"unsupported device {device}: expected 'cuda', 'cpu' or "
            f"'meta'")
    require_hopper(device)
    if device.index is None:     # "cuda" -> "cuda:<current>", as tensors report it
        device = torch.device("cuda", torch.cuda.current_device())
    return device
