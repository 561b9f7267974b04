"""What the model kernels' wrappers share: binding a library of
``csrc/``, checking operands, the current stream, and raising on a failed
launch.  Nothing here builds or loads anything when it is imported."""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import build

__all__ = ["DTYPE_CODE", "bind", "check_operand", "launch"]

# the kernels' dtype argument (csrc/*.cu: 0 = float32, 1 = bfloat16)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_CTYPES = {"p": _P, "i": _I, "f": _F}


def bind(name: str, signature: str) -> ctypes.CDLL:
    """Load ``csrc/<name>.cu`` (built at first use) and declare
    ``<name>_launch`` (argument kinds in ``signature``: ``p`` pointer or
    stream, ``i`` int, ``f`` float; returns an int error code) and
    ``<name>_error_string``."""
    lib = build.load(name)
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = [_CTYPES[c] for c in signature]
    fn.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def check_operand(kernel: str, what: str, t: torch.Tensor,
                  device: torch.device, dtypes: Sequence[torch.dtype],
                  shape: Sequence[int]) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``shape`` with one of
    ``dtypes`` on ``device``."""
    if t.device != device or t.dtype not in dtypes \
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{kernel}: {what} must be a contiguous "
            f"{'/'.join(str(d) for d in dtypes)} tensor of shape "
            f"{tuple(shape)} on {device}; got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous={t.is_contiguous()})")


def launch(lib: ctypes.CDLL, name: str, device: torch.device, *args) -> None:
    """Call ``<name>_launch(*args, stream)`` on the current stream of
    ``device``; raise if it reports an error."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, f"{name}_launch")(*args, _P(stream))
    if err:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")
