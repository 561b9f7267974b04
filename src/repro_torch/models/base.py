"""The parameter holding shared by the port's models.

Every model of the port registers its parameters under the reference's
names (``layers/wq``, ``periods/mamba_in_proj``, ...), one per row of its
family's table, so ``state_dict()`` keys equal the reference's parameter
names and the two packages run on the same weights.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.backend import resolve_device

__all__ = ["TableModule"]


class TableModule(nn.Module):
    """An ``nn.Module`` whose parameters are the rows of the family's
    ``param_table`` (name -> shape), in the dtypes of its
    ``param_dtype(cfg, name)``; ``init_rule(name)`` names how the
    reference initialises each (``ones``, ``zeros``, ``A_log``, ``dense``).
    Subclasses set the three as static methods.

    With ``params`` (a state dict on ``device``, e.g. from
    ``repro_torch.models.convert``) the module holds those tensors
    themselves, without a copy, so several modules can share one set of
    weights, and rejects mismatched names, shapes, dtypes or devices;
    without, it allocates them uninitialised, for ``load_state_dict``.
    Forward only: the parameters do not require gradients.

    A subclass with recurrent decode state names those cache leaves in
    ``RECURRENT_LEAVES`` and their batch dimension in ``CACHE_BATCH_DIM``,
    so :meth:`reset_slot` can start a slot afresh."""

    RECURRENT_LEAVES: Tuple[str, ...] = ()
    CACHE_BATCH_DIM = 0

    @staticmethod
    def param_table(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
        raise NotImplementedError

    @staticmethod
    def param_dtype(cfg: ModelConfig, name: str) -> torch.dtype:
        raise NotImplementedError

    @staticmethod
    def init_rule(name: str) -> str:
        raise NotImplementedError

    def __init__(self, cfg: ModelConfig, device=None,
                 params: Optional[Dict[str, torch.Tensor]] = None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        table = self.param_table(cfg)
        if params is not None and set(params) != set(table):
            raise KeyError(f"parameter names differ from the table: "
                           f"{sorted(set(params) ^ set(table))}")
        for name, shape in table.items():
            dtype = self.param_dtype(cfg, name)
            if params is None:
                data = torch.empty(shape, dtype=dtype, device=self.device)
            else:
                data = params[name]
                if tuple(data.shape) != shape or data.dtype != dtype \
                        or data.device != self.device:
                    raise ValueError(
                        f"{name}: expected {dtype} {shape} on {self.device}, "
                        f"got {data.dtype} {tuple(data.shape)} on "
                        f"{data.device}")
            self.register_parameter(name, nn.Parameter(data,
                                                       requires_grad=False))

    def reset_slot(self, cache: Dict[str, torch.Tensor], s: int) -> None:
        """Start slot ``s`` of ``cache`` afresh, in place: its length 0 and
        its ``RECURRENT_LEAVES`` zeroed.  Stale KV (and a transformer's
        ``pos``) needs no wipe: attention masks by length, and new appends
        overwrite."""
        cache["len"][s] = 0
        idx = (slice(None),) * self.CACHE_BATCH_DIM + (s,)
        for name in self.RECURRENT_LEAVES:
            cache[name][idx] = 0

    def _p(self, name: str) -> torch.Tensor:
        return getattr(self, name)

    def _stack(self, prefix: str, names, *index) -> Dict[str, torch.Tensor]:
        """``{name: param(prefix + name)[index]}``: one layer's slice of
        stacked parameters."""
        return {k: self._p(prefix + k)[index] for k in names}
