"""Parameters for the port's models: conversion from the JAX package's
parameter dictionaries, and random initialisation on the card.

Both return a ``state_dict`` keyed by the reference's names, for the
model class of the config's family (``get_model(cfg)``, whose
``param_table``, ``param_dtype`` and ``init_rule`` they follow); the
arrays come in as numpy, so nothing here imports JAX.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.backend import resolve_device
from .api import get_model
from .layers import init_dense

__all__ = ["params_from_jax", "init_params", "shard_params"]


def params_from_jax(cfg: ModelConfig, params: Mapping[str, np.ndarray],
                    device=None) -> Dict[str, torch.Tensor]:
    """``{name: array}`` of the reference (names, shapes, dtypes as the
    ``init_params`` of the config's family makes them) -> a state dict.
    Arrays of any float dtype (bf16 arrays included, which numpy holds as
    an extension dtype) are read through float32, which holds bf16 and
    fp32 values exactly, and cast to the port's dtype for that name."""
    model = get_model(cfg)
    table = model.param_table(cfg)
    if set(params) != set(table):
        raise KeyError(f"parameter names differ: missing "
                       f"{sorted(set(table) - set(params))}, unexpected "
                       f"{sorted(set(params) - set(table))}")
    device = resolve_device(device)
    out = {}
    for name, shape in table.items():
        a = np.asarray(params[name])
        if a.shape != shape:
            raise ValueError(f"{name}: shape {a.shape}, expected {shape}")
        out[name] = torch.tensor(np.asarray(a, np.float32)).to(
            device=device, dtype=model.param_dtype(cfg, name))
    return out


def shard_params(cfg: ModelConfig, params: Dict[str, torch.Tensor],
                 rules) -> Dict[str, torch.Tensor]:
    """This rank's blocks of full parameters (a state dict from
    :func:`params_from_jax` or :func:`init_params`) under sharding
    ``rules``: the shapes of the family's ``shard_table``
    (``transformer.shard_params``; the families without SPMD islands
    refuse rules)."""
    get_model(cfg).shard_table(cfg, rules)
    from .transformer import shard_params as cut
    return cut(cfg, params, rules)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None, rules=None) -> Dict[str, torch.Tensor]:
    """Random parameters by the reference's rules for the config's family
    (``init_rule``: ``ones``, ``zeros``, ``A_log`` the log of
    ``linspace(1, 16)`` over the heads, ``dense`` truncated-normal fan-in),
    in the dtypes of ``param_dtype`` (the router and the SSM's ``A_log``
    and ``dt_bias`` in fp32).  Drawn from ``generator`` (which must live
    on ``device``) in sorted name order; the reference's JAX keys give
    other numbers.  With sharding ``rules``, each tensor is cut to this
    rank's block as soon as it is drawn (the same numbers as
    :func:`shard_params` of the full draw, without holding the whole)."""
    model = get_model(cfg)
    device = resolve_device(device)
    specs = None
    if rules is not None:
        model.shard_table(cfg, rules)     # families without islands refuse
        from .transformer import _cut, param_specs
        specs = param_specs(cfg, rules)
    out = {}
    for name, shape in sorted(model.param_table(cfg).items()):
        dtype = model.param_dtype(cfg, name)
        rule = model.init_rule(name)
        if rule == "ones":
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        elif rule == "zeros":
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
        elif rule == "A_log":
            a = torch.log(torch.linspace(1.0, 16.0, shape[-1],
                                         dtype=torch.float32, device=device))
            out[name] = a.expand(shape).to(dtype).contiguous()
        else:
            out[name] = init_dense(shape, dtype, generator, device)
        if specs is not None:
            out[name] = _cut(out[name], specs[name], rules)
    return out
