"""Parameters for the port's models: conversion from the JAX package's
parameter dictionaries, and random initialisation on the card.

Both return a ``state_dict`` keyed by the reference's names, for the
model class of the config's family (``get_model(cfg)``, whose
``param_table``, ``param_dtype`` and ``init_rule`` they follow); the
arrays come in as numpy, so nothing here imports JAX.

On a mesh (every family), :func:`shard_params` cuts a rank's blocks out
of full parameters (under FSDP its banks), :func:`gather_params` joins
them back (collective), :func:`opt_state_from_jax` carries the
reference's ``optim.init`` state (numpy ``master``, ``m``, ``v``,
``step``) into a rank's ZeRO-1 banks, and :func:`gather_opt_state` joins
banks back to full arrays (collective; for tests and the smoke).
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.parallel.sharding import block_of, cut_block, join_blocks
from .api import get_model
from .layers import init_dense

__all__ = ["params_from_jax", "init_params", "shard_params",
           "gather_params", "opt_state_from_jax", "gather_opt_state",
           "state_layout"]


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
    ``rules``: the shapes of the family's ``shard_table``."""
    return {name: cut_block(params[name], spec, rules)
            for name, spec in get_model(cfg).param_specs(cfg, rules).items()}


def gather_params(cfg: ModelConfig, shards: Dict[str, torch.Tensor],
                  rules) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`shard_params`: every rank's blocks joined to
    the full parameters (collective: every rank calls it; for tests and
    the smoke)."""
    return {name: join_blocks(shards[name], spec, rules)
            for name, spec in get_model(cfg).param_specs(cfg, rules).items()}


def state_layout(cfg: ModelConfig, rules) -> Dict[str, tuple]:
    """Name -> the mesh axes of each dimension of a rank's bank of the
    optimizer state (``optim.state_specs`` of the family's
    ``param_specs``)."""
    from repro_torch.optim import state_specs
    model = get_model(cfg)
    return state_specs(model.param_specs(cfg, rules), model.param_table(cfg),
                       rules)["master"]


def opt_state_from_jax(cfg: ModelConfig, state: Mapping, device=None,
                       rules=None) -> Dict:
    """The reference's optimizer state (``{"master", "m", "v": {name:
    array}, "step"}``, numpy) -> the port's (fp32 leaves, int32 ``step``
    on ``device``); with ``rules``, this rank's banks of it (the layout
    ``optim.init(params, rules=, specs=)`` makes)."""
    device = resolve_device(device)
    layout = None if rules is None else state_layout(cfg, rules)
    out = {"step": torch.tensor(int(np.asarray(state["step"])),
                                dtype=torch.int32, device=device)}
    for part in ("master", "m", "v"):
        out[part] = {}
        for name, a in state[part].items():
            t = torch.tensor(np.asarray(a, np.float32))
            if layout is not None:
                t = cut_block(t, layout[name], rules)
            out[part][name] = t.to(device)
    return out


def gather_opt_state(cfg: ModelConfig, state: Dict, rules) -> Dict:
    """Every rank's banks of ``state`` joined to full tensors (collective:
    every rank calls it)."""
    layout = state_layout(cfg, rules)
    out = {"step": state["step"].clone()}
    for part in ("master", "m", "v"):
        out[part] = {k: join_blocks(v, layout[k], rules)
                     for k, v in state[part].items()}
    return out


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
        specs = model.param_specs(cfg, rules)
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
        elif specs is not None:
            out[name] = init_dense(shape, dtype, generator, device,
                                   where=_block(shape, specs[name], rules))
            continue
        else:
            out[name] = init_dense(shape, dtype, generator, device)
        if specs is not None:
            out[name] = cut_block(out[name], specs[name], rules)
    return out


def _block(shape, spec, rules):
    """This rank's slice of every dimension of a tensor of ``shape`` laid
    out by ``spec``."""
    spec = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    return block_of(rules.mesh, spec, tuple(
        n // rules.axis_size(a) for n, a in zip(shape, spec)))[1]
