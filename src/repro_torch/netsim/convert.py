"""Carry simulator state between the JAX package and the port.

The port's counterpart of carrying weights across: a JAX ``SimState`` or
``Program`` — handed over as numpy arrays, so the port never imports JAX —
becomes the port's tensors, and a run stopped mid-flight on one side
continues on the other.  The leaves come in the order
``jax.tree_util.tree_leaves`` flattens the reference's NamedTuples
(:data:`repro_torch.netsim.sim.STATE_LEAVES`; ``[buf, length]`` for a
program), either one lane (the reference's own shapes) or a stacked batch
with a leading lane axis (what ``jax.vmap`` produces).  Booleans stay
booleans; every other leaf is int32.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from repro_torch.kernels.backend import resolve_device
from repro_torch.netsim.sim import (BOOL_LEAVES, STATE_LEAVES, Program,
                                    SimState, flatten_state, unflatten_state)

__all__ = ["state_from_jax", "program_from_jax", "state_to_numpy"]

_CYCLE = STATE_LEAVES.index("cycle")


def _lanes_first(arrays: Sequence[np.ndarray], batched: bool) -> List[np.ndarray]:
    return [np.asarray(a) if batched else np.asarray(a)[None] for a in arrays]


def state_from_jax(leaves: Sequence[np.ndarray], device=None) -> SimState:
    """The port's :class:`SimState` from the reference's state leaves
    (one lane, or a batch with a leading lane axis)."""
    if len(leaves) != len(STATE_LEAVES):
        raise ValueError(f"expected {len(STATE_LEAVES)} SimState leaves in "
                         f"tree_leaves order, got {len(leaves)}")
    device = resolve_device(device)
    batched = np.ndim(leaves[_CYCLE]) == 1
    out = []
    for name, a in zip(STATE_LEAVES, _lanes_first(leaves, batched)):
        dtype = np.bool_ if name in BOOL_LEAVES else np.int32
        if name in BOOL_LEAVES and a.dtype != np.bool_:
            raise ValueError(f"leaf {name} must be boolean, got {a.dtype}")
        out.append(torch.as_tensor(np.ascontiguousarray(a.astype(dtype)),
                                   device=device))
    return unflatten_state(out)


def program_from_jax(leaves: Sequence[np.ndarray], device=None) -> Program:
    """The port's :class:`Program` from the reference's ``[buf, length]``
    (one program, or a batch with a leading lane axis)."""
    buf, length = leaves
    device = resolve_device(device)
    batched = np.ndim(buf) == 5
    buf, length = _lanes_first([buf, length], batched)
    return Program(
        buf=torch.as_tensor(np.ascontiguousarray(buf.astype(np.int32)),
                            device=device),
        length=torch.as_tensor(np.ascontiguousarray(length.astype(np.int32)),
                               device=device))


def state_to_numpy(st: SimState) -> List[np.ndarray]:
    """The leaves of ``st`` as numpy arrays in :data:`STATE_LEAVES` order,
    lane axis first (``out[k][b]`` is lane ``b`` of leaf ``k``, shaped as
    the reference's leaf)."""
    return [t.detach().cpu().numpy() for t in flatten_state(st)]
