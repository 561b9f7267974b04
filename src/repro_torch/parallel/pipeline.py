"""Pipeline parallelism as a chain of token-queue channels (paper C6; the
port's counterpart of ``repro.parallel.pipeline``).

The paper's Option-2 congestion rule — *"the first node can have an
outstanding message counter that causes it to stall when the number of
outstanding messages equals the size of the second node's input FIFO"* —
is exactly a pipeline schedule: stages are mesh neighbours along one
axis, activations are the forward-path packets (one ``ppermute`` hop, the
``channel_send`` primitive), and the steady-state in-flight microbatch
count equals the channel depth (the BDP credit rule, C3).

:func:`pipeline_apply` is the reference's SPMD rotating-buffer schedule,
run by every rank of the mesh on its own stage: every stage executes its
layers each tick, the bubble ticks included; activations rotate one hop
along ``stage_axis`` a tick (``core.routing.shift``); microbatch ``m`` is
injected at tick ``m`` and its output surfaces at tick ``m + n_stages -
1``.  Autograd through it is the reverse (1B) wave: each hop's backward
is the reversed ``ppermute`` (``parallel.comm``), so the gradients
traverse the reverse path like the paper's response network.

Bubble fraction = (S-1)/(T+S-1), the GPipe bound; the credit counter keeps
in-flight <= depth so no stage's input FIFO can overflow (deadlock-free by
C2's sink argument).

**Every rank builds the same autograd graph.**  A backward ``ppermute``
is a collective: every stage must reach each hop's backward, in the same
order.  So the stage-dependent choices are values, not branches of the
graph: stage 0 takes the microbatch over the received activation with
``torch.where`` (the reference's ``jnp.where``; the other stages take the
received one), and every stage collects its outputs of the emitting
ticks, which the final broadcast masks to the last stage's.  A hop whose
output no later tick reads (the last tick's) gets no gradient on any
rank, so ``ppermute.bwd`` counts ``ticks - 1`` where ``ppermute`` counts
``ticks``.

**The loss convention** (``parallel.comm``: the global loss is the sum of
the ranks' local losses).  The outputs are the last stage's, broadcast
over ``stage_axis`` by a sum, as in the reference; but the backward of
that broadcast hands each rank's cotangent to the last stage alone (the
other stages get zeros), instead of the sum's own transpose, which would
add the stages' cotangents.  So when every rank differentiates the same
loss of its copy of the outputs, as each device does under ``jax.grad``
of the reference's replicated outputs, a stage's weight gradient is the
reference's, not ``n_stages`` times it: the copies, held alike over the
stage group, enter the gradient once per group (the last stage's), the
convention's rule for a value a group holds alike.  Under ``batch_axis``
a stage's gradient is this rank's share (its rows); their sum over
``batch_axis`` is the gradient.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.core.routing import shift
from repro_torch.parallel import comm
from repro_torch.parallel.comm import Axes, Mesh

__all__ = ["pipeline_apply", "stage_params_spec", "bubble_fraction"]


def bubble_fraction(n_micro: int, n_stages: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)


def stage_params_spec(stage_axis: str):
    """Layer-stacked params (S, L/S, ...) are sharded over stages on dim 0
    (the port's spec tuple; the reference's ``P(stage_axis)``)."""
    return (stage_axis,)


class _FromLast(torch.autograd.Function):
    """The last stage's ``outs`` on every stage (a sum over the stage
    group of ``outs`` masked to the last stage's); backward: each rank's
    cotangent to the last stage alone (module docstring)."""

    @staticmethod
    def forward(ctx, outs, mesh, axis, last):
        ctx.last = last
        return comm.all_reduce(outs if last else torch.zeros_like(outs),
                               mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else torch.zeros_like(g)), None, None, None


def pipeline_apply(body: Callable[[Any, torch.Tensor], torch.Tensor],
                   params_stage: Any, x_micro: torch.Tensor, mesh: Mesh,
                   stage_axis: str = "model",
                   batch_axis: Optional[Axes] = None) -> torch.Tensor:
    """Run ``body`` as a pipeline over ``stage_axis``, in every rank.

    body:         (stage_layer_params, activation) -> activation of the
                  same shape; the per-stage compute (its params carry a
                  leading dim of layers-per-stage, looped inside).
    params_stage: this rank's stage's parameters (a tensor or a dict of
                  them, leading dim L / n_stages): block
                  ``mesh.index(stage_axis)`` of the reference's
                  ``params_stacked`` (:func:`stage_params_spec`).
    x_micro:      (n_micro, mb, ...) this rank's microbatched input: its
                  rows over ``batch_axis`` (dim 1), the same on every
                  stage.
    batch_axis:   the axes the rows are laid over (none of them the stage
                  axis); a rank holds its block, so nothing is cut here.

    Returns (n_micro, mb, ...) outputs (what the LAST stage produced), the
    same on every stage of this rank's row.
    """
    if stage_axis in mesh.names(batch_axis):
        raise ValueError(f"batch_axis {batch_axis!r} includes the stage "
                         f"axis {stage_axis!r}")
    n_stages = mesh.axis_size(stage_axis)
    sid = mesh.index(stage_axis)
    n_micro = x_micro.shape[0]
    ticks = n_micro + n_stages - 1
    first = torch.tensor(sid == 0, device=x_micro.device)
    state = torch.zeros_like(x_micro[0])                # stage input buffer
    ys = []
    for t in range(ticks):
        # stage 0 dequeues the next microbatch from the host queue
        state = torch.where(first, x_micro[min(t, n_micro - 1)], state)
        y = body(params_stage, state)
        # the last stage commits its result for microbatch t - (S - 1)
        if t >= n_stages - 1:
            ys.append(y)
        # forward-path hop: one ppermute to the next stage (C6 channel)
        state = shift(y, mesh, stage_axis, +1)
    # broadcast the last stage's outputs to every stage (reverse path is
    # a sink: the sum over the ring is always absorbable, C2)
    return _FromLast.apply(torch.stack(ys), mesh, stage_axis,
                           sid == n_stages - 1)
