"""The parameter holding shared by the port's models.

Every model of the port registers its parameters under the reference's
names (``layers/wq``, ``periods/mamba_in_proj``, ...), one per row of its
family's table, so ``state_dict()`` keys equal the reference's parameter
names and the two packages run on the same weights.

What the families' training shares is here too: the loss
(:meth:`TableModule._loss`, the reference's ``loss_fn`` tail; on a mesh
:meth:`TableModule._mesh_loss`) and the rematerialisation of a layer
(:func:`run_layer`, the reference's ``Rules.remat``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.profiler import record_function
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                     create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.parallel import comm
from .layers import cross_entropy

__all__ = ["TableModule", "run_layer", "dots_policy", "AUX_COEF", "REMAT"]

AUX_COEF = 0.01            # the MoE load-balance loss's weight
REMAT = ("none", "full", "dots")

# The products with no batch dimensions, as the dispatcher sees them: a
# matrix product of 2-D operands (``x @ w`` with x (B, S, D) and w (D, F)
# folds x to 2-D and runs ``mm``).  Every product of the port's layers
# that the reference writes as a ``dot_general`` without batch dimensions
# is written ``x @ w`` and lowers to one of these; every product with
# batch dimensions (an ``einsum`` over heads, chunks or experts) lowers
# to ``bmm``, which is recomputed, as an ``einsum`` with no batch labels
# would be too (it lowers to ``bmm`` with a batch of one), so the port's
# layers write none.
_NO_BATCH_PRODUCTS = frozenset({
    torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
    torch.ops.aten.mv.default, torch.ops.aten.addmv.default,
    torch.ops.aten.dot.default})


def dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """JAX's ``checkpoint_dots_with_no_batch_dims`` as a selective
    checkpoint policy: save the outputs of the products with no batch
    dimensions, recompute everything else."""
    return CheckpointPolicy.MUST_SAVE if op in _NO_BATCH_PRODUCTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(dots_policy)


def run_layer(fn, remat: str, *args):
    """``fn(*args)`` under the reference's ``Rules.remat``, through
    ``torch.utils.checkpoint`` (non-reentrant) for the two policies that
    rematerialise:

    * ``"full"``: the layer keeps only its inputs for the backward, which
      runs its forward again first, as the reference's ``jax.checkpoint``
      does;
    * ``"dots"``: the layer keeps its inputs and the outputs of its
      products with no batch dimensions (:func:`dots_policy`, the
      reference's ``checkpoint_dots_with_no_batch_dims``); the backward
      recomputes everything else from them: the products with batch
      dimensions, the elementwise work, the collectives and the Hopper
      kernels (they launch through ``ctypes``, which the dispatcher never
      sees, so they always rerun, as the reference's Pallas kernels are
      no ``dot_general``).  One difference: the policy keeps every such
      product's output, where JAX's partial evaluation keeps only those
      the backward reads; the recompute stops at the last tensor the
      backward needs, so a product after it (a layer's last, feeding only
      the residual sum) is kept and never read.

    No layer draws random numbers, so the RNG state is not kept.

    On a mesh ``fn`` is a layer's islands, collectives included.  The
    recompute reruns them, and every rank reaches it at the same node of
    the same backward graph, so every rank reruns the same collectives in
    the same order (a layer whose islands differed by rank would hang
    here)."""
    if remat == "none":
        return fn(*args)
    if remat == "full":
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    if remat == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False,
                          context_fn=_dots_context)
    raise ValueError(f"remat must be one of {REMAT}, got {remat!r}")


class _Reported(torch.autograd.Function):
    """The global loss's value with this rank's share's gradient."""

    @staticmethod
    def forward(ctx, local, total):
        return total.clone()

    @staticmethod
    def backward(ctx, g):
        return g, None


class TableModule(nn.Module):
    """An ``nn.Module`` whose parameters are the rows of the family's
    ``param_table`` (name -> shape), in the dtypes of its
    ``param_dtype(cfg, name)``; ``init_rule(name)`` names how the
    reference initialises each (``ones``, ``zeros``, ``A_log``, ``dense``).
    Subclasses set the three as static methods.

    With ``rules`` (``repro_torch.parallel.sharding.Rules``) the module
    holds this rank's block of each parameter, the shapes of
    ``shard_table(cfg, rules)``.

    With ``params`` (a state dict on ``device``, e.g. from
    ``repro_torch.models.convert``) the module holds those tensors
    themselves, without a copy, so several modules can share one set of
    weights, and rejects mismatched names, shapes, dtypes or devices;
    without, it allocates them uninitialised, for ``load_state_dict``.
    The parameters do not require gradients (serving builds no graph);
    training turns them on with ``requires_grad_(True)``, which keeps the
    tensors shared.

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

    @staticmethod
    def shard_table(cfg: ModelConfig, rules) -> Dict[str, Tuple[int, ...]]:
        """Name -> shape of this rank's block of every parameter under
        sharding ``rules``; a family without SPMD islands refuses rules."""
        raise NotImplementedError(
            f"the {cfg.family} family does not run on a mesh yet")

    @staticmethod
    def param_specs(cfg: ModelConfig, rules) -> Dict[str, Tuple]:
        """Name -> the mesh axes of each dimension of this rank's block of
        every parameter under sharding ``rules`` (the layouts a mesh
        training step, its optimizer banks and its checkpoints read); a
        family without SPMD islands refuses rules."""
        raise NotImplementedError(
            f"the {cfg.family} family does not run on a mesh yet")

    def __init__(self, cfg: ModelConfig, device=None,
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 rules=None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.rules = rules
        table = self.param_table(cfg) if rules is None \
            else self.shard_table(cfg, rules)
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

    def _loss(self, logits: torch.Tensor, aux: torch.Tensor,
              batch: Dict[str, torch.Tensor], moe: bool
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The reference's ``loss_fn`` tail: token-mean cross entropy of
        ``batch["labels"]`` (masked by ``batch["mask"]`` when present);
        for the ``moe`` families plus ``AUX_COEF`` times the load-balance
        loss.  Returns (loss, {"ce"[, "moe_aux"]})."""
        with record_function("cross_entropy"):
            ce = cross_entropy(logits, batch["labels"], batch.get("mask"))
        if moe:
            return ce + AUX_COEF * aux, {"ce": ce, "moe_aux": aux}
        return ce, {"ce": ce}

    def _mesh_loss(self, nll_sum: torch.Tensor, count: torch.Tensor,
                   aux: torch.Tensor, rules, moe: bool
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """:meth:`_loss` on a mesh, from this rank's masked cross-entropy
        sum ``nll_sum`` over the tokens it counts and their mask's sum
        ``count`` (each token on exactly one rank) and the MoE aux loss
        ``aux`` (held alike by every rank).  The rank's local loss is
        ``nll_sum`` over the global count (all-reduced) plus ``AUX_COEF``
        times ``aux`` over the world size, so the local losses sum to the
        reference's loss; the reported loss is that sum (all-reduced,
        equal on every rank), carrying the local loss's gradient."""
        mesh = rules.mesh
        everyone = mesh.axis_names
        n = comm.all_reduce(count.detach(), mesh, everyone).clamp_min(1)
        local = nll_sum / n
        ce = comm.all_reduce(local.detach(), mesh, everyone)
        if moe:
            local = local + AUX_COEF * aux / mesh.size
            total = ce + AUX_COEF * aux.detach()
            metrics = {"ce": ce, "moe_aux": aux.detach()}
        else:
            total, metrics = ce, {"ce": ce}
        return _Reported.apply(local, total), metrics

    def _p(self, name: str) -> torch.Tensor:
        return getattr(self, name)

    def _stack(self, prefix: str, names, *index) -> Dict[str, torch.Tensor]:
        """``{name: param(prefix + name)[index]}``: one layer's slice of
        stacked parameters."""
        return {k: self._p(prefix + k)[index] for k in names}
