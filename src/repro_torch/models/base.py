"""The parameter holding shared by the port's models.

Every model of the port registers its parameters under the reference's
names (``layers/wq``, ``periods/mamba_in_proj``, ...), one per row of its
family's table, so ``state_dict()`` keys equal the reference's parameter
names and the two packages run on the same weights.

What the families' training shares is here too: the loss
(:meth:`TableModule._loss`, the reference's ``loss_fn`` tail; on a mesh
:meth:`TableModule._mesh_loss`) and the rematerialisation of a layer
(:func:`run_layer`, the reference's ``Rules.remat``).

So is what every family shares on a mesh: the parameter layouts (each
family's ``param_labels`` resolved by :func:`resolve_axis`, the
reference's ``param_specs``; :meth:`TableModule.layout_specs`,
:meth:`~TableModule.param_specs`, :meth:`~TableModule.shard_table`), the
FSDP banks (:meth:`TableModule._use`, :meth:`TableModule._stack`), the
vocab-sharded embedding and LM head (:meth:`TableModule._embed`,
:meth:`TableModule._logits`), the vocab-parallel cross entropy
(:meth:`TableModule._spmd_ce`) and Megatron sequence parallelism's
gather and return (:func:`seq_gather`, :func:`seq_return`).
"""
from __future__ import annotations

import contextlib
import functools
from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                     create_selective_checkpoint_contexts)

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.parallel import comm
from repro_torch.parallel.sharding import (Layout, Rules, entry_index,
                                           entry_names, join_blocks,
                                           spec_axes, zero1_spec)
from .layers import cross_entropy, embed_lookup, rms_norm

__all__ = ["TableModule", "run_layer", "dots_policy", "AUX_COEF", "REMAT",
           "resolve_axis", "seq_gather", "seq_return", "whole",
           "stack_specs"]

F32 = torch.float32

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

# ---------------------------------------------------------------------------
# on a mesh: the parameter layouts and the sequence-parallel helpers
# ---------------------------------------------------------------------------

def resolve_axis(cfg: ModelConfig, rules: Rules, label, size: int):
    """The mesh axes a dimension labelled ``label`` of ``size`` is laid
    over (the reference's ``transformer._resolve_axis``, which Jamba and
    Whisper use, and ``mamba2._resolve``; divisibility is checked on the
    flat weight dimension, and a dimension that does not divide stays
    whole).  Expert weights are sharded over ``experts`` (EP) where E
    divides it, else their FFN width over ``ff``.  One difference: under
    ``dispatch="local"`` they are held FFN-sharded, as ``_moe_local``
    reads them, where the reference's table shards them over experts and
    GSPMD reshards them inside every layer."""
    if label is None:
        return None
    if label in ("heads", "kv_heads"):
        return rules.dim_axis(rules.heads, size)
    if label in ("vocab", "ff"):
        return rules.dim_axis(getattr(rules, label), size)
    ep = rules.axis_size(rules.experts)
    use_ep = cfg.moe is not None and ep > 1 and \
        cfg.moe.num_experts % ep == 0 and rules.dispatch not in ("tp",
                                                                 "local")
    if label == "experts":
        return rules._clean(rules.experts) if use_ep else None
    if label == "ff_expert":
        return None if use_ep else rules.dim_axis(rules.ff, size)
    raise KeyError(label)


def stack_specs(specs: Dict[str, Tuple], prefix: str, names,
                stacked: int = 1) -> Dict[str, Tuple]:
    """{name: the spec of one slice of ``prefix + name``}: the ``stacked``
    leading (layer) dimensions dropped."""
    return {k: specs[prefix + k][stacked:] for k in names}


def whole(lp: Dict[str, torch.Tensor], lspecs: Dict[str, Tuple], names,
          rules: Rules) -> Dict[str, torch.Tensor]:
    """The named slices of ``lp`` with their blocks gathered over the axes
    of ``lspecs`` (collective; the backward reduce-scatters)."""
    return {k: join_blocks(lp[k], lspecs[k], rules) for k in names
            if k in lp}


def seq_gather(h: torch.Tensor, rules: Rules, lay: Layout) -> torch.Tensor:
    """This rank's sequence block (b, s, ...) all-gathered over ``model``
    to the whole sequence where the layout shards it."""
    return comm.all_gather(h, rules.mesh, "model", 1) if lay.seq else h


def seq_return(out: torch.Tensor, rules: Rules, lay: Layout):
    """A partial (b, S, D) sum over ``model`` back to this rank's block:
    reduce-scattered over the sequence, or summed."""
    if lay.seq:
        return comm.reduce_scatter(out, rules.mesh, "model", 1)
    return comm.all_reduce(out, rules.mesh, "model")


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
    reference initialises each (``ones``, ``zeros``, ``A_log``, ``dense``)
    and ``param_labels`` the logical axis of each dimension (the
    reference table's labels).  Subclasses set the four as static
    methods.

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
    STACKED: Tuple[str, ...] = ()

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
    def param_labels(cfg: ModelConfig) -> Dict[str, Tuple]:
        raise NotImplementedError

    @classmethod
    def layout_specs(cls, cfg: ModelConfig, rules: Rules
                     ) -> Dict[str, Tuple]:
        """Name -> the mesh axes of each dimension (None: whole on every
        rank) as the islands read the parameters: the reference's
        ``param_specs``."""
        labels = cls.param_labels(cfg)
        return {name: tuple(resolve_axis(cfg, rules, a, shape[d])
                            for d, a in enumerate(labels[name]))
                for name, shape in cls.param_table(cfg).items()}

    @classmethod
    def param_specs(cls, cfg: ModelConfig, rules: Rules) -> Dict[str, Tuple]:
        """Name -> the mesh axes of each dimension of the blocks a rank
        holds (the layouts a mesh training step, its optimizer banks and
        its checkpoints read): :meth:`layout_specs`, and under
        ``rules.fsdp`` each banked over ``zero1`` as the reference's
        ``build_cell`` banks a training cell's parameters
        (``parallel.sharding.zero1_spec``; ZeRO-3).  The islands
        all-gather a banked weight over ``zero1`` before they use it
        (:meth:`_use`, :meth:`_stack`)."""
        specs = cls.layout_specs(cfg, rules)
        if not rules.fsdp:
            return specs
        table = cls.param_table(cfg)
        return {k: zero1_spec(v, table[k], rules) for k, v in specs.items()}

    @classmethod
    def shard_table(cls, cfg: ModelConfig, rules: Rules
                    ) -> Dict[str, Tuple[int, ...]]:
        """Name -> the shape of this rank's block of every parameter under
        sharding ``rules``."""
        table = cls.param_table(cfg)
        return {name: tuple(n // rules.axis_size(a)
                            for n, a in zip(table[name], axes))
                for name, axes in cls.param_specs(cfg, rules).items()}

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

    def _rules(self, rules: Optional[Rules]) -> Optional[Rules]:
        """The rules of a call: ``rules``, else the model's own.  Rules
        that lay the parameters out otherwise than the model holds them
        are refused."""
        if rules is None or rules is self.rules:
            return self.rules
        held = self.param_table(self.cfg) if self.rules is None \
            else self.shard_table(self.cfg, self.rules)
        if self.shard_table(self.cfg, rules) != held:
            raise ValueError("these rules shard the parameters otherwise "
                             "than the model holds them")
        return rules

    # -- decode caches -------------------------------------------------------
    def _cache_batch(self, batch: int) -> int:
        """The rows of a decode cache of ``batch`` this rank holds: all of
        them on one card; on a mesh its block over ``rules.batch`` (where
        the batch divides), remembered for :meth:`reset_slot`."""
        if self.rules is None:
            return batch
        lay = Layout(self.rules.dim_axis(self.rules.batch, batch), False)
        self._cache_rows = lay.rows(self.rules, batch)
        return len(range(batch)[self._cache_rows])

    def reset_slot(self, cache: Dict[str, torch.Tensor], s: int) -> None:
        """Start slot ``s`` (a global row) of ``cache`` afresh, in place:
        its length 0 and its ``RECURRENT_LEAVES`` zeroed.  Stale KV (and a
        transformer's ``pos``) needs no wipe: attention masks by length,
        and new appends overwrite.  On a mesh only the ranks holding that
        row of the cache of the last ``init_cache`` touch it."""
        if self.rules is not None:
            rows = self._cache_rows
            if not rows.start <= s < rows.stop:
                return
            s -= rows.start
        cache["len"][s] = 0
        idx = (slice(None),) * self.CACHE_BATCH_DIM + (s,)
        for name in self.RECURRENT_LEAVES:
            cache[name][idx] = 0

    # -- the loss ------------------------------------------------------------
    def _loss(self, logits: torch.Tensor, aux: torch.Tensor,
              batch: Dict[str, torch.Tensor], moe: bool
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The reference's ``loss_fn`` tail: token-mean cross entropy of
        ``batch["labels"]`` (masked by ``batch["mask"]`` when present);
        for the ``moe`` families plus ``AUX_COEF`` times the load-balance
        loss.  Returns (loss, {"ce"[, "moe_aux"]})."""
        with obs.span("cross_entropy"):
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

    # -- parameters and FSDP banks -----------------------------------------
    def _p(self, name: str) -> torch.Tensor:
        return getattr(self, name)

    @functools.cached_property
    def _banked(self) -> Dict[str, Tuple[int, Tuple[str, ...]]]:
        """Under FSDP, name -> (the dimension banked over ``zero1``, the
        ``zero1`` axes) of each parameter held as a bank."""
        if self.rules is None or not self.rules.fsdp:
            return {}
        held = self.param_specs(self.cfg, self.rules)
        out = {}
        for k, spec in self.layout_specs(self.cfg, self.rules).items():
            for d, (a, b) in enumerate(zip(held[k], spec)):
                if a != b:
                    out[k] = (d, entry_names(a)[len(entry_names(b)):])
        return out

    def _gather_bank(self, name: str, t: torch.Tensor, dim: int
                     ) -> torch.Tensor:
        """``t`` (a bank, or a slice of one whose banked dimension is now
        ``dim``) all-gathered over ``zero1`` (autograd: the backward
        reduce-scatters the gradient into the bank)."""
        for a in reversed(self._banked[name][1]):
            t = comm.all_gather(t, self.rules.mesh, a, dim)
        return t

    def _use(self, name: str) -> torch.Tensor:
        """Parameter ``name`` as the islands read it: this rank's block,
        a bank all-gathered first under FSDP."""
        t = self._p(name)
        if name in self._banked:
            t = self._gather_bank(name, t, self._banked[name][0])
        return t

    @contextlib.contextmanager
    def layer_views(self):
        """Within the block (with gradients enabled), :meth:`_stack` takes
        the layer slices of every stacked parameter (a name under one of
        the class's ``STACKED`` prefixes, held whole) from one ``unbind``
        of it, made here, before any layer runs.  Indexing each layer
        apart makes the backward materialise the whole stacked gradient
        for every layer (``select``'s backward) and sum them: bytes and
        memory quadratic in depth.  ``unbind``'s backward stacks the
        layers' gradients once.  The values and gradients are the same.
        The block must hold the backward too: a rematerialised layer then
        takes its slices the same way again (``train_step`` holds both)."""
        if not torch.is_grad_enabled() or \
                self.__dict__.get("_views") is not None:
            yield
            return
        self._views = {
            name: p.unbind(0) for name, p in self.named_parameters()
            if name.startswith(self.STACKED) and name not in self._banked}
        try:
            yield
        finally:
            self._views = None

    def _slice(self, name: str, index) -> torch.Tensor:
        """``param(name)[index]``, from its ``unbind`` within
        :meth:`layer_views`."""
        views = self.__dict__.get("_views")
        if not views or name not in views:
            return self._p(name)[index]
        part = views[name][index[0]]
        return part[index[1:]] if len(index) > 1 else part

    def _stack(self, prefix: str, names, *index) -> Dict[str, torch.Tensor]:
        """``{name: param(prefix + name)[index]}``: one layer's slice of
        stacked parameters, as the islands read it (a bank gathered
        under FSDP: the slice's own bank, or the whole bank where it is
        banked over a stacked dimension)."""
        out = {}
        for k in names:
            name = prefix + k
            bank = self._banked.get(name)
            if bank is None:
                out[k] = self._slice(name, index)
            elif bank[0] < len(index):
                out[k] = self._use(name)[index]
            else:
                out[k] = self._gather_bank(name, self._slice(name, index),
                                           bank[0] - len(index))
        return out

    # -- the vocabulary on a mesh ------------------------------------------
    def _embed(self, tokens: torch.Tensor, rules: Rules, lay: Layout,
               specs) -> torch.Tensor:
        """This rank's block (b, s, D) of the embedding of its rows'
        ``tokens`` (b, S).  A vocab-sharded table: each rank looks up the
        tokens of its block (zeros elsewhere) and the blocks are summed
        (one non-zero term: exact), reduce-scattered straight to the
        sequence block where the sequence is sharded over the same
        axis."""
        table, va = self._use("embed"), specs["embed"][0]
        S = tokens.shape[1]
        if va is None:
            x = embed_lookup(table, tokens)[:, lay.positions(rules, S)]
            return x.to(self.cfg.param_dtype)
        n = table.shape[0]
        local = tokens - entry_index(rules.mesh, va) * n
        ok = (local >= 0) & (local < n)
        x = torch.where(ok[..., None], embed_lookup(table,
                                                    local.clamp(0, n - 1)),
                        0)
        if lay.seq and rules.mesh.names(va) == ("model",):
            x = comm.reduce_scatter(x, rules.mesh, "model", 1)
        else:
            x = comm.all_reduce(x, rules.mesh, va)
            x = x[:, lay.positions(rules, S)]
        return x.to(self.cfg.param_dtype)

    def _spmd_head(self, specs) -> Tuple[torch.Tensor, object]:
        """(this rank's block of the LM head (D, V / n), the axes of its
        vocabulary)."""
        if self.cfg.tie_embeddings:
            return self._use("embed").T, specs["embed"][0]
        return self._use("lm_head"), specs["lm_head"][1]

    def _logits(self, x: torch.Tensor, rules: Rules, lay: Layout,
                specs) -> torch.Tensor:
        """The global logits (B, s, V) of this rank's final hidden rows x
        (b, s, D) (every column holding the same rows): the vocab blocks
        all-gathered, then the batch rows."""
        x = rms_norm(x, self._use("final_norm"), self.cfg.norm_eps)
        head, va = self._spmd_head(specs)
        logits = x @ head
        if va is not None:
            logits = comm.all_gather(logits, rules.mesh, va, logits.dim() - 1)
        if lay.batch is not None:
            logits = comm.all_gather(logits, rules.mesh, lay.batch, 0)
        return logits

    def _spmd_out(self, x: torch.Tensor, last_only: bool, rules: Rules,
                  lay: Layout, specs) -> torch.Tensor:
        """The global logits of this rank's final block x (b, s, D): of
        every position (the sequence gathered), or of the last one only
        (which lives on the last column where the sequence is
        sharded)."""
        if last_only:
            # laid out row-major: a (b, 1, D) slice of a gathered block
            # has strides CPU and meta tensors copy differently, and the
            # head's product folds to ``mm`` only when it is row-major
            x = x[:, -1:].clone(memory_format=torch.contiguous_format)
            if lay.seq:
                last = rules.mesh.index("model") == \
                    rules.axis_size("model") - 1
                x = comm.all_reduce(x if last else torch.zeros_like(x),
                                    rules.mesh, "model")
        else:
            x = seq_gather(x, rules, lay)
        return self._logits(x, rules, lay, specs)

    def _spmd_ce(self, x, batch, rules: Rules, lay: Layout, specs):
        """(the masked cross-entropy sum of the tokens this rank counts,
        their mask's sum) from its final hidden block x (b, s, D).  Each
        token is counted on exactly one rank: its rows' and positions'
        owner, the first rank along every axis that neither the rows nor
        the positions are laid over.  A vocab-sharded head takes a
        vocab-parallel log-sum-exp: the ranks of the vocabulary's axes
        hold the same tokens (the sequence gathered; the rows too where
        the vocabulary shares an axis with them), each its logits'
        vocabulary block, and reduce the shift (max), the exponentials'
        sum and the label's logit over them; no logits are gathered."""
        cfg, mesh = self.cfg, rules.mesh
        labels, mask = batch["labels"], batch.get("mask")
        B, S = labels.shape
        if mask is None:
            mask = torch.ones((B, S), dtype=F32, device=labels.device)
        rows, cols = lay.rows(rules, B), lay.positions(rules, S)
        x = rms_norm(x, self._use("final_norm"), cfg.norm_eps)
        head, va = self._spmd_head(specs)
        if va is None:
            logits = (x @ head).to(F32)
            lab = labels[rows][:, cols].long()
            nll = torch.logsumexp(logits, -1) - \
                logits.gather(-1, lab[..., None])[..., 0]
        else:
            x = seq_gather(x, rules, lay)
            full = lay.batch is not None and rules.overlaps(va, lay.batch)
            if full:
                x = comm.all_gather(x, mesh, lay.batch, 0)
            logits = (x @ head).to(F32)
            n = logits.shape[-1]
            loc = (labels if full else labels[rows]).long() - \
                entry_index(rules.mesh, va) * n
            top = comm.all_reduce(logits.detach().amax(-1), mesh, va, "max")
            se = comm.all_reduce(torch.exp(logits - top[..., None]).sum(-1),
                                 mesh, va)
            ok = (loc >= 0) & (loc < n)
            gold = logits.gather(-1, loc.clamp(0, n - 1)[..., None])[..., 0]
            gold = comm.all_reduce(torch.where(ok, gold, 0), mesh, va)
            nll = top + torch.log(se) - gold
            nll = (nll[rows] if full else nll)[:, cols]
        held = set(spec_axes((lay.batch, "model" if lay.seq else None)))
        owner = all(mesh.index(a) == 0 for a in mesh.axis_names
                    if a not in held)
        w = mask[rows][:, cols].to(F32) * float(owner)
        return (nll * w).sum(), w.sum()
