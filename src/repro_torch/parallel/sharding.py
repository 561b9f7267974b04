"""Logical-axis sharding rules (DP / TP / EP / SP / ZeRO-1; the port's
counterpart of ``repro.parallel.sharding``).

The model code never names mesh axes directly; it asks :class:`Rules`
which mesh axes a *logical* axis (batch, sequence, heads, FFN width,
vocabulary, experts, the KV cache's sequence) is laid over.  One Rules
object describes one parallelism strategy; :func:`make_rules` names the
reference's strategies.

Mapping to the paper: rows of the device grid (the ``data`` axis) are the
mesh's Y dimension, columns (``model``) the X dimension; ``pod`` is the
off-chip link to the next pod.  Weight-stationary TP traffic flows along
rows, gradient reduction along columns then pods — dimension-ordered,
like the XY router.

**No automatic placement.**  The reference hands activations to GSPMD
with ``with_sharding_constraint`` (``cs``, ``sharding``, ``act_btd``,
``act_bthd``, ``act_btf``, ``logits``) and lets it insert the
collectives.  The port has no such pass: each rank holds its block of
every tensor explicitly and the model code calls the collectives itself
(``repro_torch.parallel.comm``).  So those methods have no counterpart
here.  What they decide survives as :meth:`Rules.dim_axis`, ``cs``'s
safety rail (an axis that does not divide the dimension is dropped, e.g.
Whisper's vocabulary of 51,866), which the models ask before they cut or
gather a dimension.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import torch

from repro_torch.parallel import comm
from repro_torch.parallel.comm import Mesh

Axis = Union[str, Tuple[str, ...], None]

__all__ = ["Rules", "make_rules", "Axis", "Layout", "entry_names",
           "entry_index", "spec_axes", "replicated_axes", "block_of",
           "zero1_spec", "cut_block", "join_blocks"]


@dataclasses.dataclass(frozen=True)
class Rules:
    mesh: Mesh
    batch: Axis = ("pod", "data")   # DP over pods and data rows
    seq: Axis = "model"             # SP: activation sequence sharding
    heads: Axis = "model"           # TP: attention heads
    ff: Axis = "model"              # TP: FFN hidden
    vocab: Axis = "model"           # "virtual mesh" embedding shard (C7)
    experts: Axis = "model"         # EP: MoE expert homes (sub-mesh, C7)
    kv_seq: Axis = "model"          # decode: KV cache sequence shard (C7)
    # optimizer-state shard axis (ZeRO-1): the state's banks
    # (``optim.adamw.state_specs``); serving holds no optimizer state
    zero1: Axis = "data"
    # how the MoE dispatch travels: "xy" = dimension-ordered two-phase
    # (paper C4), "x" = the column phase only, "flat" = single-axis, "ep"
    # / "local" / "tp" as in models/moe.py, "auto" = by divisibility
    dispatch: str = "xy"
    # remat policy of a training step ("full", "dots", "none"); serving
    # rematerialises nothing (``cell_rules`` sets "none" for inference)
    remat: str = "full"
    # the reference's attention implementation: "chunked", "ref" and
    # "flash" compute one function, and the port runs each through the
    # flash kernel (its plain version on the CPU); the reference's
    # cost-isolation stub "noattn" has no counterpart and is refused
    attn_impl: str = "chunked"
    # the reference's SSD implementation: "chunked" and "kernel" compute
    # one function, and the port runs both through the SSD kernel (its
    # plain version on the CPU); the cost-isolation stub "skip" has no
    # counterpart and is refused
    ssd_impl: str = "chunked"
    # GQA: the reference's ablation keeping k/v at K heads; the flash
    # kernel always reads the K KV heads natively, so both values compute
    # the same function the same way here
    gqa_grouped: bool = False
    # Megatron TP as explicit islands (gather once -> local heads ->
    # reduce-scatter); without it, or where whole heads do not land on
    # each column, the port gathers the layer's weights instead (see
    # models/transformer.py)
    manual_tp: bool = True
    # FSDP / ZeRO-3: a training cell's parameters banked over zero1 too
    # (``zero1_spec``; the model's ``param_specs``), each layer's weights
    # all-gathered before use; ``cell_rules`` clears it for inference
    fsdp: bool = False

    def __post_init__(self):
        if self.attn_impl not in ("chunked", "ref", "flash"):
            raise ValueError(f"attn_impl {self.attn_impl!r}: the port "
                             f"computes attention with the flash kernel "
                             f"('chunked', 'ref' and 'flash' all mean it)")
        if self.ssd_impl not in ("chunked", "kernel"):
            raise ValueError(f"ssd_impl {self.ssd_impl!r}: the port runs "
                             f"the SSD scan through its kernel ('chunked' "
                             f"and 'kernel' both mean it)")

    # ------------------------------------------------------------------
    def has_axis(self, name: str) -> bool:
        return name in self.mesh.axis_names

    def axis_size(self, axis: Axis) -> int:
        if axis is None:
            return 1
        names = (axis,) if isinstance(axis, str) else axis
        n = 1
        for a in names:
            if a in self.mesh.axis_names:
                n *= self.mesh.shape[a]
        return n

    def _clean(self, axis: Axis) -> Axis:
        """Drop axes this mesh doesn't have (e.g. 'pod' on a single pod)."""
        if axis is None or isinstance(axis, str):
            return axis if (axis is None or self.has_axis(axis)) else None
        kept = tuple(a for a in axis if self.has_axis(a))
        return kept if kept else None

    def overlaps(self, a: Axis, b: Axis) -> bool:
        names = lambda ax: set((ax,) if isinstance(ax, str) else (ax or ()))  # noqa: E731
        return bool(names(self._clean(a)) & names(self._clean(b)))

    def dim_axis(self, axis: Axis, size: int) -> Axis:
        """The mesh axes a dimension of ``size`` is laid over: ``axis``
        cleaned, or None when it does not divide ``size`` (``cs``'s
        safety rail)."""
        axis = self._clean(axis)
        if axis is None or size % self.axis_size(axis):
            return None
        return axis


def entry_names(entry) -> Tuple[str, ...]:
    """A spec entry (None, an axis name or a tuple of names) as a tuple of
    names, major first."""
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def entry_index(mesh: Mesh, entry) -> int:
    """This rank's block index along a spec entry: row-major in the
    entry's own order (``("model", "data")`` is the data block of the
    model block)."""
    idx = 0
    for a in entry_names(entry):
        idx = idx * mesh.shape[a] + mesh.index(a)
    return idx


def spec_axes(spec) -> Tuple[str, ...]:
    """Every mesh axis named in ``spec`` (a tuple of per-dimension
    entries)."""
    return tuple(a for e in spec for a in entry_names(e))


def replicated_axes(rules: Rules, spec) -> Tuple[str, ...]:
    """The mesh axes a tensor laid out by ``spec`` is replicated on (those
    its spec does not name), in mesh order: a parameter's gradient is
    summed over them."""
    used = set(spec_axes(spec))
    return tuple(a for a in rules.mesh.axis_names if a not in used)


def block_of(mesh: Mesh, spec, block_shape) -> Tuple[Tuple[int, ...],
                                                    Tuple[slice, ...]]:
    """(the global shape, this rank's slices of it) of a block laid out
    by ``spec`` (tuple entries row-major in their own order,
    :func:`entry_index`)."""
    spec = tuple(spec) + (None,) * (len(block_shape) - len(tuple(spec)))
    shape, where = [], []
    for n, e in zip(block_shape, spec):
        idx, parts = entry_index(mesh, e), 1
        for a in entry_names(e):
            parts *= mesh.shape[a]
        shape.append(n * parts)
        where.append(slice(idx * n, (idx + 1) * n))
    return tuple(shape), tuple(where)


def zero1_spec(spec: Tuple, shape: Tuple[int, ...], rules) -> Tuple:
    """``spec`` (a parameter's per-dimension mesh axes) extended with the
    ``zero1`` axis on the largest still-divisible dimension: the ZeRO-1
    bank (the reference's ``optim.adamw._zero1_spec``; the optimizer's
    state and, under FSDP, the parameters are laid out by it).  An
    existing entry is extended in place (``"model"`` -> ``("model",
    "data")``); ``spec`` comes back unchanged where nothing divides or
    where it already names ``zero1``."""
    z = rules._clean(rules.zero1)
    if z is None:
        return spec
    z_names = entry_names(z)
    z_size = rules.axis_size(z)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    if any(n in spec_axes(entries) for n in z_names):
        return spec
    best, best_len = -1, 0
    for d, e in enumerate(entries):
        here = rules.axis_size(e) if e else 1
        if shape[d] % (here * z_size) == 0:
            eff = shape[d] // here
            if eff > best_len:
                best, best_len = d, eff
    if best < 0:
        return spec
    e = entries[best]
    if e is None:
        entries[best] = z if isinstance(z, str) else z_names
    else:
        entries[best] = entry_names(e) + z_names
    return tuple(entries)


def cut_block(t: torch.Tensor, spec, rules: Rules) -> torch.Tensor:
    """This rank's block of the whole tensor ``t``, dimension ``d`` cut
    over ``spec[d]`` (a tuple entry row-major in its own order:
    ``("model", "data")`` is the data block of the model block)."""
    for d, a in enumerate(spec):
        n = t.shape[d] // rules.axis_size(a)
        t = t.narrow(d, entry_index(rules.mesh, a) * n, n)
    return t.contiguous()


def join_blocks(t: torch.Tensor, spec, rules: Rules) -> torch.Tensor:
    """The whole of a tensor blocked by ``spec``: each dimension
    all-gathered over its axes, the minor axis of a tuple entry first
    (collective over every rank that holds a block; its backward
    reduce-scatters)."""
    for d, a in enumerate(spec):
        for name in reversed(entry_names(a)):
            t = comm.all_gather(t, rules.mesh, name, d)
    return t


def make_rules(mesh: Mesh, strategy: str = "baseline", **overrides) -> Rules:
    """Named strategies (the reference's):

    baseline    — production defaults (TP rows, DP columns+pods, Megatron
                  SP for activations, xy MoE dispatch, full remat)
    fsdp        — parameters banked over zero1 too (training)
    no_sp       — activations replicated over seq (ablation)
    flat_a2a    — MoE dispatch as a single flat all-to-all (ablation)
    no_zero1    — optimizer states replicated (ablation)
    """
    base = dict()
    if strategy == "baseline":
        pass
    elif strategy == "fsdp":
        base["fsdp"] = True
    elif strategy == "no_sp":
        base["seq"] = None
    elif strategy == "flat_a2a":
        base["dispatch"] = "flat"
    elif strategy == "no_zero1":
        base["zero1"] = None
    else:
        raise ValueError(f"unknown strategy {strategy!r}")
    base.update(overrides)
    return Rules(mesh=mesh, **base)


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where a rank's activation block (b, s, D) sits in the global (B, S,
    D): its rows are the ``batch`` axes' block (None: every rank holds
    every row), and with ``seq`` its positions are the ``model`` axis'
    block (Megatron sequence parallelism, the reference's
    ``act_btd``)."""

    batch: Axis
    seq: bool

    @staticmethod
    def of(rules: Rules, batch: int, seq_len: int) -> "Layout":
        """The reference's activation layout for a (batch, seq_len)
        input: the batch over ``rules.batch`` where it divides, the
        sequence over ``model`` where ``rules.seq`` names it and it
        divides (the islands' ``seq_sharded``)."""
        seq = rules.overlaps(rules.seq, "model") and \
            seq_len % rules.axis_size("model") == 0
        return Layout(rules.dim_axis(rules.batch, batch), seq)

    def rows(self, rules: Rules, batch: int) -> slice:
        """This rank's rows of a global batch of ``batch``."""
        n = rules.axis_size(self.batch)
        b = batch // n
        i = rules.mesh.index(self.batch) if self.batch else 0
        return slice(i * b, (i + 1) * b)

    def positions(self, rules: Rules, seq_len: int) -> slice:
        """This rank's positions of a global sequence of ``seq_len``."""
        if not self.seq:
            return slice(0, seq_len)
        n = rules.axis_size("model")
        s = seq_len // n
        i = rules.mesh.index("model")
        return slice(i * s, (i + 1) * s)

    def gather(self, x: torch.Tensor, rules: Rules) -> torch.Tensor:
        """The global (B, S, ...) tensor of every rank's block."""
        if self.seq:
            x = comm.all_gather(x, rules.mesh, "model", 1)
        if self.batch:
            x = comm.all_gather(x, rules.mesh, self.batch, 0)
        return x
