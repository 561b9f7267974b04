"""The collective substrate of the port's SPMD code: a named device mesh
over ``torch.distributed`` and the collectives the JAX package writes as
``lax`` primitives inside ``shard_map``.

Each JAX named axis becomes a process group (``dist.new_group``) over
the ranks of each row of the mesh along it:

* a JAX axis name -> that group (:meth:`Mesh.group`; a tuple of axes ->
  one group over their product, ranks in row-major order);
* ``lax.axis_index`` -> the rank's coordinate (:meth:`Mesh.index`,
  row-major over a tuple of axes);
* ``lax.all_gather(tiled=True)`` / ``psum_scatter(tiled=True)`` /
  ``psum`` / ``pmax`` / ``all_to_all(tiled=True)`` / ``ppermute`` ->
  :func:`all_gather`, :func:`reduce_scatter`, :func:`all_reduce`,
  :func:`all_to_all`, :func:`ppermute` (``batch_isend_irecv`` within the
  group).

Every function runs inside a rank, on the rank's local tensor, as the
reference's run inside ``shard_map``; a group of one rank returns its
input unchanged (a copy where the reference's result is a new array).

**Gradients.**  Each collective is a ``torch.autograd.Function`` whose
backward is its plain transpose, as JAX transposes the ``lax``
primitive: all-gather <-> reduce-scatter, the sum all-reduce is its own
transpose, the tiled ``all_to_all`` is its own transpose, ``ppermute``'s
is ``ppermute`` with the pairs reversed.  Integer tensors pass through
with no gradient; ``all_reduce(op="max")`` carries none.  The backward
runs through the same wire format, host staging and counting as the
forward.  That makes autograd on every rank compute the gradient of one
function, given one convention for what a rank's loss means:

* the global loss is the **sum of the ranks' local losses**;
* each token's cross-entropy term is counted on exactly one rank,
  divided by the global token count (the reported loss is the
  all-reduced sum, equal on every rank);
* a value every rank of a group holds alike (the gathered logits, the
  MoE aux loss after its mean over the island) enters the local losses
  once per group, not once per rank.

Under it, a parameter's gradient on a rank is that rank's share; the
sum over the mesh axes the parameter is replicated on is its gradient
(``repro_torch.optim.adamw``: a reduce-scatter over ``zero1`` into the
rank's bank where ZeRO-1 banks it, an all-reduce over the rest; under
FSDP the weight all-gather's backward is that reduce-scatter).

**Backends.**  The process group's backend is chosen by whoever starts the
ranks (:func:`repro_torch.launch.mesh.spawn`), never guessed here: ``gloo``
on the CPU; on the card ``nccl`` when each rank has a card of its own,
else ``gloo`` over CUDA tensors (ranks sharing one card: NCCL refuses two
ranks of one communicator on one device).  Where gloo takes no CUDA
tensor for an op, the op is staged through the host: :data:`HOST_STAGED`
names those ops per backend, and :func:`staged` answers for a tensor.
That table is the one place the decision is made, per op, from what the
backend does, not from a failure.

**Counting.**  Each call adds one to its op's ``calls`` and the bytes of
its input to ``bytes`` in :data:`STATS` (read with :func:`comm_stats`,
zeroed with :func:`reset_comm_stats`); a backward counts under
``<op>.bwd`` (``all_gather.bwd`` is the reduce-scatter of an
all-gather's gradient).  Within :func:`counting_phase` each call is also
counted under the phase's name (:func:`phase_stats`: a training step's
``loss``, ``backward`` and ``optimizer``).  A call on a group of one rank
moves nothing and is not counted.
"""
from __future__ import annotations

import contextlib
import itertools
from typing import Dict, Iterable, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

__all__ = ["Mesh", "Axes", "HOST_STAGED", "staged", "all_gather",
           "reduce_scatter", "all_reduce", "all_to_all", "ppermute",
           "STATS", "comm_stats", "reset_comm_stats", "counting_phase",
           "phase_stats"]

Axes = Union[str, Sequence[str], None]

# Ops run through the host for CUDA tensors.  gloo (torch 2.11 on the H100
# machine, 4 ranks sharing the card) takes CUDA tensors for all_gather,
# reduce_scatter, all_reduce (sum, max) and all_to_all, and aborts on
# them in point-to-point sends ("writev ... Bad address"): ppermute goes
# through the host.  ``chip_smoke.py`` prints this table.
HOST_STAGED: Dict[str, frozenset] = {
    "gloo": frozenset({"ppermute"}),
    "nccl": frozenset(),
}

STATS: Dict[str, Dict[str, int]] = {}
_PHASES: Dict[str, Dict[str, Dict[str, int]]] = {}
_PHASE: Optional[str] = None


def comm_stats() -> Dict[str, Dict[str, int]]:
    """{op: {"calls": n, "bytes": b}} since the last reset, this rank."""
    return {k: dict(v) for k, v in STATS.items()}


def phase_stats() -> Dict[str, Dict[str, Dict[str, int]]]:
    """{phase: {op: {"calls": n, "bytes": b}}} of the calls made within
    :func:`counting_phase` since the last reset, this rank."""
    return {p: {k: dict(v) for k, v in ops.items()}
            for p, ops in _PHASES.items()}


def reset_comm_stats() -> None:
    STATS.clear()
    _PHASES.clear()


@contextlib.contextmanager
def counting_phase(name: str):
    """Count the calls made within the block under phase ``name`` too."""
    global _PHASE
    _PHASE, outer = name, _PHASE
    try:
        yield
    finally:
        _PHASE = outer


def _count(op: str, x: torch.Tensor) -> None:
    nbytes = x.numel() * x.element_size()
    for table in (STATS,) if _PHASE is None else \
            (STATS, _PHASES.setdefault(_PHASE, {})):
        s = table.setdefault(op, {"calls": 0, "bytes": 0})
        s["calls"] += 1
        s["bytes"] += nbytes


class Mesh:
    """A named mesh of ranks of the initialised default process group.

    ``shape`` and ``axis_names`` as a JAX mesh's: ``Mesh((2, 4), ("data",
    "model"))`` puts rank ``r`` at row ``r // 4``, column ``r % 4``.
    ``ranks`` (default: every rank of the process group) are the global
    ranks the mesh covers, in row-major order; a mesh on a subset of the
    world is what an elastic re-shard moves to (``Trainer.reshard``).
    ``device`` is where this rank's tensors live (``cpu`` or its card).

    Collective over the whole process group: every rank constructs it,
    the ranks outside it too, in the same order as its other groups, and
    every rank builds every group of every axis and combination of axes
    in one order (``dist.new_group`` is collective over the world).  A
    rank outside the mesh holds a mesh it is no :attr:`member` of: it
    takes part in no collective of it."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 device=None, ranks: Optional[Sequence[int]] = None):
        shape, axis_names = tuple(shape), tuple(axis_names)
        n = 1
        for s in shape:
            n *= s
        world = dist.get_world_size()
        if ranks is None:
            ranks = range(world)
        ranks = [int(r) for r in ranks]
        if n != len(ranks):
            raise ValueError(f"mesh {shape} needs {n} ranks, got "
                             f"{len(ranks)} (the process group has "
                             f"{world})")
        if len(set(ranks)) != n or not all(0 <= r < world for r in ranks):
            raise ValueError(f"mesh ranks {ranks} are not distinct ranks "
                             f"of a world of {world}")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self.device = torch.device("cpu" if device is None else device)
        self.backend = dist.get_backend()
        self.ranks = tuple(ranks)
        me = dist.get_rank()
        self.member = me in self.ranks
        grid = torch.tensor(ranks).reshape(shape)
        self._coords = {} if not self.member else dict(zip(
            axis_names, (int(c) for c in
                         (grid == me).nonzero()[0].tolist())))
        # a group per row along every axis and every combination of
        # axes, ranks in row-major order; built in one order everywhere
        self._groups = {}
        for k in range(1, len(axis_names) + 1):
            for combo in itertools.combinations(range(len(axis_names)), k):
                rest = [d for d in range(len(axis_names)) if d not in combo]
                sub = grid.permute(*rest, *combo).reshape(
                    -1, *[shape[d] for d in combo])
                names = tuple(axis_names[d] for d in combo)
                for row in sub.reshape(sub.shape[0], -1).tolist():
                    g = dist.new_group(ranks=row)
                    if me in row:
                        self._groups[names] = g

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def rank(self) -> int:
        """This rank's global rank."""
        return dist.get_rank()

    def names(self, axes: Axes) -> Tuple[str, ...]:
        """``axes`` as a tuple of this mesh's axis names, in mesh order.
        Raises on an axis the mesh lacks or on a tuple out of mesh
        order (the row-major index and the group order would differ)."""
        if axes is None:
            return ()
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in names:
            if a not in self.shape:
                raise ValueError(f"mesh {self.axis_names} has no axis {a!r}")
        if list(names) != sorted(names, key=self.axis_names.index):
            raise ValueError(f"axes {names} are not in mesh order "
                             f"{self.axis_names}")
        return names

    def axis_size(self, axes: Axes) -> int:
        n = 1
        for a in self.names(axes):
            n *= self.shape[a]
        return n

    def _check_member(self) -> None:
        if not self.member:
            raise RuntimeError(f"rank {dist.get_rank()} is not in this "
                               f"mesh (ranks {list(self.ranks)})")

    def index(self, axes: Axes) -> int:
        """This rank's index along ``axes`` (``lax.axis_index``; row-major
        over a tuple)."""
        self._check_member()
        idx = 0
        for a in self.names(axes):
            idx = idx * self.shape[a] + self._coords[a]
        return idx

    def group(self, axes: Axes):
        self._check_member()
        return self._groups[self.names(axes)]


def staged(mesh: Mesh, op: str, x: torch.Tensor) -> bool:
    """Whether ``op`` on ``x`` goes through the host on ``mesh``'s
    backend (:data:`HOST_STAGED`)."""
    return x.device.type == "cuda" and op in HOST_STAGED.get(mesh.backend,
                                                             ())


def _wire(x: torch.Tensor, host: bool) -> torch.Tensor:
    """The tensor a collective sends: contiguous, on the host if staged,
    bool as uint8 (gloo has no bool)."""
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    if host:
        x = x.cpu()
    return x.contiguous()


def _back(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return y.to(device=like.device, dtype=like.dtype)


_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


# -- the collectives themselves (no autograd; ``name`` is what is counted) --

def _gather(x, mesh: Mesh, axes: Axes, dim: int, name: str):
    n = mesh.axis_size(axes)
    _count(name, x)
    w = _wire(x.movedim(dim, 0), staged(mesh, "all_gather", x))
    out = torch.empty((n * w.shape[0],) + tuple(w.shape[1:]),
                      dtype=w.dtype, device=w.device)
    _GATHER(out, w, group=mesh.group(axes))
    return _back(out, x).movedim(0, dim)


def _scatter(x, mesh: Mesh, axes: Axes, dim: int, name: str):
    n = mesh.axis_size(axes)
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not divide into {n}")
    _count(name, x)
    w = _wire(x.movedim(dim, 0), staged(mesh, "reduce_scatter", x))
    out = torch.empty((w.shape[0] // n,) + tuple(w.shape[1:]),
                      dtype=w.dtype, device=w.device)
    _SCATTER(out, w, group=mesh.group(axes))
    return _back(out, x).movedim(0, dim)


def _reduce(x, mesh: Mesh, axes: Axes, op: str, name: str):
    _count(name, x)
    w = _wire(x, staged(mesh, f"all_reduce_{op}", x))
    if w is x:
        w = x.clone()
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    dist.all_reduce(w, op=red, group=mesh.group(axes))
    return _back(w, x)


def _a2a(x, mesh: Mesh, axes: Axes, dim: int, name: str):
    n = mesh.axis_size(axes)
    if x.shape[dim] % n:
        raise ValueError(f"all_to_all: dim {dim} of {tuple(x.shape)} does "
                         f"not divide into {n}")
    _count(name, x)
    w = _wire(x.movedim(dim, 0), staged(mesh, "all_to_all", x))
    out = torch.empty_like(w)
    dist.all_to_all_single(out, w, group=mesh.group(axes))
    return _back(out, x).movedim(0, dim)


def _permute(x, mesh: Mesh, axis: str, perm, name: str):
    me = mesh.index(axis)
    _count(name, x)
    w = _wire(x, staged(mesh, "ppermute", x))
    out = w.clone() if (me, me) in perm else torch.zeros_like(w)
    group = mesh.group(axis)
    ranks = dist.get_process_group_ranks(group)
    ops = [dist.P2POp(dist.isend, w, ranks[d], group)
           for s, d in perm if s == me != d]
    ops += [dist.P2POp(dist.irecv, out, ranks[s], group)
            for s, d in perm if d == me != s]
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return _back(out, x)


# -- their autograd: each backward is the forward's transpose (module
# docstring), counted as "<op>.bwd" --------------------------------------

class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return _gather(x, mesh, axes, dim, "all_gather")

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, *ctx.args, "all_gather.bwd"), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return _scatter(x, mesh, axes, dim, "reduce_scatter")

    @staticmethod
    def backward(ctx, g):
        return _gather(g, *ctx.args, "reduce_scatter.bwd"), None, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.args = (mesh, axes)
        return _reduce(x, mesh, axes, "sum", "all_reduce_sum")

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, *ctx.args, "sum", "all_reduce_sum.bwd"), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return _a2a(x, mesh, axes, dim, "all_to_all")

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, *ctx.args, "all_to_all.bwd"), None, None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.args = (mesh, axis, [(d, s) for s, d in perm])
        return _permute(x, mesh, axis, perm, "ppermute")

    @staticmethod
    def backward(ctx, g):
        return _permute(g, *ctx.args, "ppermute.bwd"), None, None, None


def all_gather(x: torch.Tensor, mesh: Mesh, axes: Axes, dim: int = 0
               ) -> torch.Tensor:
    """``lax.all_gather(x, axes, axis=dim, tiled=True)``: the group's
    blocks concatenated along ``dim`` in group order.  Backward: the
    reduce-scatter of the gradient."""
    if mesh.axis_size(axes) == 1:
        return x
    return _AllGather.apply(x, mesh, axes, dim)


def reduce_scatter(x: torch.Tensor, mesh: Mesh, axes: Axes, dim: int = 0
                   ) -> torch.Tensor:
    """``lax.psum_scatter(x, axes, scatter_dimension=dim, tiled=True)``:
    the group's sum, block ``i`` of ``dim`` left on group rank ``i``.
    Backward: the all-gather of the gradient."""
    if mesh.axis_size(axes) == 1:
        return x
    return _ReduceScatter.apply(x, mesh, axes, dim)


def all_reduce(x: torch.Tensor, mesh: Mesh, axes: Axes, op: str = "sum"
               ) -> torch.Tensor:
    """``lax.psum`` (``op="sum"``) or ``lax.pmax`` (``op="max"``) over
    ``axes``; a new tensor.  The sum's backward is the sum of the
    gradient; the max carries no gradient (it serves statistics, e.g. a
    log-sum-exp's shift, taken of detached values)."""
    if mesh.axis_size(axes) == 1:
        return x.clone()
    if op == "max":
        return _reduce(x.detach(), mesh, axes, "max", "all_reduce_max")
    if op != "sum":
        raise ValueError(f"all_reduce op must be 'sum' or 'max', got {op!r}")
    return _AllReduce.apply(x, mesh, axes)


def all_to_all(x: torch.Tensor, mesh: Mesh, axes: Axes, dim: int = 0
               ) -> torch.Tensor:
    """``lax.all_to_all(x, axes, split_axis=dim, concat_axis=dim,
    tiled=True)``: block ``i`` of ``dim`` goes to group rank ``i``, the
    received blocks concatenated along ``dim`` in source order.  Its own
    transpose: the backward is the same call on the gradient.  Integer
    tensors (routing metadata) pass through with no gradient."""
    if mesh.axis_size(axes) == 1:
        return x
    return _AllToAll.apply(x, mesh, axes, dim)


def ppermute(x: torch.Tensor, mesh: Mesh, axis: str,
             perm: Iterable[Tuple[int, int]]) -> torch.Tensor:
    """``lax.ppermute(x, axis, perm)``: ``perm`` holds (source, dest)
    pairs of indices along ``axis``; a rank no pair sends to gets zeros.
    Backward: ``ppermute`` of the gradient with the pairs reversed."""
    perm = list(perm)
    if mesh.axis_size(axis) == 1:
        return x.clone() if (0, 0) in perm else torch.zeros_like(x)
    return _PPermute.apply(x, mesh, axis, perm)
