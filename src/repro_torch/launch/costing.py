"""Roofline cost terms of a cell from one dry run on the ``meta`` device
(the port's counterpart of ``repro.launch.costing``).

The reference compiles two unrolled variants of a cell (1 and ``n2`` scan
trips) and extrapolates linearly, because XLA's ``cost_analysis`` counts
a ``while``-loop body once.  The port runs eagerly, every layer its own
Python call, so :func:`measure_cell_cost` runs the cell once, at full
depth, on a dry mesh (``comm.Mesh.dry``: one rank's coordinates, no
process group, every tensor on ``meta``) and counts as it goes, one
rank's share (``tests/test_torch_costing.py`` holds the count to the
reference's 1-/``n2``-trip extrapolation):

* **FLOPs**: the formulas ``torch.utils.flop_counter`` registers
  (matrix products, convolutions, attention) over every aten op outside a
  kernel, plus each kernel record's FLOPs (``kernels/record.py``: the
  ``*_bound`` of the call, from its shapes).  Elementwise work is not
  counted, where XLA's ``cost_analysis`` counts it.
* **bytes accessed**: for each aten op outside a kernel record, its
  tensor inputs read once plus its outputs written once (eager PyTorch
  launches one kernel per op, so this is the card's traffic, each
  tensor charged to HBM); views and aliasing ops count 0, an in-place op
  its written tensor once each way (it is an input and the output),
  ``empty`` nothing, other factory ops their writes; plus each kernel
  record's bytes.  A collective's own work goes to ``collectives`` only.
* **bytes adjusted** equals ``bytes accessed``: the reference replaces
  its mixers' HLO traffic by its Pallas kernels' modelled traffic; the
  port counts its kernels as themselves, so there is nothing to replace.
  The key is kept for ``roofline()`` and ``markdown_table``;
  ``bytes kernels`` and ``flops kernels`` are the kernels' shares.

The meta run takes the card's route op for op: a kernel wherever the card
launches one (the wrappers record instead of launching), and the plain
recompute wherever the card runs one (``kernels/ops.py``: flash's and the
SSD's backward, the GMM's transposed copies).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch import own_work
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.kernels import record
from repro_torch.parallel import comm
from repro_torch.parallel.sharding import zero1_spec

from . import roofline as rl
from . import step as step_mod

__all__ = ["reduced_depth_cfg", "scan_trips", "measure_cell_cost",
           "netsim_collectives", "kernel_hbm_bytes", "analytic_memory",
           "count_cost", "Count"]

aten = torch.ops.aten

# ops that move no data: aliases the schema does not mark as views, and
# allocations that write nothing
_ALIASES = frozenset({aten._unsafe_view, aten.lift_fresh, aten.alias,
                      aten.detach, aten._reshape_alias})
_NO_WRITE = frozenset({aten.empty, aten.empty_like, aten.empty_strided,
                       aten.new_empty, aten.new_empty_strided, aten.resize_,
                       aten.set_})


def netsim_collectives(colls: Dict[str, Dict[str, float]],
                       congestion) -> Dict[str, Dict[str, float]]:
    """Annotate a collectives dict with simulated network timing.

    ``congestion`` is a fitted :class:`repro_torch.workloads.CongestionModel`;
    every op entry gains ``sim_cycles`` / ``sim_s`` / ``family`` next to
    the analytic ``bytes`` / ``wire_bytes`` — the numbers
    ``roofline(..., network="netsim")`` prices the collective term with.
    """
    sim = congestion.collective_times(colls)
    return {op: {**d, **sim.get(op, {})} for op, d in colls.items()}


def reduced_depth_cfg(cfg: ModelConfig, n_units: int) -> ModelConfig:
    """Same arch at ``n_units`` scan trips of depth (full width)."""
    unit = cfg.attn_period if cfg.family == "hybrid" else 1
    kw = dict(num_layers=unit * n_units)
    if cfg.encdec is not None:
        kw["encdec"] = dataclasses.replace(cfg.encdec,
                                           encoder_layers=n_units)
    return dataclasses.replace(cfg, **kw)


def scan_trips(cfg: ModelConfig) -> int:
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.attn_period
    return cfg.num_layers


def _variant_trips(cfg: ModelConfig) -> int:
    """The reference's second variant's trip count (deeper for small
    bodies); the port's tests extrapolate from it."""
    return min(scan_trips(cfg), 4 if cfg.d_model <= 2048 else 2)


def kernel_hbm_bytes(cfg: ModelConfig, shape: ShapeConfig, chips: int) -> float:
    """The reference's model of its Pallas mixer kernels' per-device HBM
    traffic on the TPU (it replaces their HLO traffic there; the port
    counts its kernels' own records instead and keeps this for the
    record).

    flash_attention reads Q,K,V and writes O once per pass (scores stay in
    VMEM); ssd_scan reads x,dt,B,C and writes y (+ fp32 chunk states).
    Training ~4 passes (fwd, remat recompute, bwd read + grad write);
    prefill ~1.5.
    """
    T = shape.global_batch * shape.seq_len
    rw = 4.0 if shape.kind == "train" else 1.5
    hd, H, K = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    attn_l = (2 * H * hd + 2 * K * hd) * 2.0 * T          # q+o, k+v bf16
    total = 0.0
    if cfg.family in ("dense", "moe", "vlm"):
        total = cfg.num_layers * attn_l
    elif cfg.family == "ssm":
        s = cfg.ssm
        di, nh = s.d_inner(cfg.d_model), s.num_heads(cfg.d_model)
        ssd_l = (2 * di + 2 * s.num_groups * s.state_dim + nh) * 2.0 * T \
            + (T // s.chunk) * nh * s.state_dim * s.head_dim * 4.0
        total = cfg.num_layers * ssd_l
    elif cfg.family == "hybrid":
        s = cfg.ssm
        di, nh = s.d_inner(cfg.d_model), s.num_heads(cfg.d_model)
        ssd_l = (2 * di + 2 * s.num_groups * s.state_dim + nh) * 2.0 * T \
            + (T // s.chunk) * nh * s.state_dim * s.head_dim * 4.0
        n_attn = cfg.num_layers // cfg.attn_period
        total = n_attn * attn_l + (cfg.num_layers - n_attn) * ssd_l
    elif cfg.family == "audio":
        Te = shape.global_batch * cfg.encdec.encoder_seq
        enc = cfg.encdec.encoder_layers * (2 * H * hd + 2 * K * hd) * 2.0 * Te
        dec = cfg.num_layers * (attn_l                       # self
                                + (2 * H * hd) * 2.0 * T     # cross q+o
                                + (2 * K * hd) * 2.0 * Te)   # cross k,v
        total = enc + dec
    return rw * total / chips


def _shard_bytes(shapes: Dict[str, Tuple[Tuple[int, ...], int]],
                 specs: Dict[str, Tuple], rules) -> int:
    """The bytes of a rank's blocks of ``shapes`` (name -> (global shape,
    itemsize)) laid out by ``specs`` (a dimension over axes that do not
    divide it held padded, as a sharded array's shard is)."""
    total = 0
    for k, (shape, itemsize) in shapes.items():
        n = 1
        for d, size in enumerate(shape):
            spec = specs[k]
            parts = rules.axis_size(spec[d]) if d < len(spec) else 1
            n *= -(-size // parts)
        total += n * itemsize
    return total


def analytic_memory(cfg: ModelConfig, shape: ShapeConfig, rules,
                    chips: int) -> Dict[str, float]:
    """The reference's per-device HBM residency model: params (their
    dtypes) + optimizer state (3 x fp32, ZeRO-1-banked) + gradients
    (transient, params-sized) + remat carries (one activation slab per
    scan trip) + logits (+fp32 softmax copy) + KV cache.  ``rules`` are
    the cell's (``cell_rules``)."""
    from repro_torch import optim
    from repro_torch.models import get_model
    cls = get_model(cfg)
    table = cls.param_table(cfg)
    item = {k: torch.empty((), dtype=cls.param_dtype(cfg, k)).element_size()
            for k in table}
    p_specs = cls.layout_specs(cfg, rules)
    if rules.fsdp and shape.kind == "train":
        p_specs = {k: zero1_spec(p_specs[k], table[k], rules)
                   for k in p_specs}
    params_b = _shard_bytes({k: (table[k], item[k]) for k in table},
                            p_specs, rules)
    out: Dict[str, float] = {"params": params_b}
    dp = rules.axis_size(rules.batch)
    sp = rules.axis_size(rules.seq)
    B_loc = shape.global_batch / max(dp, 1)
    if shape.kind == "train":
        s_specs = optim.state_specs(p_specs, table, rules)
        out["opt_state"] = sum(
            _shard_bytes({n: (table[n], 4) for n in table}, s_specs[k], rules)
            for k in ("master", "m", "v"))
        out["grads"] = params_b
        trips = scan_trips(cfg)
        carry = B_loc * (shape.seq_len / max(sp, 1)) * cfg.d_model * 2.0
        out["remat_carries"] = trips * carry
        v_loc = cfg.vocab_size / (rules.axis_size(rules.vocab)
                                  if cfg.vocab_size %
                                  max(rules.axis_size(rules.vocab), 1) == 0
                                  else 1)
        out["logits"] = B_loc * (shape.seq_len / max(sp, 1)) * v_loc * 6.0
    elif shape.kind == "decode":
        cache = step_mod.input_specs(cfg, shape)["cache"]
        out["kv_cache"] = _shard_bytes(
            {k: (tuple(t.shape), t.element_size()) for k, t in cache.items()},
            cls.cache_specs(cfg, rules), rules)
    out["total"] = float(sum(out.values()))
    return out


# ---------------------------------------------------------------------------
# counting a run
# ---------------------------------------------------------------------------

class _Counter(TorchDispatchMode):
    """FLOPs and bytes of every aten op outside a kernel call or a
    collective (module docstring); with ``keep_ops`` the list of those
    ops (name and output shapes) too."""

    def __init__(self, keep_ops: bool = False):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.ops: Optional[List[Tuple[str, tuple]]] = [] if keep_ops else None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if own_work.suppressed():
            return out
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if not outs:
            return out
        packet = func._overloadpacket
        if self.ops is not None:
            self.ops.append((str(func), tuple(tuple(t.shape) for t in outs)))
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        if func.is_view or packet in _ALIASES or packet in _NO_WRITE:
            return out
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        return out


@dataclasses.dataclass
class Count:
    """What one counted run did on this rank: ``cost`` (the reference's
    keys), ``collectives`` (:func:`roofline.collectives_from_records`),
    the kernel ``records``, the collective ``calls``, ``comm_stats`` and
    ``phase_stats`` (``parallel.comm``) and the aten ``ops`` outside
    kernels (with ``keep_ops``)."""

    cost: Dict[str, float]
    collectives: Dict[str, Dict[str, float]]
    records: List[Dict[str, Any]]
    calls: List[Dict[str, Any]]
    comm_stats: Dict[str, Dict[str, int]]
    phase_stats: Dict[str, Dict[str, Dict[str, int]]]
    ops: Optional[List[Tuple[str, tuple]]]


def count_cost(fn, *args, keep_ops: bool = False, **kwargs) -> Count:
    """Run ``fn(*args, **kwargs)`` once, counting its aten ops, kernel
    calls and collectives (``comm``'s counters are reset first)."""
    comm.reset_comm_stats()
    counter = _Counter(keep_ops)
    with record.recording() as recs, comm.listing_calls() as calls, \
            counter:
        fn(*args, **kwargs)
    k_bytes = sum(r["bytes"] for r in recs)
    k_flops = sum(r["flops"] for r in recs)
    nbytes = float(counter.bytes + k_bytes)
    cost = {"flops": float(counter.flops + k_flops),
            "bytes accessed": nbytes, "bytes adjusted": nbytes,
            "bytes kernels": float(k_bytes), "flops kernels": float(k_flops)}
    return Count(cost, rl.collectives_from_records(calls), list(recs), calls,
                 comm.comm_stats(), comm.phase_stats(), counter.ops)


def measure_cell_cost(cfg: ModelConfig, shape: ShapeConfig, mesh,
                      strategy: str = "baseline", *, congestion=None,
                      **rule_overrides
                      ) -> Tuple[Dict[str, float], Dict[str, Dict[str, float]]]:
    """Returns (cost, collectives), per device: the cell built on
    ``mesh`` (a dry mesh: the rank its coordinates name) and run once at
    full depth under :func:`count_cost`.

    cost keys: ``flops``, ``bytes accessed``, ``bytes adjusted`` (equal:
    module docstring), ``bytes kernels``, ``flops kernels``.

    Pass a fitted ``congestion`` model to get the collectives dict back
    already annotated with simulated timing (:func:`netsim_collectives`).
    """
    cell = step_mod.build_cell(cfg, shape, mesh, strategy, **rule_overrides)
    got = count_cost(cell.run)
    colls = got.collectives
    if congestion is not None:
        colls = netsim_collectives(colls, congestion)
    return got.cost, colls
