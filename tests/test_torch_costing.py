"""The port's costing tools (``repro_torch.launch.{roofline,costing,dryrun}``,
the cells of ``launch/step.py``, ``launch/mesh.py::HW``, the dry mesh of
``parallel/comm.py`` and the kernels' meta route) against the JAX
package and against real runs, on the CPU.

**Exact against the reference**, where the reference is arithmetic over
configs and specs:

* ``roofline()`` with ``HW`` set to the reference's constants gives the
  reference's ``RooflineReport`` field for field for the same cost and
  collectives, analytic and ``network="netsim"`` (a ``CongestionModel``
  from both packages' ``fit`` on the same reports); ``model_flops``,
  ``cell_applicable`` and ``all_cells`` for all 40 cells; ``_advice`` and
  ``markdown_table`` on a directory of records;
* ``reduced_depth_cfg``, ``scan_trips``, ``_variant_trips`` and
  ``kernel_hbm_bytes`` for every architecture;
* ``input_specs``: every leaf's shape and dtype equal to the reference's
  ``ShapeDtypeStruct``s, every architecture x shape at published widths;
* the cells' parameter, optimizer-state, batch and cache layouts
  (``build_cell`` on a dry mesh) equal the reference ``build_cell``'s
  ``in_shardings`` on ``mesh_dm``, and on the production 16x16 and
  2x16x16 meshes (the reference's specs on a ``jax.sharding.AbstractMesh``,
  which needs no devices), baseline and fsdp; ``analytic_memory`` for
  every cell on the same meshes;
* the ring wire model of ``collectives_from_records`` equal to
  ``parse_collectives`` on HLO text mirroring the records (the
  reference's ``tests/test_roofline.py`` text, and text written from a
  dry run's calls);
* ``flash_bound``'s closed form (``kept_pairs``) equal to the mask count.

**Against real runs**, where the reference's method (XLA's cost analysis,
HLO text) has no PyTorch counterpart: for reduced cells of four families
(Qwen2 train, Moonshot train in ``xy``, Jamba prefill, Mamba-2 decode; bf16)
8 gloo ranks run the real step on a (data 2, model 4) mesh and, in the
same rank, the cell on ``Mesh.dry`` at that rank's coordinates on
``meta``: each rank's ``comm_stats``, ``phase_stats`` and collective
calls, its kernel records (kernel, variant, shapes, dtype, ``*_bound``)
against the CPU run's calls, and its list of aten ops outside kernels,
equal rank for rank.  For one cell per family the full-depth count equals
the reference's 1-/``n2``-trip linear extrapolation within float
rounding.

**Sanity**: a meta call of each kernel wrapper records and returns an
empty output with no card, checking its operands as the card's route
does; ``resolve_device(None)`` still raises without a card; the CLI in a
subprocess writes a record with the reference's keys and loads no JAX.
"""
import dataclasses
import itertools
import json
import os
import shutil
import subprocess
import sys
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import torch_spmd_ranks as ranks
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.launch import costing as j_costing
from repro.launch import roofline as j_rl
from repro.launch import step as j_step
from repro.launch.mesh import HW as J_HW
from repro.workloads import CongestionModel as JCongestionModel
from repro_torch.configs import SHAPES, get_config, list_archs, reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import backend, record
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import moe_gmm as gmm_mod
from repro_torch.kernels import ssd_scan as ssd_mod
from repro_torch.launch import costing
from repro_torch.launch import roofline as rl
from repro_torch.launch import step
from repro_torch.launch.mesh import HW, make_production_mesh, spawn
from repro_torch.parallel import comm
from repro_torch.parallel.comm import Mesh
from repro_torch.workloads import CongestionModel

ARCHS = tuple(list_archs())
AXES = {"dm": ("data", "model"), "pod": ("data", "model"),
        "multipod": ("pod", "data", "model")}
SHAPE_OF = {"dm": (2, 4), "pod": (16, 16), "multipod": (2, 16, 16)}
STRATEGIES = ("baseline", "fsdp")
REL = 1e-9            # float rounding of a sum over layers


def _norm(spec):
    """A spec as a tuple, 1-tuple entries as their name, trailing Nones
    dropped (the reference's PartitionSpecs may be shorter)."""
    out = [e[0] if isinstance(e, tuple) and len(e) == 1 else e
           for e in tuple(spec)]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _j_mesh(name, mesh_dm):
    return mesh_dm if name == "dm" else AbstractMesh(SHAPE_OF[name],
                                                     AXES[name])


def _dry(name, rank=0):
    return Mesh.dry(SHAPE_OF[name], AXES[name], rank)


# ---------------------------------------------------------------------------
# HW and the roofline arithmetic
# ---------------------------------------------------------------------------

def test_hw_is_the_h100_sxm_data_sheet():
    """The H100 SXM's dense rates at 700 W (NVIDIA's data sheet),
    under the reference's names."""
    assert HW.PEAK_FLOPS_BF16 == 989e12
    assert HW.HBM_BW == 3.35e12
    assert HW.HBM_BYTES == 80e9
    assert HW.SMEM_BYTES == 228 * 1024
    assert HW.NVLINK_BW == 450e9
    assert HW.ICI_BW == HW.DCN_BW == 50e9


def _reports():
    """Calibration-like reports (both packages' ``fit`` read ``family``,
    ``injected``, ``cycles``, ``mesh`` and ``meta``)."""
    rep = lambda fam, inj, cyc, **meta: types.SimpleNamespace(  # noqa: E731
        family=fam, injected=inj, cycles=cyc, mesh="8x8", meta=meta)
    return [rep("allreduce", 2048, 900, k=64), rep("allreduce", 6144, 2500,
                                                    k=64),
            rep("broadcast", 2048, 400), rep("broadcast", 6144, 1100),
            rep("moe", 640, 300, n_experts=16), rep("moe", 1920, 820,
                                                     n_experts=16),
            rep("pipeline", 512, 200, n_stages=8)]


COLLS = {"all-gather": {"bytes": 3.0e9, "count": 120, "wire_bytes": 4.2e10},
         "all-reduce": {"bytes": 1.5e8, "count": 8, "wire_bytes": 2.8e8},
         "all-to-all": {"bytes": 6.0e9, "count": 64, "wire_bytes": 5.6e9},
         "reduce-scatter": {"bytes": 2.0e10, "count": 90,
                            "wire_bytes": 1.9e10},
         "collective-permute": {"bytes": 1e6, "count": 4,
                                "wire_bytes": 1e6}}
COSTS = {"train": {"flops": 2.3e15, "bytes accessed": 1.9e13,
                   "bytes adjusted": 1.9e13},
         "decode": {"flops": 4.8e10, "bytes accessed": 9.7e9}}


@pytest.mark.parametrize("network", ["analytic", "netsim"])
@pytest.mark.parametrize("arch,shape,cost", [
    ("qwen2-72b", "train_4k", "train"), ("mixtral-8x7b", "decode_32k",
                                         "decode"),
    ("jamba-v0.1-52b", "prefill_32k", "train"),
    ("whisper-large-v3", "long_500k", "decode")])
def test_roofline_matches_reference_field_for_field(monkeypatch, network,
                                                    arch, shape, cost):
    """With the reference's constants in ``HW``, the same cost and
    collectives give the reference's report, every field."""
    for k in ("PEAK_FLOPS_BF16", "HBM_BW", "ICI_BW"):
        monkeypatch.setattr(rl.HW, k, getattr(J_HW, k))
    kw = {}
    jkw = {}
    if network == "netsim":
        kw = dict(network="netsim",
                  congestion=CongestionModel.fit(_reports()))
        jkw = dict(network="netsim",
                   congestion=JCongestionModel.fit(_reports()))
    got = rl.roofline(get_config(arch), SHAPES[shape], "pod", 256,
                      dict(COSTS[cost]), json.loads(json.dumps(COLLS)), **kw)
    want = j_rl.roofline(j_get_config(arch), J_SHAPES[shape], "pod", 256,
                         dict(COSTS[cost]), json.loads(json.dumps(COLLS)),
                         **jkw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.summary() == want.summary()


def test_model_flops_and_cells_match_for_all_40():
    """``model_flops``, ``cell_applicable`` and ``all_cells``."""
    got, want = step.all_cells(), j_step.all_cells()
    assert len(got) == len(want) == 40
    assert sum(ok for *_, ok, _w in got) == 33
    for (c, s, ok, why), (jc, js, jok, jwhy) in zip(got, want):
        assert (c.name, s.name, ok, why) == (jc.name, js.name, jok, jwhy)
        assert step.cell_applicable(c, s) == j_step.cell_applicable(jc, js)
        assert rl.model_flops(c, s) == j_rl.model_flops(jc, js)


def _record(arch, shape, bottleneck, **colls):
    rl_ = {"compute_s": 1.5e-1, "memory_adj_s": 2.5e-1, "memory_s": 3.5e-1,
           "collective_s": 4.5e-1, "bottleneck": bottleneck,
           "model_flops": 1.2e18, "useful_ratio": 0.75,
           "roofline_frac": 0.33,
           "coll_detail": {k.replace("_", "-"): {"bytes": v}
                           for k, v in colls.items()}}
    return {"arch": arch, "shape": shape, "status": "ok", "roofline": rl_}


def test_advice_and_markdown_table_match(tmp_path):
    """Every branch of ``_advice``, and the table of a directory of
    records (ok and skipped)."""
    recs = {
        "a": _record("qwen2-72b", "train_4k", "collective", all_to_all=9,
                     all_gather=3, all_reduce=2),
        "b": _record("yi-34b", "train_4k", "collective", all_gather=5,
                     all_reduce=2),
        "c": _record("yi-34b", "prefill_32k", "collective", all_gather=1,
                     all_reduce=2),
        "d": _record("mixtral-8x7b", "decode_32k", "memory"),
        "e": _record("jamba-v0.1-52b", "long_500k", "memory"),
        "f": _record("stablelm-3b", "train_4k", "memory"),
        "g": _record("qwen1.5-32b", "prefill_32k", "compute"),
        "h": {"arch": "yi-34b", "shape": "long_500k", "status": "skipped",
              "reason": "pure full-attention arch: 500k-token KV does not "
                        "fit any chip; skipped per DESIGN.md §6"},
        "i": {"arch": "yi-34b", "shape": "decode_32k", "status": "error"}}
    for name, rec in recs.items():
        (tmp_path / f"{name}.json").write_text(json.dumps(rec))
        if rec["status"] == "ok":
            assert rl._advice(rec) == j_rl._advice(rec)
    table = rl.markdown_table(tmp_path)
    assert table == j_rl.markdown_table(tmp_path)
    assert table.count("\n") == 2 + 7


@pytest.mark.parametrize("arch", ARCHS)
def test_depth_helpers_match(arch):
    """``reduced_depth_cfg``, ``scan_trips``, ``_variant_trips`` and
    ``kernel_hbm_bytes`` (every shape, pod and multipod chips)."""
    c, jc = get_config(arch), j_get_config(arch)
    assert costing.scan_trips(c) == j_costing.scan_trips(jc)
    assert costing._variant_trips(c) == j_costing._variant_trips(jc)
    for n in (1, 2, 4):
        assert dataclasses.asdict(costing.reduced_depth_cfg(c, n)) == \
            dataclasses.asdict(j_costing.reduced_depth_cfg(jc, n))
    for s, chips in itertools.product(SHAPES, (256, 512)):
        assert costing.kernel_hbm_bytes(c, SHAPES[s], chips) == \
            j_costing.kernel_hbm_bytes(jc, J_SHAPES[s], chips)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree}


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match(arch):
    """Every leaf's shape and dtype, every shape, published widths."""
    for s in SHAPES:
        got = _leaves(step.input_specs(get_config(arch), SHAPES[s]))
        want = _leaves(j_step.input_specs(j_get_config(arch), J_SHAPES[s]))
        assert set(got) == set(want), (s, set(got) ^ set(want))
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[k].shape), (s, k)
            assert str(t.dtype).replace("torch.", "") == \
                str(want[k].dtype), (s, k)


def _specs_equal(got, want, what):
    """A port layout dict (spec tuples) against the reference's
    (NamedShardings), or a nested dict of them."""
    if hasattr(want, "spec"):
        assert _norm(got) == _norm(want.spec), what
        return
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for k in got:
        _specs_equal(got[k], want[k], f"{what}/{k}")


@pytest.mark.parametrize("arch", ARCHS)
def test_cell_layouts_match_build_cell(mesh_dm, arch):
    """``build_cell`` on a dry mesh: its ``in_specs`` (parameters,
    optimizer state, batch; or cache and tokens) equal the reference
    ``build_cell``'s ``in_shardings``, on ``mesh_dm`` and on the
    production meshes, every applicable shape, baseline and fsdp; and
    ``analytic_memory`` of each cell equals the reference's."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    shapes = [s for s in SHAPES if step.cell_applicable(cfg, SHAPES[s])[0]]
    for name, s, strategy in itertools.product(("dm", "pod", "multipod"),
                                               shapes, STRATEGIES):
        jmesh = _j_mesh(name, mesh_dm)
        jcell = j_step.build_cell(jcfg, J_SHAPES[s], jmesh, strategy)
        cell = step.build_cell(cfg, SHAPES[s], _dry(name), strategy)
        what = (name, s, strategy)
        assert cell.model.device.type == "meta"
        assert len(cell.in_specs) == len(jcell.in_shardings)
        for got, want in zip(cell.in_specs, jcell.in_shardings):
            _specs_equal(got, want, what)
        chips = int(np.prod(SHAPE_OF[name]))
        got = costing.analytic_memory(cfg, SHAPES[s], cell.rules, chips)
        want = j_costing.analytic_memory(jcfg, J_SHAPES[s], jcell.rules,
                                         chips)
        assert set(got) == set(want), what
        for k in got:
            assert got[k] == pytest.approx(want[k], rel=1e-12), (what, k)


# ---------------------------------------------------------------------------
# the ring wire model against parse_collectives
# ---------------------------------------------------------------------------

REF_HLO_CALLS = [   # tests/test_roofline.py's HLO text, as comm's records
    {"op": "all_reduce_sum", "bytes": 1024 * 512 * 4, "group": 4},
    {"op": "all_gather", "bytes": 64 * 2048 * 2 // 8, "group": 8},
    {"op": "reduce_scatter", "bytes": 32 * 128 * 4 * 4, "group": 4},
    {"op": "all_to_all", "bytes": 16 * 256 * 4, "group": 2},
    {"op": "ppermute", "bytes": 8 * 8 * 4, "group": 2},
    {"op": "all_reduce_max", "bytes": 4 * 4 * 4, "group": 2}]
REF_HLO = """
HloModule test
  %x = f32[1024,512]{1,0} parameter(0)
  %ar = f32[1024,512]{1,0} all-reduce(%x), replica_groups={{0,1,2,3},{4,5,6,7}}, to_apply=%add
  %ag = bf16[64,2048]{1,0} all-gather(%y), replica_groups=[2,8]<=[16], dimensions={1}
  %rs = f32[32,128]{1,0} reduce-scatter(%z), replica_groups={{0,1,2,3}}, dimensions={0}
  %a2a = f32[16,256]{1,0} all-to-all(%w), replica_groups={{0,1}}
  %cp = f32[8,8]{1,0} collective-permute(%v), source_target_pairs={{0,1},{1,0}}
  %ars = (f32[4,4]{1,0}, f32[4,4]{1,0}) all-reduce-start(%u), replica_groups={{0,1}}
  %ard = f32[4,4]{1,0} all-reduce-done(%ars)
"""


def _hlo_of(calls):
    """HLO text with one collective a call: its result a u8 array (the
    result of an all-gather is the operand x group, of a reduce-scatter
    the operand / group) over one replica group of the call's size."""
    lines = ["HloModule dry"]
    for i, c in enumerate(calls):
        op, g, b = rl.COLLECTIVE_NAMES[c["op"]], c["group"], c["bytes"]
        res = b * g if op == "all-gather" else \
            b // g if op == "reduce-scatter" else b
        groups = "{{" + ",".join(str(r) for r in range(g)) + "}}"
        lines.append(f"  %c{i} = u8[{res}]{{0}} {op}(%p{i}), "
                     f"replica_groups={groups}")
    return "\n".join(lines)


def test_ring_wire_model_matches_parse_collectives():
    """The reference's test text, and text written from a dry training
    step's calls (every op and transpose of a reduced MoE cell), parse to
    the dict the records give."""
    assert rl.collectives_from_records(REF_HLO_CALLS) == \
        j_rl.parse_collectives(REF_HLO)
    cfg = reduced_config(get_config("moonshot-v1-16b-a3b"), num_layers=2)
    cell = step.build_cell(cfg, ShapeConfig("t", 32, 4, "train"),
                           _dry("dm", 5))
    calls = costing.count_cost(cell.run).calls
    ops = {c["op"] for c in calls}
    assert {"all_gather", "all_gather.bwd", "reduce_scatter",
            "reduce_scatter.bwd", "all_to_all", "all_to_all.bwd",
            "all_reduce_sum", "all_reduce_sum.bwd", "all_reduce_max"} <= ops
    got = rl.collectives_from_records(calls)
    want = j_rl.parse_collectives(_hlo_of(calls))
    assert set(got) == set(want)
    for op in got:
        assert got[op]["count"] == want[op]["count"]
        for k in ("bytes", "wire_bytes"):
            assert got[op][k] == pytest.approx(want[op][k], rel=1e-12)


def test_flash_bound_closed_form_equals_mask_count():
    """``kept_pairs`` (and so ``flash_bound``) equals the count of the
    masks of the plain version, under causal, window and ``kv_len``."""
    for sq, sk, causal, window, kv_len in itertools.product(
            (0, 1, 5, 16, 33), (1, 7, 16, 40), (True, False),
            (None, 1, 3, 16, 64), (None, 0, 5, 16, 100)):
        qi = torch.arange(sq)[:, None]
        kj = torch.arange(sk)[None, :]
        keep = torch.ones((sq, sk), dtype=torch.bool)
        if kv_len is not None:
            keep &= kj < kv_len
        if causal:
            keep &= kj <= qi
        if window is not None:
            keep &= kj > qi - window
        assert fa_mod.kept_pairs(sq, sk, causal, window, kv_len) == \
            int(keep.sum()), (sq, sk, causal, window, kv_len)
    q = torch.empty(2, 4, 32768, 128, device="meta", dtype=torch.bfloat16)
    k = torch.empty(2, 1, 32768, 128, device="meta", dtype=torch.bfloat16)
    n = 32768
    assert fa_mod.flash_bound(q, k, causal=True)[1] == \
        4 * 128 * 2 * 4 * n * (n + 1) // 2


# ---------------------------------------------------------------------------
# against real runs: 8 gloo ranks and their dry meshes
# ---------------------------------------------------------------------------

B, S = 4, 32
RANK_CASES = {
    "qwen2 train": ("qwen2-72b", "train", {}),
    "moonshot train xy": ("moonshot-v1-16b-a3b", "train", {"dispatch": "xy"}),
    "jamba prefill": ("jamba-v0.1-52b", "prefill", {}),
    "mamba2 decode": ("mamba2-370m", "decode", {}),
}


def _rank_cases():
    rng = np.random.default_rng(0)
    tok = lambda shape: rng.integers(0, 512, shape).astype(np.int32)  # noqa
    out = []
    for name, (arch, kind, overrides) in RANK_CASES.items():
        cfg = reduced_config(get_config(arch), dtype="bfloat16")
        if kind == "train":
            arrays = {"tokens": tok((B, S)), "labels": tok((B, S)),
                      "mask": np.ones((B, S), np.float32)}
        elif kind == "prefill":
            arrays = {"tokens": tok((B, S))}
        else:
            arrays = {"tokens": tok((B,))}
        out.append((name, cfg, ShapeConfig(kind, S, B, kind), "baseline",
                    overrides, arrays))
    return out


@pytest.fixture(scope="module")
def rank_runs():
    """Every case's real and dry counts, rank by rank (one spawn of 8
    ranks, in a thread)."""
    with ThreadPoolExecutor(1) as pool:
        run = pool.submit(spawn, ranks.costing_cells, 8, "gloo",
                          args=(_rank_cases(),), timeout=600)
        return run.result()


def test_ranks_import_nothing_of_jax_or_repro(rank_runs):
    assert all(r["modules"] == [] for r in rank_runs)


@pytest.mark.parametrize("name", list(RANK_CASES))
def test_dry_mesh_collectives_match_gloo_ranks(rank_runs, name):
    """Each rank's collectives by op and by phase (calls and bytes), and
    its calls one by one (dtype and group size), on the dry mesh equal
    the real step's on 8 gloo ranks."""
    for r, out in enumerate(rank_runs):
        real, dry = out[name]["real"], out[name]["dry"]
        assert real["comm"], (name, r)
        assert dry["comm"] == real["comm"], (name, r)
        assert dry["phases"] == real["phases"], (name, r)
        assert dry["calls"] == real["calls"], (name, r)
    if RANK_CASES[name][1] == "train":
        assert set(rank_runs[0][name]["real"]["phases"]) == \
            {"loss", "backward", "optimizer"}


def test_no_call_list_kept_outside_a_count(rank_runs):
    """A real step outside ``count_cost`` counts its collectives in the
    fixed-size aggregates only: no call list is left open to grow, and
    the lists handed out by the counts hold their own calls and no
    later ones."""
    first = next(iter(RANK_CASES))
    for r, out in enumerate(rank_runs):
        assert out["after"]["calls"] > 0, r
        assert out["after"]["open_lists"] == 0, r
        real = out[first]["real"]
        assert len(real["calls"]) == sum(v["calls"]
                                         for v in real["comm"].values()), r


@pytest.mark.parametrize("name", list(RANK_CASES))
def test_meta_kernel_records_match_cpu_calls(rank_runs, name):
    """The meta run's kernel records (kernel, variant, shapes, dtype,
    bytes and FLOPs of its ``*_bound``) equal the CPU run's calls."""
    kinds = {"qwen2 train": {"flash_attention"},
             "moonshot train xy": {"flash_attention", "moe_gmm"},
             "jamba prefill": {"flash_attention", "ssd_scan", "moe_gmm"},
             "mamba2 decode": set()}[name]
    for r, out in enumerate(rank_runs):
        real, dry = out[name]["real"], out[name]["dry"]
        assert dry["records"] == real["records"], (name, r)
        assert {x["kernel"] for x in real["records"]} == kinds


@pytest.mark.parametrize("name", list(RANK_CASES))
def test_meta_aten_ops_match_cpu_run(rank_runs, name):
    """The aten ops outside kernels and collectives (name and output
    shapes), one list, and so the counted FLOPs and bytes."""
    for r, out in enumerate(rank_runs):
        real, dry = out[name]["real"], out[name]["dry"]
        assert len(real["ops"]) > 100
        assert dry["ops"] == real["ops"], (name, r)
        assert dry["cost"] == real["cost"], (name, r)


FAMILY_CELLS = {      # arch, kind, layers giving 6 trips (n2 = 4)
    "dense": ("stablelm-3b", "train", dict(num_layers=6)),
    "moe": ("mixtral-8x7b", "train", dict(num_layers=6)),
    "vlm": ("qwen2-vl-72b", "prefill", dict(num_layers=6)),
    "hybrid": ("jamba-v0.1-52b", "train", dict(num_layers=12)),
    "ssm": ("mamba2-370m", "train", dict(num_layers=6)),
    "audio": ("whisper-large-v3", "prefill", dict(num_layers=6)),
}


@pytest.mark.parametrize("family", list(FAMILY_CELLS))
def test_full_depth_count_equals_extrapolation(family):
    """The port counts every layer of a full-depth run; the reference
    extrapolates from 1 and ``n2`` trips.  On a dry (2, 4) mesh the two
    agree: every cost key and every collective's bytes, count and wire
    bytes."""
    arch, kind, kw = FAMILY_CELLS[family]
    cfg = reduced_config(get_config(arch), dtype="bfloat16", **kw)
    if cfg.encdec is not None:
        cfg = dataclasses.replace(cfg, encdec=dataclasses.replace(
            cfg.encdec, encoder_layers=costing.scan_trips(cfg)))
    shape = ShapeConfig(kind, S, B, kind)
    trips, n2 = costing.scan_trips(cfg), costing._variant_trips(cfg)
    assert (trips, n2) == (6, 4)

    def count(c):
        return costing.measure_cell_cost(c, shape, _dry("dm", 6))

    (c1, k1), (c2, k2), (full, kfull) = (
        count(costing.reduced_depth_cfg(cfg, n)) for n in (1, n2, trips))

    def extra(v1, v2):
        return v1 + (trips - 1) * (v2 - v1) / (n2 - 1)

    for k in full:
        assert full[k] == pytest.approx(extra(c1[k], c2[k]), rel=REL), k
    assert full["flops kernels"] > 0 and full["bytes kernels"] > 0
    assert set(kfull) == set(k1) == set(k2)
    for op in kfull:
        for k in ("bytes", "count", "wire_bytes"):
            assert kfull[op][k] == pytest.approx(
                extra(k1[op][k], k2[op][k]), rel=REL), (op, k)


# ---------------------------------------------------------------------------
# sanity: the meta route, the device policy, the CLI
# ---------------------------------------------------------------------------

def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_meta_wrappers_record_and_launch_nothing():
    """Without a card, each wrapper on meta tensors returns an empty meta
    output of the kernel's shape, launches nothing and records the call
    with the variant the card would choose; it checks its operands as on
    the card."""
    launches = (fa_mod.flash_attention.launches, ssd_mod.ssd_scan.launches,
                gmm_mod.grouped_matmul.launches)
    with record.recording() as recs:
        o = fa_mod.flash_attention(_meta(1, 8, 64, 128), _meta(1, 2, 64, 128),
                                   _meta(1, 2, 64, 128), window=16)
        y = ssd_mod.ssd_scan(_meta(1, 8, 512, 64), _meta(1, 8, 512),
                             _meta(1, 1, 512, 128), _meta(1, 1, 512, 128),
                             _meta(8, dtype=torch.float32), chunk=256)
        g = gmm_mod.grouped_matmul(_meta(4, 32, 256, dtype=torch.float32),
                                   _meta(4, 256, 512, dtype=torch.float32))
        d = gmm_mod.grouped_matmul(_meta(4, 32, 256), _meta(4, 256, 512))
    assert (fa_mod.flash_attention.launches, ssd_mod.ssd_scan.launches,
            gmm_mod.grouped_matmul.launches) == launches
    assert [tuple(t.shape) for t in (o, y, g, d)] == [
        (1, 8, 64, 128), (1, 8, 512, 64), (4, 32, 512), (4, 32, 512)]
    assert all(t.device.type == "meta" for t in (o, y, g, d))
    assert [(r["kernel"], r["variant"]) for r in recs] == [
        ("flash_attention", "wgmma_tma"), ("ssd_scan", "tensor_core"),
        ("moe_gmm", "f32"), ("moe_gmm", "decode")]
    q, kk = _meta(1, 8, 64, 128), _meta(1, 2, 64, 128)
    assert (recs[0]["bytes"], recs[0]["flops"]) == fa_mod.flash_bound(
        q, kk, True, 16)
    assert recs[1]["chunk"] == 256
    with pytest.raises(ValueError, match="contiguous"):
        fa_mod.flash_attention(q.transpose(2, 3), kk, kk)
    with pytest.raises(ValueError, match="K \\| H"):
        fa_mod.flash_attention(_meta(1, 3, 64, 128), kk, kk)
    with pytest.raises(ValueError, match="chunk"):
        ssd_mod.ssd_scan(_meta(1, 8, 512, 64), _meta(1, 8, 512),
                         _meta(1, 1, 512, 128), _meta(1, 1, 512, 128),
                         _meta(8, dtype=torch.float32), chunk=512)
    with pytest.raises(ValueError, match="rhs"):
        gmm_mod.grouped_matmul(_meta(4, 32, 256), _meta(4, 128, 512))


def test_swiglu_records_equal_on_meta_and_cpu(monkeypatch):
    """The fused gate/up call records alike on ``meta`` (nothing runs) and
    on the CPU (the plain chain runs): kernel ``moe_gmm``, variant
    ``tma_swiglu``, its three operands and its bound; nothing launches.
    With no recorder open it computes no bound."""
    e, m, k, n = 4, 72, 128, 256
    for dev in ("cpu", "meta"):
        with monkeypatch.context() as mp:
            mp.setattr(gmm_mod, "swiglu_bound", None)
            w = torch.zeros(e, k, n, dtype=torch.bfloat16, device=dev)
            gmm_mod.grouped_swiglu(torch.zeros(e, m, k, dtype=torch.bfloat16,
                                               device=dev), w, w)
    launches = gmm_mod.grouped_matmul.launches
    got = {}
    for dev in ("cpu", "meta"):
        def t(*shape):
            return torch.zeros(shape, dtype=torch.bfloat16, device=dev)
        with record.recording() as recs:
            out = gmm_mod.grouped_swiglu(t(e, m, k), t(e, k, n), t(e, k, n))
        assert out.shape == (e, m, n) and out.device.type == dev
        got[dev] = recs
    assert got["meta"] == got["cpu"] == [{
        "kernel": "moe_gmm", "variant": "tma_swiglu",
        "shapes": ((e, m, k), (e, k, n), (e, k, n)), "dtype": "bfloat16",
        "bytes": 2 * (e * m * k + 2 * e * k * n + e * m * n),
        "flops": 2 * 2 * e * m * k * n}]
    assert gmm_mod.grouped_matmul.launches == launches


def test_no_record_built_without_a_recorder(monkeypatch):
    """With no recorder open (every serve or train call outside the
    costing tools), a wrapper on CPU or meta tensors neither chooses a
    variant for a record nor computes its bound."""
    def boom(*a, **k):
        raise AssertionError("built a record with no recorder open")
    for mod, name in ((fa_mod, "flash_bound"), (fa_mod, "flash_variant"),
                      (ssd_mod, "ssd_bound"), (ssd_mod, "_record"),
                      (gmm_mod, "gmm_bound"), (gmm_mod, "gmm_plan")):
        monkeypatch.setattr(mod, name, boom)
    assert not record.active()
    g = torch.Generator().manual_seed(0)
    for dev in ("cpu", "meta"):
        t = lambda *s, dtype=torch.float32: torch.randn(  # noqa: E731
            *s, generator=g, dtype=dtype).to(dev)
        fa_mod.flash_attention(t(1, 2, 8, 8), t(1, 1, 8, 8), t(1, 1, 8, 8))
        ssd_mod.ssd_scan(t(1, 2, 8, 4), t(1, 2, 8), t(1, 1, 8, 4),
                         t(1, 1, 8, 4), t(2), chunk=8)
        gmm_mod.grouped_matmul(t(2, 4, 8), t(2, 8, 4))


def test_meta_only_when_named():
    """``None`` still means the card (and raises without one); ``meta`` is
    the caller's explicit choice; a real mesh never turns dry."""
    assert backend.resolve_device("meta") == torch.device("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            backend.resolve_device(None)
    assert Mesh.is_dry is False
    dry = make_production_mesh(multi_pod=True, dry=True, rank=300)
    assert dry.is_dry and dry.device.type == "meta" and dry.rank == 300
    assert dry.index(("pod", "data", "model")) == 300
    with pytest.raises(RuntimeError, match="no process groups"):
        dry.group("model")
    comm.reset_comm_stats()
    with comm.listing_calls() as calls:
        out = comm.all_gather(_meta(3, 5), dry, ("data", "model"), 1)
    assert tuple(out.shape) == (3, 5 * 256)
    assert calls == [{"op": "all_gather", "dtype": "bfloat16", "bytes": 30,
                      "group": 256, "phase": None}]
    for _ in range(3):
        comm.all_gather(_meta(3, 5), dry, ("data", "model"), 1)
    assert len(calls) == 1 and not comm._LISTS
    assert comm.comm_stats()["all_gather"]["calls"] == 4


def test_dryrun_cli_writes_a_record_with_the_reference_keys():
    """``python -m repro_torch.launch.dryrun --arch stablelm-3b --shape
    train_4k --mesh pod`` in a fresh interpreter: status ok, the
    reference's keys, ``useful_ratio`` in (0, 1] at full depth, no JAX
    loaded."""
    from repro_torch.launch import dryrun
    tag = f"test{os.getpid()}"
    out_dir = dryrun.OUT_ROOT / f"pod-{tag}"
    code = (
        "import runpy, sys\n"
        "sys.argv = ['dryrun', '--arch', 'stablelm-3b', '--shape', "
        f"'train_4k', '--mesh', 'pod', '--tag', '{tag}']\n"
        "try:\n"
        "    runpy.run_module('repro_torch.launch.dryrun', "
        "run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert not e.code, e.code\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith("
        "('jax.', 'jaxlib')) or n == 'repro' or n.startswith('repro.')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(Path(__file__).resolve().parents[1] / "src")]
        + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    try:
        run = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, timeout=300)
        assert run.returncode == 0, run.stderr[-3000:]
        assert "1 ok, 0 skipped, 0 failed" in run.stdout
        rec = json.loads((out_dir / "stablelm-3b__train_4k.json").read_text())
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    assert {"arch", "shape", "mesh", "strategy", "chips", "status", "memory",
            "memory_analytic", "cost", "roofline"} <= set(rec)
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["memory"] is None
    assert set(rec["roofline"]) == set(
        f.name for f in dataclasses.fields(j_rl.RooflineReport))
    assert {"flops", "bytes accessed", "bytes adjusted"} <= set(rec["cost"])
    assert 0 < rec["roofline"]["useful_ratio"] <= 1
