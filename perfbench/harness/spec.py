"""Finding a cell's parts by name.

* ``BENCHMARK.json``: the cell (``workloads``), its metrics
  (``end_to_end`` and ``per_layer``);
* ``perfbench/configs/<config>.json``: the model's sizes as they run (the
  port's ``ModelConfig`` fields), its registry name in the port, its
  plain reference (``perfbench/reference/<reference>.py``) and its cut;
* ``perfbench/traffic/<traffic>.json``: the traffic mix's parameters and
  the driver it names, ``perfbench/drivers/<driver>.py``, which makes its
  requests and runs its steps;
* ``perfbench/limits/<cell>.json``: what ``correct`` compares, with each
  limit and the readings it was set from;
* ``perfbench/metrics/<metric>.py``: one reader per metric.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def read_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> Dict:
    return read_json(root / "BENCHMARK.json")


def workload(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in bench['workloads']]}")


def part(kind: str, name: str, bench_dir: Path = BENCH) -> Dict:
    """``perfbench/<kind>/<name>.json``."""
    return read_json(bench_dir / kind / f"{name}.json")


def metrics(bench: Dict, cell: Dict, trace: bool) -> List[Dict]:
    """The metrics a run of ``cell`` reports: its ``end_to_end`` metrics
    without the trace, its ``per_layer`` ones with it.  A metric with a
    ``workloads`` list belongs to those cells; a per-layer metric without
    one to every cell that reports the end-to-end metric it moves."""
    def mine(m, reported=()):
        if "workloads" in m:
            return cell["name"] in m["workloads"]
        return not reported or m["moves"] in reported
    e2e = [m for m in bench["end_to_end"] if mine(m)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"] if mine(m, names)]


def load_file(path: Path) -> ModuleType:
    """The module in ``path`` (its file name may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "perfbench_file_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, bench_dir: Path = BENCH) -> ModuleType:
    return load_file(bench_dir / "metrics" / f"{name}.py")


def driver(traffic: Dict, bench_dir: Path = BENCH) -> ModuleType:
    return load_file(bench_dir / "drivers" / f"{traffic['driver']}.py")


def reference(conf: Dict) -> ModuleType:
    """The plain reference module of a configuration,
    ``perfbench/reference/<reference>.py``."""
    return importlib.import_module(f"perfbench.reference.{conf['reference']}")


def port_config(conf: Dict):
    """The port's ``ModelConfig`` of a configuration file: its registry
    preset with every field the file gives replaced by the file's (the
    file's ``source`` is its URL, not the preset's citation tag)."""
    from repro_torch.configs import MoEConfig, SSMConfig, get_config
    preset = get_config(conf["registry"])
    fields = {f.name for f in dataclasses.fields(preset)} - {"source"}
    given = {k: v for k, v in conf.items() if k in fields}
    if given.get("moe") is not None:
        given["moe"] = MoEConfig(**given["moe"])
    if given.get("ssm") is not None:
        given["ssm"] = SSMConfig(**given["ssm"])
    return dataclasses.replace(preset, **given)
