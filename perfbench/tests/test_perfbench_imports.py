"""A run's set-up and window on the CPU at a tiny size load neither JAX
nor the JAX package; a configuration, traffic mixes (a batched one for
the replay driver, and one with a driver of its own) and a per-layer
metric are found as new files and entries, with no other edit; each
configuration file states every change it makes to the port's preset."""
import dataclasses
import json
import shutil
import subprocess
import sys

import pytest

from perfbench.harness import spec

from .tiny import LENGTHS, SIZES

RUN_TINY = r"""
import json, sys, time
t = time.perf_counter()
sys.path[:0] = [sys.argv[1] + "/src", sys.argv[1]]
sys.path.insert(0, sys.argv[1] + "/perfbench/tests")
from perfbench.harness import cell, spec
import tiny
name = "jamba_v01_16L.prefill_long"
c = spec.workload(spec.benchmark(), name)
r = cell.run(name, 2**33 + 5, 0.2, False, "cpu", t,
             conf=tiny.conf(c["config"]), traffic=tiny.traffic(c["traffic"]),
             limits={"sample": 2, "numbers": {"max_gap": {"limit": 1e-3}}})
print(json.dumps({"correct": r["correct"],
                  "modules": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def test_tiny_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", RUN_TINY, str(spec.ROOT)],
                         capture_output=True, text=True, timeout=600,
                         check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"] is True
    assert "repro_torch" in got["modules"]
    assert not {"jax", "jaxlib", "flax", "repro"} & set(got["modules"])


# a driver of its own: one step a cycle, ``batch`` requests of ``length``
DRIVER = """
import time
import numpy as np
import torch
from perfbench.harness import traffic as tr
from perfbench.harness.window import Served


def cycles(traffic, seed, vocab, stream):
    g, rid, n, b = tr.rng(seed, stream), 0, traffic["length"], \
        traffic["batch"]
    while True:
        yield [[tr.Request(rid + i, n, g.integers(0, vocab, n))
                for i in range(b)]]
        rid += b


def step(model, reqs, device):
    from repro_torch.launch.step import prefill_step
    t0 = time.perf_counter()
    tokens = torch.from_numpy(np.stack([r.tokens for r in reqs])).to(device)
    logits = prefill_step(model, {"tokens": tokens})
    t1 = time.perf_counter()
    first = logits.argmax(-1).tolist()
    return [Served(r, t0, t1, time.perf_counter(), t, row)
            for r, t, row in zip(reqs, first, logits)]
"""


def test_new_cells_are_found_from_files_alone(tmp_path):
    """In a copy of the benchmark, a new configuration, two traffic mixes
    (batches of 4 for the replay driver; a new driver's fixed batch of
    3), their limits and a per-layer metric are new files plus new
    entries in BENCHMARK.json; traced runs of the new cells find every
    one."""
    from perfbench.harness import cell
    shutil.copytree(spec.BENCH, tmp_path / "perfbench")
    new = tmp_path / "perfbench"
    bench = spec.benchmark()
    conf = {**spec.part("configs", "jamba_v01_16L"), **SIZES,
            "preset_changes": {}}
    (new / "configs/tiny_jamba.json").write_text(json.dumps(conf))
    (new / "traffic/batched_short.json").write_text(json.dumps(
        {"driver": "prefill_replay", "batch": 4, "lengths": LENGTHS}))
    (new / "drivers/fixed_batch.py").write_text(DRIVER)
    (new / "traffic/fixed_batch_40.json").write_text(json.dumps(
        {"driver": "fixed_batch", "batch": 3, "length": 40}))
    (new / "metrics/served_requests.py").write_text(
        "def read(ctx):\n    return float(len(ctx.served))\n")
    bench["configs"].append({"name": "tiny_jamba", "source": "test",
                             "file": "perfbench/configs/tiny_jamba.json",
                             "reduced": [], "why": "test"})
    cells = {"tiny_jamba.batched_short": 4, "tiny_jamba.fixed_batch_40": 3}
    for name in cells:
        bench["workloads"].append({"name": name, "config": "tiny_jamba",
                                   "traffic": name.split(".")[1],
                                   "chips": 1, "why": "test"})
        (new / f"limits/{name}.json").write_text(json.dumps(
            {"sample": 5, "numbers": {"max_gap": {"limit": 1e-3}}}))
    bench["per_layer"].append({"name": "served_requests", "unit": "1",
                               "better": "higher", "source": "host_clock",
                               "layer": "serving step",
                               "moves": "tokens_per_s",
                               "workloads": list(cells)})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for name, batch in cells.items():
        r = cell.run(name, 9, 0.1, True, "cpu", 0.0,
                     bench=spec.benchmark(tmp_path), bench_dir=new)
        assert r["correct"] is True
        assert r["metrics"]["served_requests"]["value"] == r["attempted"]
        assert r["attempted"] >= batch and r["attempted"] % batch == 0


@pytest.mark.parametrize("config", ["jamba_v01_16L", "mixtral_8x7b_16L"])
def test_config_states_its_changes_to_the_preset(config):
    """The fields in which the file departs from the port's preset are
    exactly those its ``preset_changes`` names, each with the preset's
    value."""
    from repro_torch.configs import get_config
    conf = spec.part("configs", config)
    preset = dataclasses.asdict(get_config(conf["registry"]))
    run = dataclasses.asdict(spec.port_config(conf))
    changed = {k for k in preset if preset[k] != run[k]}
    assert changed == set(conf["preset_changes"])
    for k, v in conf["preset_changes"].items():
        assert v["preset"] == preset[k]
