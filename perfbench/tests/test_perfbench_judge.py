"""``correct`` comes out false for what it must refuse, at a size a test
run holds, with each cell's committed limits: a run whose timed path
alters its answers where they are produced, on every request or on the
longest requests alone (a one-chip, one-request prefill keeps no state
across steps, has no batch to halve and no exchange between chips, so
that is the fault of the four it can have), and the control, the plain
reference in fp8 put in the program's place.  A sound run comes out
true."""
import pytest
import torch

import repro_torch.launch.step as step_mod
from perfbench.harness import cell, judge, spec, traffic as tr, weights
from perfbench.harness.window import Served

from . import tiny

CELLS = ["jamba_v01_16L.prefill_long", "mixtral_8x7b_16L.prefill_long"]


def _run(name, seed, dtype="float32"):
    c = spec.workload(spec.benchmark(), name)
    return cell.run(name, seed, 0.2, False, "cpu", 0.0,
                    conf=tiny.conf(c["config"], dtype=dtype),
                    traffic=tiny.traffic(c["traffic"]))


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    assert _run(name, 2**32 + 11)["correct"] is True


@pytest.mark.parametrize("longest_only", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_altered_answers_are_not_correct(name, longest_only, monkeypatch):
    """The answers altered on every request, or only on the requests of
    the mix's longest length (one in each cycle, the sample's first)."""
    real = step_mod.prefill_step
    longest = max(tr.lengths(tiny.traffic(
        spec.workload(spec.benchmark(), name)["traffic"])))

    def altered(model, batch, rules=None):
        logits = real(model, batch, rules)
        if longest_only and batch["tokens"].shape[1] < longest:
            return logits
        return logits.roll(logits.shape[-1] // 2, dims=-1)

    monkeypatch.setattr(step_mod, "prefill_step", altered)
    r = _run(name, 2**32 + 12)
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


@pytest.mark.parametrize("name", CELLS)
def test_fp8_control_is_not_correct(name):
    """The control over one cycle of the tiny mix, on three seeds, is
    refused by the cell's limits on every one."""
    c = spec.workload(spec.benchmark(), name)
    conf = tiny.conf(c["config"], num_layers=8, d_model=512, vocab_size=4096)
    traffic = tiny.traffic(c["traffic"])
    limits = spec.part("limits", name)
    cfg = spec.port_config(conf)
    from repro_torch.models import get_model
    cls = get_model(cfg)
    ref = spec.reference(conf)
    drv = spec.driver(traffic)
    for seed in (1, 2, 3):
        params = weights.draw(cls.param_table(cfg),
                              lambda n: cls.param_dtype(cfg, n), seed, "cpu",
                              cfg.num_layers)
        steps = next(drv.cycles(traffic, seed, cfg.vocab_size, tr.WINDOW))
        # the program's side is not read here: a placeholder answer
        chosen = [Served(r, 0.0, 0.0, 0.0, 0, torch.zeros(cfg.vocab_size))
                  for st in steps for r in st]
        rows = judge.readings(conf, ref, params, chosen, "cpu",
                              limits["paths"], control=True)
        ok, checks = judge.decide(rows, limits, side="control")
        assert not ok, checks
