"""The port's ``Trainer`` on a mesh against the JAX package on the CPU: 8
gloo ranks (data 2, model 4), ``test_runtime.py``'s small stablelm-3b
(2 layers, d_model 64, vocabulary 128) on ``synthetic_batch``, strategy
``baseline`` (ZeRO-1 over ``data``, full remat).

* its losses over 6 steps against the reference ``Trainer`` on
  ``mesh_dm`` from the same weights (1e-4 relative, the bar of
  ``tests/test_torch_runtime.py``'s single-card comparison);
* faults: one at step 2 on every rank, and one at step 1 on rank 0
  only: every rank records the failure and retries in lockstep (no
  hang), and the losses equal the unfaulted run's bit for bit;
* resume: step 3's checkpoint resumed on the same mesh runs to the same
  parameters and optimizer state as the uninterrupted run, bit for bit;
* checkpoints across layouts: one written on the mesh restores in the
  single-card ``Trainer`` and in the reference's
  ``repro.checkpoint.restore`` (every leaf equal to the mesh's gathered
  state), and one written on one card restores on the mesh;
* ``python -m repro_torch.launch.train --reduced --device cpu --devices 8
  --mesh-shape 2,4 --strategy fsdp`` runs and resumes;
* ``Trainer.reshard``: the reference's ``test_elastic_reshard`` ((2, 4)
  -> (1, 4) after 2 steps, then 2 more) and the grow case ((1, 4) -> (2,
  4)), the smaller mesh on ranks 0-3 and the other four idle there: the
  losses against the reference ``Trainer`` doing the same (1e-4
  relative), the events equal, and the checkpoint written after the
  move restored on the new mesh (bit for bit) and on one card.

One spawn runs the mesh scenarios (``torch_spmd_ranks.spmd_trainers``),
in a thread while the reference trains.
"""
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest

import torch_spmd_ranks as ranks
from repro import checkpoint as j_ckpt
from repro import optim as j_optim
from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.compat import make_auto_device_mesh
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data import pipeline as j_pipeline
from repro.models.api import get_model as j_get_model
from repro.runtime import Trainer as JTrainer
from repro.runtime import TrainerConfig as JTrainerConfig
from repro_torch import checkpoint as ckpt
from repro_torch import optim
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import pipeline
from repro_torch.launch.mesh import spawn
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime import Trainer, TrainerConfig

SHAPE = ShapeConfig("t", seq_len=32, global_batch=8, kind="train")
JSHAPE = JShapeConfig("t", seq_len=32, global_batch=8, kind="train")
OPT = dict(lr_peak=3e-3, warmup_steps=2, total_steps=20)
SMALL = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=2,
             head_dim=32, d_ff=128, vocab_size=128)


def _single(tmp_path, p0, steps):
    """The single-card port ``Trainer`` from ``p0``, ``steps`` steps,
    checkpoints every 3 under ``tmp_path / "one card"``."""
    cfg = reduced_config(get_config("stablelm-3b"), **SMALL)
    tr = Trainer(cfg, SHAPE, optim.OptConfig(**OPT), TrainerConfig(
        total_steps=steps, ckpt_every=3,
        ckpt_dir=str(tmp_path / "one card"), log_every=100), device="cpu")
    tr.init(params=params_from_jax(cfg, p0, "cpu"))
    tr.run(pipeline.batch_iterator(cfg, SHAPE))
    tr.close()
    return tr


@pytest.fixture(scope="module")
def runs(mesh_dm, tmp_path_factory):
    """(the reference Trainer's losses, the single-card port Trainer that
    wrote a checkpoint, the ranks' results, the directories)."""
    tmp = tmp_path_factory.mktemp("mesh_trainer")
    jcfg = j_reduced_config(j_get_config("stablelm-3b"), **SMALL)
    tcfg = reduced_config(get_config("stablelm-3b"), **SMALL)
    jtr = JTrainer(jcfg, JSHAPE, mesh_dm, j_optim.OptConfig(**OPT),
                   JTrainerConfig(total_steps=6, ckpt_every=3,
                                  log_every=100, ckpt_dir=str(tmp / "jck")))
    jtr.init()
    p0 = {k: np.asarray(v) for k, v in jtr.params.items()}
    single = _single(tmp, p0, 3)
    dirs = {k: str(tmp / k) for k in ("run", "resume", "one card",
                                      "elastic")}
    with ThreadPoolExecutor(1) as pool:
        mesh_run = pool.submit(spawn, ranks.spmd_trainers, 8, "gloo",
                               args=(tcfg, p0, OPT, dirs))
        want = []
        jtr.run(j_pipeline.batch_iterator(jcfg, JSHAPE),
                on_step=lambda s, m: want.append(float(m["loss"])))
        jtr.close()
        small = make_auto_device_mesh(
            np.array(jax.devices()[:4]).reshape(1, 4), ("data", "model"))
        elastic = {case: _j_elastic(jcfg, a, b, tmp / f"j{case}")
                   for case, (a, b) in (("shrink", (mesh_dm, small)),
                                        ("grow", (small, mesh_dm)))}
        results = mesh_run.result()
    return want, single, results, dirs, tcfg, elastic


def _j_elastic(jcfg, mesh_a, mesh_b, ckpt_dir):
    """The reference's ``test_elastic_reshard`` from ``mesh_a`` to
    ``mesh_b``: (its 4 losses, its events)."""
    tr = JTrainer(jcfg, JSHAPE, mesh_a, j_optim.OptConfig(**OPT),
                  JTrainerConfig(total_steps=2, ckpt_every=3, log_every=100,
                                 ckpt_dir=str(ckpt_dir)))
    tr.init()
    it = j_pipeline.batch_iterator(jcfg, JSHAPE)
    losses = []
    tr.run(it, on_step=lambda s, m: losses.append(float(m["loss"])))
    tr.reshard(mesh_b)
    tr.tcfg.total_steps = 4
    tr.run(it, on_step=lambda s, m: losses.append(float(m["loss"])))
    tr.close()
    return losses, tr.events


def test_mesh_trainer_losses_match_the_reference_trainer(runs):
    want, _single_tr, results, _dirs, _cfg, _elastic = runs
    for rank, res in enumerate(results):
        got = res["run"][0]
        assert len(got) == len(want) == 6
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   err_msg=f"rank {rank}")
    assert np.mean(want[-3:]) < np.mean(want[:3])


@pytest.mark.parametrize("scenario,step", [("fault every rank", 2),
                                           ("fault rank 0", 1)])
def test_faults_are_retried_in_lockstep(runs, scenario, step):
    _want, _single_tr, results, _dirs, _cfg, _elastic = runs
    for rank, res in enumerate(results):
        losses, events = res[scenario]
        failures = [e for e in events if e["kind"] == "step_failure"]
        assert [e["step"] for e in failures] == [step], (rank, events)
        if scenario == "fault rank 0" and rank:
            assert "another rank" in failures[0]["error"]
        assert losses == res["run"][0][:4]


def test_resume_on_the_mesh_is_bit_for_bit(runs):
    _want, _single_tr, results, _dirs, _cfg, _elastic = runs
    step, losses, (params, state) = results[0]["resume"]
    assert step == 3
    assert losses == results[0]["run"][0][3:]
    run_params, run_state = results[0]["run"][2]
    for k, v in run_params.items():
        np.testing.assert_array_equal(params[k], v, err_msg=k)
        for q in ("master", "m", "v"):
            np.testing.assert_array_equal(state[q][k], run_state[q][k],
                                          err_msg=f"{q} {k}")
    assert all(r["resume"][0] == 3 for r in results)


def test_mesh_checkpoint_restores_on_one_card_and_in_the_reference(runs):
    _want, _single_tr, results, dirs, cfg, _elastic = runs
    params, state = results[0]["run"][2]
    assert ckpt.latest_step(dirs["run"]) == 6
    tr = Trainer(cfg, SHAPE, optim.OptConfig(**OPT), TrainerConfig(
        total_steps=9, ckpt_dir=dirs["run"]), device="cpu")
    tr.resume_or_init()
    assert tr.step == 6 and int(tr.opt_state["step"]) == 6
    for k, p in tr.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), params[k],
                                      err_msg=k)
        for q in ("master", "m", "v"):
            np.testing.assert_array_equal(tr.opt_state[q][k].numpy(),
                                          state[q][k], err_msg=f"{q} {k}")
    tr.close()
    jcfg = j_reduced_config(j_get_config("stablelm-3b"), **SMALL)
    p_shapes = j_get_model(jcfg).param_shapes(jcfg)
    tree, step, _ = j_ckpt.restore(
        dirs["run"], {"params": p_shapes,
                      "opt": j_optim.state_shapes(p_shapes)})
    assert step == 6
    for k, v in params.items():
        np.testing.assert_array_equal(np.asarray(tree["params"][k]), v,
                                      err_msg=k)
        np.testing.assert_array_equal(np.asarray(tree["opt"]["m"][k]),
                                      state["m"][k], err_msg=k)


def test_one_card_checkpoint_restores_on_the_mesh(runs):
    _want, single, results, _dirs, _cfg, _elastic = runs
    for res in results:
        assert res["from one card"][0] == 3
    params, state = results[0]["from one card"][1]
    for k, p in single.model.named_parameters():
        np.testing.assert_array_equal(params[k], p.detach().numpy(),
                                      err_msg=k)
        for q in ("master", "m", "v"):
            np.testing.assert_array_equal(state[q][k],
                                          single.opt_state[q][k].numpy(),
                                          err_msg=f"{q} {k}")


def test_trainer_ranks_import_nothing_of_jax_or_repro(runs):
    assert all(r["modules"] == [] for r in runs[2])


def test_mesh_train_launcher_runs_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train
    args = ["--arch", "qwen2-72b", "--reduced", "--device", "cpu",
            "--devices", "8", "--mesh-shape", "2,4", "--strategy", "fsdp",
            "--seq-len", "32", "--batch", "4", "--ckpt-every", "2",
            "--ckpt-dir", str(tmp_path / "ck")]
    final = train.main(args + ["--steps", "2"])
    assert set(final) == {"loss", "ce", "moe_aux", "grad_norm", "lr"}
    assert np.isfinite(list(final.values())).all()
    assert ckpt.latest_step(tmp_path / "ck") == 2
    train.main(args + ["--steps", "3", "--resume"])
    assert "'kind': 'resume', 'step': 2" in capsys.readouterr().out
    assert ckpt.latest_step(tmp_path / "ck") == 3


@pytest.mark.parametrize("case", ["shrink", "grow"])
def test_elastic_reshard_matches_the_reference(runs, case):
    """Scale down from (2,4) to (1,4), or up: the same losses as the
    reference's ``Trainer.reshard``, the same events; the ranks outside
    the smaller mesh idle there (no step, no state)."""
    *_rest, elastic = runs
    want, want_events = elastic[case]
    assert len(want) == 4
    results = runs[2]
    for rank, res in enumerate(results):
        losses, events, _state, active, _resumed = res[case]
        small_first = case == "grow"
        in_small = rank < 4
        assert active == ([in_small, True] if small_first
                          else [True, in_small]), (rank, active)
        expect = want if in_small else (want[2:] if small_first
                                        else want[:2])
        np.testing.assert_allclose(losses, expect, rtol=1e-4,
                                   err_msg=f"{case} rank {rank}")
        assert events == want_events, (rank, events, want_events)
    assert [e["kind"] for e in want_events] == ["reshard"]
    assert want_events[0]["from_chips"] == (8 if case == "shrink" else 4)


@pytest.mark.parametrize("case", ["shrink", "grow"])
def test_checkpoint_after_reshard_restores_on_the_new_mesh_and_one_card(
        runs, case):
    _want, _single, results, dirs, cfg, _elastic = runs
    _losses, _events, state, _active, (step, resumed) = results[0][case]
    assert step == 4
    params, opt_state = state
    for k, v in params.items():
        np.testing.assert_array_equal(resumed[0][k], v, err_msg=k)
        for q in ("master", "m", "v"):
            np.testing.assert_array_equal(resumed[1][q][k], opt_state[q][k],
                                          err_msg=f"{q} {k}")
    n_new = 4 if case == "shrink" else 8
    for rank, res in enumerate(results):
        assert res[case][4][0] == (4 if rank < n_new else 0), rank
    tr = Trainer(cfg, SHAPE, optim.OptConfig(**OPT), TrainerConfig(
        total_steps=5, ckpt_dir=f"{dirs['elastic']}/{case}"), device="cpu")
    tr.resume_or_init()
    assert tr.step == 4
    for k, p in tr.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), params[k],
                                      err_msg=k)
    tr.close()
