"""The port's data pipeline, checkpoints and fault-tolerant ``Trainer``
against the JAX package on the CPU.

* ``synthetic_batch`` equal to the reference's, array for array, for
  every arch and several steps; the ``Prefetcher``'s credits and
  ``close``;
* checkpoints: the reference's ``tests/test_checkpoint.py`` cases (round
  trip, ``.tmp`` ignored, corruption and a missing leaf detected, the
  async fence and snapshot), and checkpoints written by the reference's
  ``save`` restored by the port and the reverse, bf16 leaves included;
* the ``Trainer``: the reference's ``tests/test_runtime.py`` cases (the
  loss falls, faults are retried, repeated faults restore from the last
  checkpoint, resume, stragglers; ``reshard`` is SPMD and not ported), its
  losses over 6 steps against the reference ``Trainer`` on a 1x1 mesh,
  and ``python -m repro_torch.launch.train --reduced --device cpu`` end
  to end.

The two ``Trainer``s start from the same weights (the reference's, through
``params_from_jax``) and read the same batches.  Tolerance on their
losses: 1e-4 relative (fp32; the reference rematerialises every layer and
attends in chunks, the port neither, so sums run in other orders, and
Adam's first update g / (|g| + eps) lets a gradient within a few eps of
zero move its parameter by what its rounding decides).
"""
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as j_ckpt
from repro import optim as j_optim
from repro.configs import get_config as j_get_config
from repro.configs import list_archs as j_list_archs
from repro.configs import reduced_config as j_reduced_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data import pipeline as j_pipeline
from repro_torch import checkpoint as ckpt
from repro_torch import optim
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import pipeline
from repro_torch.models.convert import params_from_jax
from repro_torch.runtime import FaultInjector, Trainer, TrainerConfig

SHAPE = ShapeConfig("t", seq_len=32, global_batch=8, kind="train")
OPT = dict(lr_peak=3e-3, warmup_steps=2, total_steps=20)
SMALL = dict(num_layers=2, d_model=64, num_heads=2, num_kv_heads=2,
             head_dim=32, d_ff=128, vocab_size=128)


# ---------------------------------------------------------------------------
# the data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", j_list_archs())
def test_synthetic_batch_equals_the_reference(arch):
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    for step, data in ((0, {}), (3, {"mean_doc_len": 16}),
                       (11, {"pack_docs": False, "seed": 5})):
        want = j_pipeline.synthetic_batch(
            jcfg, JShapeConfig("t", 48, 3, "train"), step,
            j_pipeline.DataConfig(**data))
        got = pipeline.synthetic_batch(
            tcfg, ShapeConfig("t", 48, 3, "train"), step,
            pipeline.DataConfig(**data))
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_batch_iterator_starts_where_asked():
    cfg = get_config("stablelm-3b")
    it = pipeline.batch_iterator(cfg, SHAPE, start_step=4)
    next(it)
    np.testing.assert_array_equal(
        next(it)["tokens"], pipeline.synthetic_batch(cfg, SHAPE, 5)["tokens"])


def test_prefetcher_holds_at_most_its_credits_and_closes():
    produced = []

    def source():
        for i in range(100):
            produced.append(i)
            yield i

    pf = pipeline.Prefetcher(source(), credits=2)
    assert [next(pf) for _ in range(3)] == [0, 1, 2]
    time.sleep(0.2)
    # 3 taken, 2 waiting in the queue, 1 blocked in put: never more
    assert len(produced) <= 3 + 2 + 1
    pf.close()
    assert pf._q.qsize() <= 1
    assert list(pipeline.Prefetcher(iter(range(3)), credits=1)) == [0, 1, 2]


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": torch.tensor(rng.standard_normal((4, 8)),
                                     dtype=torch.float32),
                   "layers/b": torch.tensor(rng.standard_normal(8),
                                            dtype=torch.bfloat16)},
        "step": torch.tensor(7, dtype=torch.int32),
    }


def _like(tree):
    if isinstance(tree, dict):
        return {k: _like(v) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


def _assert_trees_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k])
        else:
            assert a[k].dtype == b[k].dtype
            assert torch.equal(a[k], b[k]), k


def test_save_restore_roundtrip(tmp_path):
    tree = _tree()
    d = ckpt.save(tmp_path, 7, tree, extra={"loss": 1.25})
    assert (d / "params__layers@b.npy").exists()
    got, step, extra = ckpt.restore(tmp_path, _like(tree))
    assert step == 7 and extra["loss"] == 1.25
    _assert_trees_equal(got, tree)
    assert json.load(open(d / "manifest.json"))["leaves"][
        "params__layers/b"]["dtype"] == "bfloat16"


def test_latest_step_ignores_tmp(tmp_path):
    ckpt.save(tmp_path, 1, _tree())
    ckpt.save(tmp_path, 5, _tree())
    (tmp_path / "step_00000009.tmp").mkdir()   # crashed save
    assert ckpt.latest_step(tmp_path) == 5
    assert ckpt.latest_step(tmp_path / "absent") is None


def test_corruption_detected(tmp_path):
    tree = _tree()
    d = ckpt.save(tmp_path, 3, tree)
    target = d / "params__w.npy"
    arr = np.load(target)
    arr[0, 0] += 1.0
    np.save(target, arr)
    with pytest.raises(IOError, match="crc"):
        ckpt.restore(tmp_path, _like(tree))
    with pytest.raises(IOError, match="crc"):
        ckpt.verify_manifest(d)


def test_missing_leaf_detected(tmp_path):
    tree = _tree()
    ckpt.save(tmp_path, 3, tree)
    like = _like(tree)
    like["extra_leaf"] = torch.zeros(3)
    with pytest.raises(KeyError):
        ckpt.restore(tmp_path, like)


def test_async_checkpointer_fence(tmp_path):
    ac = ckpt.AsyncCheckpointer(tmp_path, credits=2)
    for s in (10, 20, 30):
        ac.submit(s, _tree(s))
    ac.fence()
    assert ckpt.latest_step(tmp_path) == 30
    ac.close()
    assert not ac._thread.is_alive()


def test_async_snapshot_semantics(tmp_path):
    """The submitted tree is copied at submit time; a later in-place
    update of the live tensors (as the optimizer makes) must not leak into
    the checkpoint."""
    ac = ckpt.AsyncCheckpointer(tmp_path, credits=1)
    w = torch.ones(4)
    ac.submit(1, {"w": w})
    w.fill_(-1)                      # mutate after submit
    ac.fence()
    got, _, _ = ckpt.restore(tmp_path, {"w": torch.zeros(4)})
    torch.testing.assert_close(got["w"], torch.ones(4))
    ac.close()


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    rng = np.random.default_rng(4)
    jtree = {"params": {"w": jnp.asarray(rng.standard_normal((3, 5)),
                                         jnp.float32),
                        "layers/wq": jnp.asarray(rng.standard_normal((2, 3)),
                                                 jnp.bfloat16)},
             "opt": {"step": jnp.asarray(4, jnp.int32)}}
    j_ckpt.save(tmp_path, 4, jtree, extra={"loss": 2.5})
    like = {"params": {"w": torch.empty(3, 5, device="meta"),
                       "layers/wq": torch.empty(2, 3, dtype=torch.bfloat16,
                                                device="meta")},
            "opt": {"step": torch.empty((), dtype=torch.int32,
                                        device="meta")}}
    got, step, extra = ckpt.restore(tmp_path, like)
    assert step == 4 and extra == {"loss": 2.5}
    assert got["params"]["layers/wq"].dtype == torch.bfloat16
    for k in ("w", "layers/wq"):
        np.testing.assert_array_equal(
            got["params"][k].float().numpy(),
            np.asarray(jtree["params"][k], np.float32))
    assert int(got["opt"]["step"]) == 4


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    tree = _tree(2)
    ckpt.save(tmp_path, 9, tree, extra={"loss": 0.5})
    like = jax.tree.map(lambda t: jax.ShapeDtypeStruct(
        tuple(t.shape), jnp.dtype(str(t.dtype)[6:])), tree)
    got, step, extra = j_ckpt.restore(tmp_path, like)
    assert step == 9 and extra["loss"] == 0.5
    assert got["params"]["layers/b"].dtype == jnp.bfloat16
    for k in ("w", "layers/b"):
        np.testing.assert_array_equal(
            np.asarray(got["params"][k], np.float32),
            tree["params"][k].float().numpy())
    assert int(got["step"]) == 7


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------

def _trainer(tmp_path, steps=6, ckpt=True, **kw):
    cfg = reduced_config(get_config("stablelm-3b"), **SMALL)
    tcfg = TrainerConfig(total_steps=steps, ckpt_every=3,
                         ckpt_dir=str(tmp_path / "ck") if ckpt else None,
                         log_every=100)
    return cfg, Trainer(cfg, SHAPE, optim.OptConfig(**OPT), tcfg,
                        device="cpu", **kw)


def test_train_loss_decreases(tmp_path):
    cfg, tr = _trainer(tmp_path, steps=12)
    tr.init()
    losses = []
    tr.run(pipeline.batch_iterator(cfg, SHAPE),
           on_step=lambda s, m: losses.append(float(m["loss"])))
    assert len(losses) == 12
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    assert np.isfinite(losses).all()
    tr.close()


def test_fault_retry_and_recovery(tmp_path):
    cfg, tr = _trainer(tmp_path, steps=6,
                       fault_injector=FaultInjector({2: 1, 4: 1}))
    tr.init()
    tr.run(pipeline.batch_iterator(cfg, SHAPE))
    kinds = [e["kind"] for e in tr.events]
    assert kinds.count("step_failure") == 2
    assert tr.step == 6                    # completed despite faults
    tr.close()


def test_a_retried_step_equals_an_unfaulted_one(tmp_path):
    """A fault before the step leaves parameters and state as they were:
    the run with a retried step 1 equals the run without a fault."""
    runs = []
    for faults in ({}, {1: 2}):
        cfg, tr = _trainer(tmp_path / str(len(runs)), steps=3,
                           fault_injector=FaultInjector(faults))
        tr.init(seed=3)
        losses = []
        tr.run(pipeline.batch_iterator(cfg, SHAPE),
               on_step=lambda s, m: losses.append(float(m["loss"])))
        runs.append((losses, {k: p.detach().clone() for k, p
                              in tr.model.named_parameters()}))
        tr.close()
    assert runs[0][0] == runs[1][0]
    for k, p in runs[0][1].items():
        assert torch.equal(p, runs[1][1][k]), k


def test_repeated_failures_restore_from_the_checkpoint(tmp_path):
    """Three failures of step 4 exceed ``max_retries_per_step`` (2): the
    trainer restores step 3's checkpoint and trains on to the end."""
    cfg, tr = _trainer(tmp_path, steps=6,
                       fault_injector=FaultInjector({4: 3}))
    tr.init()
    tr.run(pipeline.batch_iterator(cfg, SHAPE))
    kinds = [e["kind"] for e in tr.events]
    assert kinds.count("step_failure") == 3
    assert {"kind": "resume", "step": 3} in tr.events
    assert tr.step == 6
    tr.close()


def test_without_a_checkpoint_dir_nothing_is_written(tmp_path,
                                                     monkeypatch):
    """``ckpt_dir=None``: no saves; repeated failures start again from
    ``init`` (the reference's ``resume_or_init`` with no checkpoint)."""
    monkeypatch.chdir(tmp_path)
    cfg, tr = _trainer(tmp_path, steps=4, ckpt=False,
                       fault_injector=FaultInjector({2: 3}))
    tr.init()
    tr.run(pipeline.batch_iterator(cfg, SHAPE))
    assert tr.step == 4
    assert not any(e["kind"] == "resume" for e in tr.events)
    assert list(tmp_path.iterdir()) == []
    tr.close()


def test_retry_budget_is_bounded(tmp_path):
    cfg, tr = _trainer(tmp_path, steps=6,
                       fault_injector=FaultInjector({1: 100}))
    tr.tcfg.max_total_retries = 4
    tr.init()
    with pytest.raises(RuntimeError, match="retry budget"):
        tr.run(pipeline.batch_iterator(cfg, SHAPE))
    tr.close()


def test_resume_from_checkpoint(tmp_path):
    cfg, tr = _trainer(tmp_path, steps=6)
    tr.init()
    tr.run(pipeline.batch_iterator(cfg, SHAPE))
    tr.close()
    cfg2, tr2 = _trainer(tmp_path, steps=9)
    tr2.resume_or_init()
    assert tr2.step == 6
    assert any(e["kind"] == "resume" for e in tr2.events)
    for k, p in tr.model.named_parameters():
        assert torch.equal(p, dict(tr2.model.named_parameters())[k]), k
        assert p.dtype == tr2.model._p(k).dtype
    assert int(tr2.opt_state["step"]) == 6
    tr2.run(pipeline.batch_iterator(cfg2, SHAPE, start_step=tr2.step))
    assert tr2.step == 9
    tr2.close()


def test_straggler_detection(tmp_path):
    cfg, tr = _trainer(tmp_path, steps=1)
    tr.init()
    for dt in [0.1] * 10:
        tr._heartbeat(dt)
    assert not any(e["kind"] == "straggler" for e in tr.events)
    tr._heartbeat(1.0)
    assert any(e["kind"] == "straggler" for e in tr.events)
    tr.close()


def test_trainer_losses_match_the_reference_trainer(tmp_path):
    """Six steps of the port's ``Trainer`` against the reference's on a
    1x1 mesh, from the same weights, on the same batches."""
    from repro.launch.mesh import make_test_mesh
    from repro.runtime import Trainer as JTrainer
    from repro.runtime import TrainerConfig as JTrainerConfig
    jcfg = j_reduced_config(j_get_config("stablelm-3b"), **SMALL)
    jshape = JShapeConfig("t", seq_len=32, global_batch=8, kind="train")
    jtr = JTrainer(jcfg, jshape, make_test_mesh((1, 1), ("data", "model")),
                   j_optim.OptConfig(**OPT), JTrainerConfig(
                       total_steps=6, ckpt_every=3, log_every=100,
                       ckpt_dir=str(tmp_path / "jck")))
    jtr.init()
    # its initial weights, copied before its steps donate the buffers
    p0 = {k: np.asarray(v) for k, v in jtr.params.items()}
    want = []
    jtr.run(j_pipeline.batch_iterator(jcfg, jshape),
            on_step=lambda s, m: want.append(float(m["loss"])))
    jtr.close()
    cfg, tr = _trainer(tmp_path, steps=6)
    tr.init(params=params_from_jax(cfg, p0, "cpu"))
    got = []
    tr.run(pipeline.batch_iterator(cfg, SHAPE),
           on_step=lambda s, m: got.append(float(m["loss"])))
    tr.close()
    assert len(got) == len(want) == 6
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_train_launcher_end_to_end_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train
    final = train.main(["--arch", "mamba2-370m", "--reduced", "--device",
                        "cpu", "--steps", "4", "--seq-len", "32", "--batch",
                        "2", "--ckpt-every", "2", "--remat", "full",
                        "--ckpt-dir", str(tmp_path / "ck")])
    assert set(final) == {"loss", "ce", "grad_norm", "lr"}
    assert np.isfinite(list(final.values())).all()
    assert ckpt.latest_step(tmp_path / "ck") == 4
    final = train.main(["--arch", "mamba2-370m", "--reduced", "--device",
                        "cpu", "--steps", "6", "--seq-len", "32", "--batch",
                        "2", "--resume", "--ckpt-dir", str(tmp_path / "ck")])
    assert "'kind': 'resume', 'step': 4" in capsys.readouterr().out
    assert ckpt.latest_step(tmp_path / "ck") == 6
    assert threading.active_count() < 50
