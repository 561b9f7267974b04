"""End to end on the PyTorch port: train a ~100M-param LM for a few
hundred steps on a mesh of 8 ranks (the counterpart of
``examples/train_lm.py``).

Exercises the full production path — the synthetic data pipeline with
credit-bounded prefetch, DP+TP sharding (data 2 x model 4), ZeRO-1
AdamW, async checkpointing, fault injection + recovery, and a mid-run
elastic re-shard onto 4 of the 8 ranks (data 1 x model 4).

  PYTHONPATH=src python examples/torch_train_lm.py             # ~300 steps
  PYTHONPATH=src python examples/torch_train_lm.py --steps 50  # quick pass
  PYTHONPATH=src python examples/torch_train_lm.py --device cpu \\
      --steps 16 --layers 2 --seq-len 32 --batch 8 --vocab 128

The two injected faults and the warm-up sit at the reference's fractions
of ``--steps`` (faults at 40/300 and 140/300, warm-up 30/300), so the
default reproduces the reference's run.  Checkpoints go to
``--ckpt-dir``; a run resumes from the newest one there.  Runs on the
card unless ``--device cpu`` is given (8 ranks over gloo, sharing it;
the attention runs through the flash kernel); with no card it raises.
"""
import argparse
import dataclasses

import numpy as np

MESH, SMALL = (2, 4), (1, 4)
REF_STEPS, REF_FAULTS, REF_WARMUP = 300, (40, 140), 30


def lm_config(layers: int = 12, vocab: int = 50304):
    """~100M params at 12 layers: a 512-wide StableLM-family config."""
    from repro_torch.configs import get_config
    return dataclasses.replace(
        get_config("stablelm-3b"), name="stablelm-100m",
        num_layers=layers, d_model=512, num_heads=8, num_kv_heads=8,
        head_dim=64, d_ff=2048, vocab_size=vocab, dtype="float32")


def at_fraction(steps: int, ref_step: int) -> int:
    """``ref_step`` of the reference's 300 steps, at the same fraction of
    ``steps``."""
    return ref_step * steps // REF_STEPS


def train_rank(rank, device, steps, seq_len, batch, ckpt_dir, layers=12,
               vocab=50304):
    """Train on this rank: ``steps // 2`` steps on (data 2, model 4), an
    elastic re-shard onto ranks 0-3 (data 1 x model 4), the rest there.
    Returns (losses this rank saw, events, param count)."""
    from repro_torch import optim
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import (DataConfig, Prefetcher,
                                           batch_iterator)
    from repro_torch.launch.mesh import make_test_mesh, rank_device
    from repro_torch.runtime import FaultInjector, Trainer, TrainerConfig
    device = rank_device(device)
    cfg = lm_config(layers, vocab)
    if rank == 0:
        print(f"params: {cfg.param_count() / 1e6:.1f}M", flush=True)
    shape = ShapeConfig("train_lm", seq_len, batch, "train")
    mesh = make_test_mesh(MESH, ("data", "model"), device)
    # every rank of the world builds the smaller mesh; ranks 4-7 sit out
    small = make_test_mesh(SMALL, ("data", "model"), device,
                           ranks=range(SMALL[0] * SMALL[1]))

    trainer = Trainer(
        cfg, shape,
        optim.OptConfig(lr_peak=6e-4,
                        warmup_steps=max(1, at_fraction(steps, REF_WARMUP)),
                        total_steps=steps),
        TrainerConfig(total_steps=steps, ckpt_every=100, ckpt_dir=ckpt_dir,
                      log_every=20 if rank == 0 else steps + 1),
        # inject two transient faults to demonstrate retry/recovery
        fault_injector=FaultInjector({at_fraction(steps, s): 1
                                      for s in REF_FAULTS}),
        mesh=mesh)
    trainer.resume_or_init()

    data = Prefetcher(batch_iterator(cfg, shape, start_step=trainer.step,
                                     data_cfg=DataConfig(prefetch_credits=2)),
                      credits=2)
    losses = []
    try:
        trainer.tcfg.total_steps = steps // 2
        trainer.run(iter(data),
                    on_step=lambda s, m: losses.append(float(m["loss"])))
        # elastic scale-down mid-run: 8 ranks -> 4 ranks, same run
        trainer.reshard(small)
        if rank == 0:
            print(f"[elastic] resharded to {small.size} ranks at step "
                  f"{trainer.step}", flush=True)
        trainer.tcfg.total_steps = steps
        trainer.run(iter(data),
                    on_step=lambda s, m: losses.append(float(m["loss"])))
    finally:
        data.close()
        trainer.close()
    return losses, list(trainer.events), cfg.param_count()


def report(results) -> dict:
    losses, events, _ = results[0]       # rank 0 trains every step
    print(f"\nloss: first10={np.mean(losses[:10]):.3f} "
          f"last10={np.mean(losses[-10:]):.3f}")
    print("events:", [e["kind"] for e in events])
    assert np.mean(losses[-10:]) < np.mean(losses[:10]), "did not learn"
    print("OK: loss decreased through faults and re-sharding")
    return {"losses": losses, "events": events}


def main(argv=None) -> dict:
    from repro_torch.kernels.backend import resolve_device
    from repro_torch.launch.mesh import spawn
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=REF_STEPS)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--vocab", type=int, default=50304)
    ap.add_argument("--ckpt-dir", default="checkpoints/torch_train_lm")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain versions; default the card")
    args = ap.parse_args(argv)
    device = resolve_device(args.device).type
    return report(spawn(train_rank, MESH[0] * MESH[1], "gloo",
                        device=device,
                        args=(device, args.steps, args.seq_len, args.batch,
                              args.ckpt_dir, args.layers, args.vocab)))


if __name__ == "__main__":
    main()
