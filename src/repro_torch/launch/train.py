"""Training launcher (the port's counterpart of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \\
      --reduced --device cpu

trains the reduced config on the CPU through the plain versions of the
kernels; without ``--device cpu`` it runs on the card.  Without
``--reduced`` the published widths train at ``--seq-len`` x ``--batch``
(the reference's ``train_4k`` global batch of 256 does not fit one card,
and the reference has no gradient accumulation).

On a mesh (every family): ``--devices 8 --mesh-shape 2,4
--strategy fsdp`` starts 8 ranks (``repro_torch.launch.mesh.spawn``;
``--backend gloo`` on the CPU or ranks sharing a card, ``nccl`` with a
card per rank), each a ``Trainer(..., mesh=mesh, strategy=...)`` reading
the same deterministic global batches, the parameters and the ZeRO-1
optimizer state sharded by the reference's ``cell_rules``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-72b \\
      --reduced --device cpu --devices 8 --mesh-shape 2,4 --strategy fsdp

The strategies are ``baseline``, ``fsdp``, ``no_sp``, ``flat_a2a`` and
``no_zero1``; ``--remat`` (``none``, ``full`` or ``dots``) defaults to
the rules' (``full``) on a mesh and to ``none`` on one device.

:func:`make_trainer` and :func:`train` are the launcher's code, for
callers that build a config themselves (``chip_smoke.py`` cuts depth).
"""
from __future__ import annotations

import argparse
from typing import Callable, Dict, Optional

__all__ = ["make_trainer", "train", "main"]


def make_trainer(cfg, seq_len: int, batch: int, steps: int, *, device=None,
                 remat: Optional[str] = None, lr: float = 3e-4,
                 ckpt_dir: str = "checkpoints/train", ckpt_every: int = 25,
                 fault_injector=None, mesh=None, strategy: str = "baseline",
                 **rule_overrides):
    """The launcher's ``Trainer``: AdamW peaking at ``lr`` after 10 warmup
    steps, cosine to ``steps``; checkpoints every ``ckpt_every`` steps
    under ``ckpt_dir``; on ``mesh`` under ``strategy`` and
    ``rule_overrides`` (every rank calls it alike)."""
    from repro_torch import optim
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.runtime import Trainer, TrainerConfig
    shape = ShapeConfig("cli", seq_len, batch, "train")
    opt_cfg = optim.OptConfig(lr_peak=lr, warmup_steps=10, total_steps=steps)
    tcfg = TrainerConfig(total_steps=steps, ckpt_every=ckpt_every,
                         ckpt_dir=ckpt_dir)
    return Trainer(cfg, shape, opt_cfg, tcfg, fault_injector=fault_injector,
                   device=device, remat=remat, mesh=mesh, strategy=strategy,
                   **rule_overrides)


def train(trainer, on_step: Optional[Callable[[int, Dict], None]] = None
          ) -> Dict[str, float]:
    """Run ``trainer`` from its step to its last on the deterministic
    stream (batch ``i`` for step ``i``), prefetched on a host thread."""
    from repro_torch.data.pipeline import Prefetcher, batch_iterator
    data = Prefetcher(batch_iterator(trainer.cfg, trainer.shape,
                                     start_step=trainer.step))
    try:
        return trainer.run(iter(data), on_step)
    finally:
        data.close()


def _run(cfg, args, mesh=None):
    """Build the CLI's ``Trainer`` and train; (final metrics, events)."""
    trainer = make_trainer(cfg, args.seq_len, args.batch, args.steps,
                           device=args.device, remat=args.remat, lr=args.lr,
                           ckpt_dir=args.ckpt_dir,
                           ckpt_every=args.ckpt_every, mesh=mesh,
                           strategy=args.strategy)
    if args.resume:
        trainer.resume_or_init()
    else:
        trainer.init()
    try:
        return train(trainer), trainer.events
    finally:
        trainer.close()


def _train_rank(rank, cfg, args):
    """One rank of ``--devices``: a mesh of ``--mesh-shape`` and its
    ``Trainer``."""
    import torch
    from repro_torch.launch.mesh import make_test_mesh
    shape = tuple(int(x) for x in args.mesh_shape.split(","))
    device = "cpu" if args.device == "cpu" else \
        f"cuda:{torch.cuda.current_device()}"
    return _run(cfg, args, make_test_mesh(shape, ("data", "model"), device))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--remat", default=None, choices=("none", "full",
                                                      "dots"),
                    help="default: none on one device, the rules' on a "
                         "mesh")
    ap.add_argument("--ckpt-dir", default="checkpoints/train")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain versions; default the card")
    ap.add_argument("--devices", type=int, default=1,
                    help="ranks of the mesh (1: one device, no mesh)")
    ap.add_argument("--mesh-shape", default=None,
                    help="data,model (default 1,<devices>)")
    ap.add_argument("--strategy", default="baseline",
                    choices=("baseline", "fsdp", "no_sp", "flat_a2a",
                             "no_zero1"))
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"),
                    help="process-group backend of the ranks: gloo on the "
                         "CPU or ranks sharing a card, nccl with a card "
                         "per rank")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, reduced_config

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    if args.devices > 1:
        from repro_torch.launch.mesh import spawn
        args.mesh_shape = args.mesh_shape or f"1,{args.devices}"
        print(f"{args.devices} ranks, mesh (data, model) = "
              f"({args.mesh_shape}), backend {args.backend}, strategy "
              f"{args.strategy}")
        final, events = spawn(
            _train_rank, args.devices, args.backend,
            device="cpu" if args.device == "cpu" else "cuda",
            args=(cfg, args))[0]
    else:
        if args.strategy != "baseline":
            ap.error("--strategy needs a mesh (--devices > 1)")
        final, events = _run(cfg, args)
    print("final metrics:", final)
    for ev in events:
        print("event:", ev)
    return final


if __name__ == "__main__":
    main()
