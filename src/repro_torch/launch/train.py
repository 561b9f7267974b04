"""Training launcher (the port's counterpart of ``repro.launch.train``, one
card).

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \\
      --reduced --device cpu

trains the reduced config on the CPU through the plain versions of the
kernels; without ``--device cpu`` it runs on the card.  Without
``--reduced`` the published widths train at ``--seq-len`` x ``--batch``
(the reference's ``train_4k`` global batch of 256 does not fit one card,
and the reference has no gradient accumulation).  The reference's
``--devices``, ``--mesh-shape`` and ``--strategy`` place the step on a
mesh: SPMD, a later slice.

:func:`make_trainer` and :func:`train` are the launcher's code, for
callers that build a config themselves (``chip_smoke.py`` cuts depth).
"""
from __future__ import annotations

import argparse
from typing import Callable, Dict, Optional

__all__ = ["make_trainer", "train", "main"]


def make_trainer(cfg, seq_len: int, batch: int, steps: int, *, device=None,
                 remat: str = "none", lr: float = 3e-4,
                 ckpt_dir: str = "checkpoints/train", ckpt_every: int = 25,
                 fault_injector=None):
    """The launcher's ``Trainer``: AdamW peaking at ``lr`` after 10 warmup
    steps, cosine to ``steps``; checkpoints every ``ckpt_every`` steps
    under ``ckpt_dir``."""
    from repro_torch import optim
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.runtime import Trainer, TrainerConfig
    shape = ShapeConfig("cli", seq_len, batch, "train")
    opt_cfg = optim.OptConfig(lr_peak=lr, warmup_steps=10, total_steps=steps)
    tcfg = TrainerConfig(total_steps=steps, ckpt_every=ckpt_every,
                         ckpt_dir=ckpt_dir)
    return Trainer(cfg, shape, opt_cfg, tcfg, fault_injector=fault_injector,
                   device=device, remat=remat)


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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--remat", default="none", choices=("none", "full"))
    ap.add_argument("--ckpt-dir", default="checkpoints/train")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain versions; default the card")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, reduced_config

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    trainer = make_trainer(cfg, args.seq_len, args.batch, args.steps,
                           device=args.device, remat=args.remat, lr=args.lr,
                           ckpt_dir=args.ckpt_dir,
                           ckpt_every=args.ckpt_every)
    if args.resume:
        trainer.resume_or_init()
    else:
        trainer.init()
    try:
        final = train(trainer)
        print("final metrics:", final)
        for ev in trainer.events:
            print("event:", ev)
    finally:
        trainer.close()
    return final


if __name__ == "__main__":
    main()
