"""Quickstart on the PyTorch port: the framework's public API in one page
(the counterpart of ``examples/quickstart.py``).

Builds a reduced Mixtral (MoE) on a data 2 x model 4 mesh of 8 ranks,
runs 20 training steps through the fault-tolerant mesh ``Trainer``,
checkpoints every 10 steps into a temporary directory, and decodes 8
tokens greedily from the trained weights through
``launch/step.py::make_serve_step`` under the decode cell's rules.

  PYTHONPATH=src python examples/torch_quickstart.py
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu

Runs on the card unless ``--device cpu`` is given (8 ranks over gloo,
sharing it; on the card the attention runs through the flash kernel and
the experts through the grouped-matmul kernel); with no card it raises.
"""
import argparse
import tempfile

import numpy as np
import torch

MESH = (2, 4)


def quickstart_rank(rank, device, ckpt_dir, steps=20, ckpt_every=10,
                    decode_steps=8):
    """Train and decode on this rank of the (data 2, model 4) mesh:
    (param count, final metrics, decoded tokens of sequence 0, events)."""
    from repro_torch import optim
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import batch_iterator
    from repro_torch.launch import step as step_mod
    from repro_torch.launch.mesh import make_test_mesh, rank_device
    from repro_torch.models import get_model
    from repro_torch.models.convert import gather_params, shard_params
    from repro_torch.runtime import Trainer, TrainerConfig
    device = rank_device(device)

    # 1. an architecture from the registry, reduced
    cfg = reduced_config(get_config("mixtral-8x7b"))
    shape = ShapeConfig("quickstart", seq_len=64, global_batch=8,
                        kind="train")
    mesh = make_test_mesh(MESH, ("data", "model"), device)
    if rank == 0:
        print(f"arch={cfg.name}  params={cfg.param_count():,}  "
              f"mesh={MESH[0]}x{MESH[1]}", flush=True)

    # 2. train for a few steps through the fault-tolerant runtime (rank 0
    # logs)
    trainer = Trainer(cfg, shape,
                      optim.OptConfig(warmup_steps=2, total_steps=steps),
                      TrainerConfig(total_steps=steps, ckpt_every=ckpt_every,
                                    ckpt_dir=ckpt_dir,
                                    log_every=5 if rank == 0 else steps + 1),
                      mesh=mesh)
    trainer.init()
    metrics = trainer.run(batch_iterator(cfg, shape))

    # 3. decode greedily from the trained weights, under the decode cell's
    # rules (their layouts may differ from training's)
    rules = step_mod.cell_rules(mesh, cfg, ShapeConfig("d", 64, 8, "decode"))
    trained = gather_params(cfg, {k: p.detach() for k, p in
                                  trainer.model.named_parameters()},
                            trainer.rules)
    model = get_model(cfg)(cfg, device, params=shard_params(cfg, trained,
                                                            rules),
                           rules=rules)
    serve = step_mod.make_serve_step(cfg, rules)
    cache = model.init_cache(8, 64)
    toks = torch.full((8,), 7, dtype=torch.int32, device=device)
    outs = []
    with torch.no_grad():
        for _ in range(decode_steps):
            toks, cache = serve(model, cache, toks)
            outs.append(toks.cpu().numpy().copy())
    trainer.close()
    return (cfg.param_count(), metrics, [int(o[0]) for o in outs],
            list(trainer.events))


def report(results) -> dict:
    _, metrics, decoded, _ = results[0]
    assert all(r[2] == decoded for r in results), "ranks decoded apart"
    assert all(np.isfinite(v) for v in metrics.values())
    print("final:", {k: round(v, 4) for k, v in metrics.items()})
    print("decoded token ids (seq 0):", decoded)
    return {"metrics": metrics, "decoded": decoded}


def main(argv=None) -> dict:
    from repro_torch.kernels.backend import resolve_device
    from repro_torch.launch.mesh import spawn
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain versions; default the card")
    args = ap.parse_args(argv)
    device = resolve_device(args.device).type
    with tempfile.TemporaryDirectory() as ckdir:
        return report(spawn(quickstart_rank, MESH[0] * MESH[1], "gloo",
                            device=device, args=(device, ckdir)))


if __name__ == "__main__":
    main()
