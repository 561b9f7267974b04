"""How far the port's random-init Mamba-2 370M amplifies rounding, on one
device (no mesh): the numbers behind ``chip_smoke.py``'s ``[spmd
families]`` gates, which hold fp32 runs, and its step-1 hold of the
zero-initialised ``dt_bias`` and ``conv_b``.

  PYTHONPATH=src python benchmarks/torch_rounding_spread.py --device cpu

At the published widths, ``--layers`` deep, on ``--batch`` x ``--seq``
tokens of the data pipeline's batch 0, it prints

* the bf16 model's logits against the fp32 model's on the same weights
  (max |difference| over the largest |logit|);
* the relative L2 change of each fp32 gradient under a 1e-7 relative
  perturbation of ``layers/in_proj``;
* the relative L2 change of each parameter after 3 AdamW steps
  (``launch/train.py::make_trainer``, full remat) under the same
  perturbation.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.launch.train import make_trainer
from repro_torch.models import get_model
from repro_torch.models.convert import init_params

PERTURBED = "layers/in_proj"


def _perturb(params, scale=1e-7, seed=5):
    g = torch.Generator().manual_seed(seed)
    p = params[PERTURBED]
    noise = torch.randn(p.shape, generator=g).to(p.device)
    with torch.no_grad():
        p.mul_(1 + scale * noise)


def _rel(a, b):
    return float((a.double() - b.double()).norm()
                 / b.double().norm().clamp_min(1e-30))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--layers", type=int, default=48)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    cfg = dataclasses.replace(get_config("mamba2-370m"),
                              num_layers=args.layers, dtype="float32")
    dev = torch.device(args.device or "cuda")
    data = synthetic_batch(cfg, ShapeConfig("cli", args.seq, args.batch,
                                            "train"), 0)
    batch = {k: torch.from_numpy(np.asarray(v)).to(dev)
             for k, v in data.items()}
    full = init_params(cfg, torch.Generator(dev).manual_seed(0), dev)

    def model(dtype, params):
        c = dataclasses.replace(cfg, dtype=dtype)
        return get_model(c)(c, dev, params={
            k: v.clone().to(get_model(c).param_dtype(c, k))
            for k, v in params.items()})

    with torch.no_grad():
        l32 = model("float32", full)(batch["tokens"])[0].float()
        l16 = model("bfloat16", full)(batch["tokens"])[0].float()
    print(f"layers {args.layers}, {args.batch} x {args.seq} tokens: bf16 "
          f"logits vs fp32 {float((l16 - l32).abs().max() / l32.abs().max()):.3e}"
          f" of the largest")

    def grads(params):
        m = model("float32", params)
        m.requires_grad_(True)
        m.loss(batch, remat="full")[0].backward()
        return {k: p.grad for k, p in m.named_parameters()}

    moved = dict(full)
    moved[PERTURBED] = full[PERTURBED].clone()
    _perturb(moved)
    g0, g1 = grads(full), grads(moved)
    print("fp32 gradients under a 1e-7 perturbation of "
          f"{PERTURBED}: " + ", ".join(f"{k} {_rel(g1[k], g0[k]):.2e}"
                                        for k in g0))

    def train(perturb):
        tr = make_trainer(cfg, args.seq, args.batch, 3, device=dev,
                          remat="full", ckpt_dir=None)
        tr.init(seed=0)
        if perturb:
            _perturb(dict(tr.model.named_parameters()))
        tr.run(iter(itertools.repeat(data)), lambda s, m: None)
        return {k: p.detach().clone() for k, p in tr.model.named_parameters()}
    p0, p1 = train(False), train(True)
    print("parameters after 3 AdamW steps under the same perturbation: "
          + ", ".join(f"{k} {_rel(p1[k], p0[k]):.2e}" for k in p0))


if __name__ == "__main__":
    main()
