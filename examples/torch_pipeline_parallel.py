"""Pipeline parallelism via token-queue channels on the PyTorch port (paper
C6 / Option 2; the counterpart of ``examples/pipeline_parallel.py``).

Trains a small residual MLP stack split across 4 pipeline stages (the
``model`` axis of a data 2 x model 4 mesh of 8 ranks), microbatches
flowing stage to stage through one-hop ``ppermute`` channels, rows split
over ``data``.  Compares against the sequential stack on one device,
takes 10 SGD steps through the pipelined graph (``torch.autograd``
through the reverse wave) and prints the bubble fraction.

  PYTHONPATH=src python examples/torch_pipeline_parallel.py
  PYTHONPATH=src python examples/torch_pipeline_parallel.py --device cpu

Runs on the card unless ``--device cpu`` is given (8 ranks over gloo,
sharing it); with no card it raises.
"""
import argparse

import numpy as np
import torch

L, D, V = 8, 64, 512
N_MICRO, MB, S = 8, 2, 32
MESH = (2, 4)
LR, STEPS = 0.05, 10


def draw():
    """The reference's weights and data, from the same ``default_rng(0)``
    draws: w1, w2 (L, D, D), x and the target (N_MICRO, MB * S, D)."""
    rng = np.random.default_rng(0)
    w1 = (rng.standard_normal((L, D, D)) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((L, D, D)) * 0.1).astype(np.float32)
    x = rng.standard_normal((N_MICRO, MB * S, D)).astype(np.float32)
    y_tgt = rng.standard_normal((N_MICRO, MB * S, D)).astype(np.float32)
    return w1, w2, x, y_tgt


def body(lp, x):
    """One stage = its residual MLP blocks, ``h + tanh(h @ w1) @ w2``."""
    w1, w2 = lp
    for i in range(w1.shape[0]):
        x = x + torch.tanh(x @ w1[i]) @ w2[i]
    return x


def loss_ref(w1, w2, x, y_tgt) -> torch.Tensor:
    """The sequential stack on one device, every microbatch."""
    return torch.mean((body((w1, w2), x) - y_tgt) ** 2)


def pipeline_rank(rank, device):
    """This rank's stage and rows on the (data 2, model 4) mesh: (the
    pipelined loss, the sequential loss, the losses after each of the 10
    SGD steps, the stage count)."""
    from repro_torch.launch.mesh import make_test_mesh, rank_device
    from repro_torch.parallel import comm
    from repro_torch.parallel.pipeline import pipeline_apply
    device = rank_device(device)
    mesh = make_test_mesh(MESH, ("data", "model"), device)
    n_stages = mesh.axis_size("model")
    stage, d = mesh.index("model"), mesh.index("data")
    w1, w2, x, y_tgt = (torch.from_numpy(a).to(device) for a in draw())
    rows = MB * S // mesh.axis_size("data")
    xr, yr = (a[:, d * rows:(d + 1) * rows] for a in (x, y_tgt))
    params = [w.reshape(n_stages, -1, D, D)[stage].clone().requires_grad_()
              for w in (w1, w2)]

    def loss():
        """This rank's share of the global mean (its rows; the global
        loss is the sum over ``data``) and the global value."""
        out = pipeline_apply(body, tuple(params), xr, mesh,
                             stage_axis="model", batch_axis="data")
        share = ((out - yr) ** 2).sum() / y_tgt.numel()
        return share, float(comm.all_reduce(share.detach(), mesh, "data"))

    with torch.no_grad():
        l_pipe = loss()[1]
        l_ref = float(loss_ref(w1, w2, x, y_tgt))
    assert abs(l_pipe - l_ref) < 1e-5, (l_pipe, l_ref)

    # a few SGD steps through the pipelined graph (bwd = reverse wave)
    losses = []
    for _ in range(STEPS):
        share, _ = loss()
        grads = torch.autograd.grad(share, params)
        with torch.no_grad():
            for p, g in zip(params, grads):
                p -= LR * comm.all_reduce(g, mesh, "data")
            losses.append(loss()[1])
    assert losses[-1] < losses[0]
    return l_pipe, l_ref, losses, n_stages


def report(results) -> dict:
    from repro_torch.parallel.pipeline import bubble_fraction
    l_pipe, l_ref, losses, n_stages = results[0]
    assert all(r[2] == losses for r in results), "ranks disagree"
    print(f"pipeline loss {l_pipe:.6f} == sequential {l_ref:.6f}")
    print("pipelined training losses:", [round(v, 4) for v in losses])
    print(f"bubble fraction at {N_MICRO} microbatches x {n_stages} stages: "
          f"{bubble_fraction(N_MICRO, n_stages):.2%} "
          f"(in-flight <= {n_stages} = channel depth, the C3 BDP rule)")
    print("OK")
    return {"l_pipe": l_pipe, "l_ref": l_ref, "losses": losses}


def main(argv=None) -> dict:
    from repro_torch.kernels.backend import resolve_device
    from repro_torch.launch.mesh import spawn
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain versions; default the card")
    args = ap.parse_args(argv)
    device = resolve_device(args.device).type
    return report(spawn(pipeline_rank, MESH[0] * MESH[1], "gloo",
                        device=device, args=(device,)))


if __name__ == "__main__":
    main()
