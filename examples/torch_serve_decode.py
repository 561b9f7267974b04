"""Serving example on the PyTorch port: the continuous-batching decode
server on a mesh of 8 ranks (the counterpart of
``examples/serve_decode.py``).

Submits a wave of requests with staggered lengths against a reduced
Qwen1.5 (QKV-bias attention) model on a data 2 x model 4 mesh (the
weights and the KV cache sharded by the decode cell's rules, every rank
running the same ticks); shows slot recycling (credits), inline prefill,
and per-request latency.

  PYTHONPATH=src python examples/torch_serve_decode.py
  PYTHONPATH=src python examples/torch_serve_decode.py --device cpu

Runs on the card unless ``--device cpu`` is given (8 ranks over gloo,
sharing it); with no card it raises.
"""
import argparse

import numpy as np

MESH = (2, 4)
SLOTS, MAX_SEQ, REQUESTS = 4, 96, 10


def default_config():
    from repro_torch.configs import get_config, reduced_config
    return reduced_config(get_config("qwen1.5-32b"))


def requests(cfg):
    """The reference's wave: 10 requests of 3-8 prompt tokens and 4-11
    new tokens, from ``default_rng(0)``."""
    from repro_torch.launch.serve import Request
    rng = np.random.default_rng(0)
    out = []
    for r in range(REQUESTS):
        plen = int(rng.integers(3, 9))
        out.append(Request(
            rid=r,
            prompt=rng.integers(0, cfg.vocab_size, plen).astype(np.int32),
            max_new=int(rng.integers(4, 12))))
    return out


def serve(server, cfg):
    """Submit the wave and run ``server`` until every request completes:
    (ticks, [(rid, prompt length, tokens, latency s)] by rid)."""
    for req in requests(cfg):
        server.submit(req)
    ticks = server.run()
    return ticks, [(r.rid, len(r.prompt), list(r.out),
                    r.done_at - r.submitted_at)
                   for r in sorted(server.completed, key=lambda r: r.rid)]


def serve_rank(rank, device, cfg=None):
    """This rank's ``Server`` on the (data 2, model 4) mesh, weights drawn
    from seed 0 (the same numbers as one device's ``Server``)."""
    from repro_torch.launch.mesh import make_test_mesh, rank_device
    from repro_torch.launch.serve import Server
    device = rank_device(device)
    cfg = cfg or default_config()
    mesh = make_test_mesh(MESH, ("data", "model"), device)
    server = Server(cfg, slots=SLOTS, max_seq=MAX_SEQ, device=device,
                    mesh=mesh)
    return serve(server, cfg)


def report(results) -> dict:
    ticks, done = results[0]
    assert all([d[2] for d in r[1]] == [d[2] for d in done]
               for r in results), "ranks served apart"
    print(f"{len(done)} requests in {ticks} ticks "
          f"({SLOTS} slots, continuous batching)")
    for rid, plen, out, lat in done:
        print(f"  req {rid}: prompt[{plen}] -> {len(out)} new tokens, "
              f"{lat:.2f}s, ids={out[:6]}…")
    assert len(done) == REQUESTS
    print("OK")
    return {"ticks": ticks, "tokens": [d[2] for d in done]}


def main(argv=None) -> dict:
    from repro_torch.kernels.backend import resolve_device
    from repro_torch.launch.mesh import spawn
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain versions; default the card")
    args = ap.parse_args(argv)
    device = resolve_device(args.device).type
    return report(spawn(serve_rank, MESH[0] * MESH[1], "gloo",
                        device=device, args=(device,)))


if __name__ == "__main__":
    main()
