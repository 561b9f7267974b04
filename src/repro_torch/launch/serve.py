"""Serving launcher: continuous-batched decode against a KV cache (the
port's counterpart of ``repro.launch.serve``, one card).

A bounded slot pool, per-slot sequence state, and one batched decode step
per tick for every slot.  Admission is inline prefill: a newly admitted
request spends its first ticks feeding prompt tokens through the same
decode step (outputs discarded), so no slot stalls another.  A finished
sequence frees its slot.  Tick for tick the reference's loop.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \\
      --reduced --requests 8 --slots 4 --max-new 16

runs on the card; ``--device cpu`` runs the plain versions on the CPU.
Every arch serves: the dense, MoE and VLM transformers, the Mamba-2 LM,
the Jamba hybrid and Whisper (``--arch whisper-large-v3``).  Whisper's
cache is built without an encoder output, as the reference's ``Server``
builds it, so its cross-attention reads a zero cross KV and the tokens
compare with the reference's (``ROADMAP.md`` C-7).

On a mesh (every family): ``--devices 8 --mesh-shape 2,4``
starts 8 ranks (``repro_torch.launch.mesh.spawn``, ``--backend gloo`` on
the CPU or ranks sharing a card, ``nccl`` with a card per rank), each a
``Server(cfg, slots=..., max_seq=..., mesh=mesh)`` running the same
admission loop in lockstep on the same requests, the weights and the KV
cache sharded by the reference's ``cell_rules``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-72b \
      --reduced --device cpu --devices 8 --mesh-shape 2,4

(``--arch mamba2-370m``, ``jamba-v0.1-52b`` or ``whisper-large-v3`` the
same way).
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import time
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

__all__ = ["Request", "Server", "main"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: "np.ndarray"
    max_new: int
    out: Optional[List[int]] = None
    submitted_at: float = 0.0
    done_at: float = 0.0


@dataclasses.dataclass
class _Slot:
    req: Request
    fed: int = 0          # prompt tokens already fed

    @property
    def prefilling(self) -> bool:
        return self.fed < len(self.req.prompt)


class Server:
    """Continuous-batching decode server over the port's serve step.

    The model is built on ``device`` (the card unless ``device="cpu"``)
    around ``params`` (a state dict on that device, e.g. from
    ``repro_torch.models.convert``; held, not copied), or around
    ``init_params`` drawn from a generator seeded 0 when ``params`` is
    None.

    With ``mesh`` (a ``repro_torch.parallel.comm.Mesh``; every rank builds
    its ``Server`` and submits the same requests), the rules are the
    reference's ``cell_rules`` of a decode cell of ``slots`` x
    ``max_seq`` under ``strategy``, the model holds this rank's blocks of
    ``params`` (full parameters) or of the seeded draw, the cache its
    block, and every rank runs the same ticks and gets the same tokens.
    ``device`` defaults to the mesh's."""

    def __init__(self, cfg, slots: int, max_seq: int, device=None,
                 eos_id: int = -1,
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 mesh=None, strategy: str = "baseline"):
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.kernels.backend import resolve_device
        from repro_torch.launch.step import cell_rules, serve_step
        from repro_torch.models import get_model
        from repro_torch.models.convert import init_params, shard_params

        self.cfg, self.mesh = cfg, mesh
        if device is None and mesh is not None:
            device = mesh.device
        self.device = resolve_device(device)
        self.slots, self.max_seq, self.eos_id = slots, max_seq, eos_id
        self.rules = None if mesh is None else cell_rules(
            mesh, cfg, ShapeConfig("serve", max_seq, slots, "decode"),
            strategy)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
            params = init_params(cfg, gen, self.device, rules=self.rules)
        elif self.rules is not None:
            params = shard_params(cfg, params, self.rules)
        self.model = get_model(cfg)(cfg, device=self.device, params=params,
                                    rules=self.rules)
        self.serve_step = serve_step
        self.cache = self.model.init_cache(slots, max_seq)
        self.active: List[Optional[_Slot]] = [None] * slots
        self.feed = np.zeros((slots,), np.int32)   # token each slot eats next
        self.queue: Deque[Request] = collections.deque()
        self.completed: List[Request] = []
        self.ticks = 0

    # ------------------------------------------------------------------
    def submit(self, req: Request):
        req.submitted_at = time.perf_counter()
        req.out = []
        self.queue.append(req)

    def _admit(self):
        for s in range(self.slots):
            if self.active[s] is None and self.queue:
                req = self.queue.popleft()
                self.active[s] = _Slot(req=req, fed=1)
                self.model.reset_slot(self.cache, s)
                self.feed[s] = int(req.prompt[0])

    # ------------------------------------------------------------------
    @torch.no_grad()
    def tick(self):
        """One decode step for every slot (idle slots eat a pad token)."""
        self._admit()
        feed = torch.from_numpy(self.feed.copy()).to(self.device)
        on_mesh = () if self.rules is None else (self.rules,)
        nxt, self.cache = self.serve_step(self.model, self.cache, feed,
                                          *on_mesh)
        nxt = nxt.cpu().numpy()
        self.ticks += 1
        for s, slot in enumerate(self.active):
            if slot is None:
                continue
            req = slot.req
            if slot.prefilling:
                self.feed[s] = int(req.prompt[slot.fed])   # ignore output
                slot.fed += 1
                continue
            tok = int(nxt[s])
            req.out.append(tok)
            self.feed[s] = tok
            if tok == self.eos_id or len(req.out) >= req.max_new:
                req.done_at = time.perf_counter()
                self.completed.append(req)
                self.active[s] = None   # slot freed

    def run(self, tick_limit: int = 10_000) -> int:
        while (self.queue or any(sl is not None for sl in self.active)) \
                and self.ticks < tick_limit:
            self.tick()
        return self.ticks


def _requests(cfg, args) -> List[Request]:
    rng = np.random.default_rng(0)
    return [Request(rid=r, prompt=rng.integers(
        0, cfg.vocab_size, size=args.prompt_len).astype(np.int32),
        max_new=args.max_new) for r in range(args.requests)]


def _serve(cfg, args, mesh=None):
    """Serve the CLI's requests; (completed, ticks, seconds)."""
    server = Server(cfg, slots=args.slots, max_seq=args.max_seq,
                    device=args.device, mesh=mesh)
    for req in _requests(cfg, args):
        server.submit(req)
    t0 = time.perf_counter()
    ticks = server.run()
    return server.completed, ticks, time.perf_counter() - t0


def _serve_rank(rank, cfg, args):
    """One rank of ``--devices``: a mesh of ``--mesh-shape`` and its
    ``Server``; returns what the CLI prints."""
    from repro_torch.launch.mesh import make_test_mesh, rank_device
    shape = tuple(int(x) for x in args.mesh_shape.split(","))
    device = rank_device(args.device)
    mesh = make_test_mesh(shape, ("data", "model"), device)
    return _serve(cfg, args, mesh)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain versions; default the card")
    ap.add_argument("--devices", type=int, default=1,
                    help="ranks of the mesh (1: one device, no mesh)")
    ap.add_argument("--mesh-shape", default=None,
                    help="data,model (default 1,<devices>)")
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
              f"({args.mesh_shape}), backend {args.backend}")
        done, ticks, dt = spawn(
            _serve_rank, args.devices, args.backend,
            device="cpu" if args.device == "cpu" else "cuda",
            args=(cfg, args))[0]
    else:
        done, ticks, dt = _serve(cfg, args)
    toks = sum(len(r.out) for r in done)
    lat = [r.done_at - r.submitted_at for r in done]
    print(f"served {len(done)}/{args.requests} requests, "
          f"{toks} tokens in {ticks} ticks / {dt:.1f}s "
          f"({toks/max(dt,1e-9):.1f} tok/s), "
          f"mean latency {np.mean(lat):.2f}s")


if __name__ == "__main__":
    main()
