"""Rank programs of the port's SPMD tests (``tests/test_torch_spmd_*.py``).

Each function runs inside one rank started by
``repro_torch.launch.mesh.spawn``: it builds the mesh, runs a group of
cases on its rank's inputs and returns numpy results per case.  This
module imports torch, numpy and ``repro_torch`` only, so a rank never
loads JAX; the tests compare the results with the JAX package in the
pytest process.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from repro_torch.launch.mesh import make_test_mesh

T, S, MEM = 8, 2, 16


def _np(t):
    return t.detach().cpu().numpy()


def loaded_modules(rank):
    """The ``jax*`` and ``repro`` / ``repro.*`` modules a rank holds."""
    return sorted(n for n in sys.modules
                  if n == "jax" or n.startswith(("jax.", "jaxlib"))
                  or n == "repro" or n.startswith("repro."))


# ---------------------------------------------------------------------------
# core: routing, pgas + endpoint, token queue channel, sync
# ---------------------------------------------------------------------------

def core_routing(rank, inputs):
    from repro_torch.core import routing
    mesh = make_test_mesh((2, 4), ("y", "x"))
    t = lambda name: torch.from_numpy(inputs[name][rank])   # noqa: E731
    out = {
        "a2a_flat_transpose": routing.xy_all_to_all(
            t("a2a_flat_transpose"), mesh, "x", "y", split_axis=0),
        "a2a_split_axis_1": routing.xy_all_to_all(
            t("a2a_split_axis_1"), mesh, "x", "y", split_axis=1),
        "a2a_two_blocks_per_tile": routing.xy_all_to_all(
            t("a2a_two_blocks_per_tile"), mesh, "x", "y", split_axis=0),
        "all_reduce": routing.xy_all_reduce(t("all_reduce"), mesh, "x", "y"),
        "reduce_scatter": routing.xy_reduce_scatter(
            t("reduce_scatter_gather"), mesh, "x", "y", 0),
        "reduce_scatter_gather": routing.xy_all_gather(
            routing.xy_reduce_scatter(t("reduce_scatter_gather"), mesh,
                                      "x", "y", 0), mesh, "x", "y", 0),
        "shift": routing.shift(t("shift"), mesh, "x", 1),
        "shift_y_back": routing.shift(t("shift"), mesh, "y", -1),
        "axis_all_to_all": routing.axis_all_to_all(
            t("axis_all_to_all"), mesh, "x", 0, 1),
    }
    out = {k: _np(v) for k, v in out.items()}
    try:
        routing.xy_all_to_all(torch.zeros(7), mesh, "x", "y")
        out["bad_split_raises"] = np.array(False)
    except ValueError:
        out["bad_split_raises"] = np.array(True)
    return out


def core_pgas(rank, inputs):
    from repro_torch.core import endpoint as ep
    from repro_torch.core import pgas
    mesh = make_test_mesh((2, 4), ("y", "x"))
    me = pgas.tile_linear_index(mesh, "x", "y")
    assert me == rank
    zeros = torch.zeros(MEM)
    out = {}

    # every tile stores its id + 1 into every tile at addr = its id
    pk = pgas.PacketBatch(
        addr=torch.full((T, S), me, dtype=torch.int32),
        data=torch.full((T, S), me + 1.0),
        mask=torch.ones((T, S), dtype=torch.bool).index_fill(
            1, torch.tensor([1]), False))
    mem, credits = pgas.remote_store(zeros, pk, mesh, "x", "y")
    out["store_delivers_and_credits"] = (_np(mem), _np(credits))

    pk = pgas.PacketBatch(
        addr=torch.zeros((T, S), dtype=torch.int32),
        data=torch.stack([torch.full((T,), 10.0), torch.full((T,), 20.0)],
                         1),
        mask=torch.ones((T, S), dtype=torch.bool))
    out["store_slot_order"] = _np(pgas.remote_store(zeros, pk, mesh, "x",
                                                    "y")[0])

    r = inputs["store_random"]
    pk = pgas.PacketBatch(addr=torch.from_numpy(r["addr"][rank]),
                          data=torch.from_numpy(r["data"][rank]),
                          mask=torch.from_numpy(r["mask"][rank]))
    mem, credits = pgas.remote_store(torch.from_numpy(r["mem"][rank]), pk,
                                     mesh, "x", "y")
    out["store_random"] = (_np(mem), _np(credits))

    mem = zeros.clone()
    mem[0], mem[1] = me * 100.0, me * 100.0 + 1
    pk = pgas.PacketBatch(
        addr=torch.tensor([0, 1], dtype=torch.int32).expand(T, S),
        data=torch.zeros((T, S)), mask=torch.ones((T, S), dtype=torch.bool))
    data, valid = pgas.remote_load(mem, pk, mesh, "x", "y")
    out["load_request_order"] = (_np(data), _np(valid))

    r = inputs["load_random"]
    pk = pgas.PacketBatch(addr=torch.from_numpy(r["addr"][rank]),
                          data=torch.zeros(r["addr"][rank].shape),
                          mask=torch.from_numpy(r["mask"][rank]))
    data, valid = pgas.remote_load(torch.from_numpy(r["mem"][rank]), pk,
                                   mesh, "x", "y")
    out["load_random"] = (_np(data), _np(valid))

    pk = pgas.PacketBatch(
        addr=torch.zeros((T, 1), dtype=torch.int32),
        data=torch.full((T, 1), me + 1.0),
        mask=(torch.arange(T) == 3)[:, None])
    mem, old = pgas.remote_cas(zeros, pk, torch.zeros((T, 1)), mesh, "x",
                               "y")
    out["cas_single_winner"] = (_np(mem), _np(old[3, 0] == 0.0))

    state = ep.make_endpoint(MEM, max_out_credits=3)
    pk = pgas.PacketBatch(
        addr=torch.arange(5, dtype=torch.int32).expand(T, 5).contiguous(),
        data=torch.ones((T, 5)),
        mask=(torch.arange(T) == 0)[:, None] & torch.ones((T, 5),
                                                          dtype=torch.bool))
    state, sent = ep.master_store(state, pk, mesh, "x", "y")
    out["endpoint_credit_limit_and_fence"] = (_np(sent.sum()),
                                              _np(ep.fence(state)),
                                              _np(state.mem))

    state = ep.freeze(ep.make_endpoint(MEM, max_out_credits=8))
    pk = pgas.PacketBatch(addr=torch.zeros((T, 1), dtype=torch.int32),
                          data=torch.ones((T, 1)),
                          mask=torch.ones((T, 1), dtype=torch.bool))
    state, sent = ep.master_store(state, pk, mesh, "x", "y")
    out["frozen_endpoint_sends_nothing"] = (_np(sent.sum()), _np(state.mem))
    unfrozen = ep.unfreeze(state)
    out["unfreeze"] = _np(unfrozen.frozen)
    return out


def core_channel(rank, inputs):
    from repro_torch.core import token_queue as tq
    mesh = make_test_mesh((2, 4), ("y", "x"))
    local = torch.from_numpy(inputs[rank])
    fwd = tq.channel_send(local, mesh, "x")
    back = tq.channel_recv(fwd, mesh, "x")
    return {"channel_ring": (_np(fwd), _np(back))}


def core_sync(rank, inputs):
    from repro_torch.core import sync
    mesh = make_test_mesh((2, 4), ("y", "x"))
    zeros = torch.zeros(MEM)
    m1, acquired = sync.mutex_try_acquire(zeros, 5, 0, mesh, "x", "y", T)
    m2 = sync.mutex_release(m1, 5, 0, acquired, mesh, "x", "y", T)
    mem = sync.barrier_arrive(zeros, 0, 0, mesh, "x", "y", T)
    return {"mutex": (_np(m1), _np(m2), _np(acquired)),
            "barrier": (_np(mem), _np(sync.barrier_done(mem, 0, T))),
            "spmd_barrier": _np(sync.spmd_barrier(mesh, "x", "y"))}


# ---------------------------------------------------------------------------
# models: forward, decode and the Server on a (data 2, model 4) mesh
# ---------------------------------------------------------------------------

def _model(cfg, params, rules):
    from repro_torch.models import get_model
    from repro_torch.models.convert import params_from_jax, shard_params
    full = params_from_jax(cfg, params, device="cpu")
    return get_model(cfg)(cfg, device="cpu",
                          params=shard_params(cfg, full, rules), rules=rules)


def model_forwards(rank, cases, shape=(2, 4)):
    """{name: (logits, aux)} of each case (name, cfg, params, tokens,
    positions or None, rule overrides[, {keyword: array} more inputs, as
    Whisper's ``frames``]) through the sharded forward."""
    from repro_torch.models import moe
    from repro_torch.parallel.sharding import Rules
    mesh = make_test_mesh(shape, ("data", "model"))
    out = {}
    for name, cfg, params, tokens, positions, overrides, *more in cases:
        rules = Rules(mesh=mesh, **overrides)
        model = _model(cfg, params, rules)
        pos = None if positions is None else torch.from_numpy(positions)
        kw = {k: torch.from_numpy(v) for k, v in
              (more[0] if more else {}).items()}
        with torch.no_grad(), moe.counting_drops() as drops:
            logits, aux = model(torch.from_numpy(tokens), positions=pos,
                                **kw)
            last, _ = model(torch.from_numpy(tokens), positions=pos,
                            last_only=True, **kw)
        out[name] = (_np(logits), _np(aux), _np(last),
                     int(sum(int(d) for d in drops)))
    out["modules"] = loaded_modules(rank)
    out["round trip"] = _round_trip(cases, mesh)
    return out


def _round_trip(cases, mesh):
    """Per case: this rank's blocks have ``shard_table``'s shapes,
    ``gather_params`` of them is the full parameters, exactly, and
    ``init_params(..., rules=)`` draws the blocks of the full draw."""
    from repro_torch.models import get_model
    from repro_torch.models.convert import (gather_params, init_params,
                                            params_from_jax, shard_params)
    from repro_torch.parallel.sharding import Rules
    ok = {}
    for name, cfg, params, _tokens, _positions, overrides, *_ in cases:
        rules = Rules(mesh=mesh, **overrides)
        full = params_from_jax(cfg, params, device="cpu")
        shard = shard_params(cfg, full, rules)
        table = get_model(cfg).shard_table(cfg, rules)
        back = gather_params(cfg, shard, rules)
        drawn = init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                            rules=rules)
        whole = shard_params(cfg, init_params(
            cfg, torch.Generator().manual_seed(0), "cpu"), rules)
        ok[name] = all(tuple(shard[k].shape) == table[k]
                       and torch.equal(back[k], full[k])
                       and torch.equal(drawn[k], whole[k]) for k in full)
    return ok


def model_decodes(rank, cases, shape=(2, 4)):
    """{name: [(logits, cache leaves gathered), ...] per step} of each case
    (name, cfg, params, per-step tokens (steps, B), max_seq, rule
    overrides[, the global encoder output for Whisper's cross KV]) under
    ``cell_rules`` of a decode cell, as the ``Server`` builds them.  The
    leaves gathered are those of the family's ``cache_specs``."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.step import cell_rules
    from repro_torch.parallel.sharding import join_blocks
    mesh = make_test_mesh(shape, ("data", "model"))
    out = {}
    for name, cfg, params, steps, max_seq, overrides, *enc in cases:
        B = steps.shape[1]
        rules = cell_rules(mesh, cfg, ShapeConfig("d", max_seq, B,
                                                  "decode"), **overrides)
        model = _model(cfg, params, rules)
        kw = {"enc_out": torch.from_numpy(enc[0])} if enc else {}
        cache = model.init_cache(B, max_seq, **kw)
        specs = model.cache_specs(cfg, rules)
        got = []
        for tok in steps:
            logits, cache = model.decode_step(cache, torch.from_numpy(tok))
            whole = {k: _np(join_blocks(cache[k], spec, rules))
                     for k, spec in specs.items()}
            got.append((_np(logits), whole))
        out[name] = (got, rules._clean(rules.batch),
                     rules._clean(rules.kv_seq))
    out["modules"] = loaded_modules(rank)
    return out


def servers(rank, cases, shape=(2, 4)):
    """{name: (outputs per request, ticks)} of each case (name, cfg,
    params, prompts, slots, max_new, max_seq) through the mesh
    ``Server``."""
    from repro_torch.launch.serve import Request, Server
    from repro_torch.models.convert import params_from_jax
    mesh = make_test_mesh(shape, ("data", "model"))
    out = {}
    for name, cfg, params, prompts, slots, max_new, max_seq in cases:
        server = Server(cfg, slots=slots, max_seq=max_seq, device="cpu",
                        params=params_from_jax(cfg, params, device="cpu"),
                        mesh=mesh)
        for i, p in enumerate(prompts):
            server.submit(Request(rid=i, prompt=p, max_new=max_new))
        server.run(tick_limit=500)
        done = sorted(server.completed, key=lambda r: r.rid)
        out[name] = ([r.out for r in done], server.ticks)
    return out


def one_rank(rank, cfg, params, tokens, steps, max_seq):
    """A world of one rank (mesh 1 x 1): forward logits, and greedy decode
    steps through ``serve_step`` under ``cell_rules``."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.step import cell_rules, prefill_step, serve_step
    from repro_torch.parallel.sharding import Rules
    mesh = make_test_mesh((1, 1), ("data", "model"))
    model = _model(cfg, params, Rules(mesh=mesh))
    with torch.no_grad():
        logits, _ = model(torch.from_numpy(tokens))
    last = prefill_step(model, {"tokens": torch.from_numpy(tokens)},
                        model.rules)
    rules = cell_rules(mesh, cfg, ShapeConfig("d", max_seq, steps.shape[1],
                                              "decode"))
    model = _model(cfg, params, rules)
    cache = model.init_cache(steps.shape[1], max_seq)
    toks = []
    for tok in steps:
        nxt, cache = serve_step(model, cache, torch.from_numpy(tok), rules)
        toks.append(_np(nxt))
    return _np(logits), _np(last), np.stack(toks)


# ---------------------------------------------------------------------------
# training on a mesh: collectives' backward, gradients, optimizer, Trainer
# ---------------------------------------------------------------------------

def full_grads(model, rules):
    """Every parameter's gradient as the reference's ``value_and_grad``
    gives it: this rank's share summed over the axes its block is
    replicated on, then gathered to the full array."""
    from repro_torch.parallel import comm
    from repro_torch.parallel.sharding import join_blocks, replicated_axes
    specs = model.param_specs(model.cfg, rules)
    out = {}
    for name, p in model.named_parameters():
        g = p.grad
        red = replicated_axes(rules, specs[name])
        if red:
            g = comm.all_reduce(g, rules.mesh, red)
        out[name] = _np(join_blocks(g, specs[name], rules))
    return out


def _rules_of(mesh, cfg, case_rules):
    """``("rules", overrides)`` -> ``Rules``; ``("cell", shape,
    overrides)`` -> ``cell_rules`` of a training cell of that shape."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.step import cell_rules
    from repro_torch.parallel.sharding import Rules
    if case_rules[0] == "rules":
        return Rules(mesh=mesh, **case_rules[1])
    (S, B), overrides = case_rules[1], case_rules[2]
    return cell_rules(mesh, cfg, ShapeConfig("t", S, B, "train"),
                      **overrides)


def spmd_grads(rank, cases, shape=(2, 4), remats=("none", "full")):
    """{(name, remat): (loss, metrics, full gradients on rank 0, drops)}
    of each case (name, cfg, params, batch, rules spec[, its own
    remats]) through the mesh ``loss`` and its backward."""
    from repro_torch.models import moe
    from repro_torch.parallel import comm
    mesh = make_test_mesh(shape, ("data", "model"))
    out = {}
    for name, cfg, params, batch, case_rules, *own in cases:
        rules = _rules_of(mesh, cfg, case_rules)
        model = _model(cfg, params, rules)
        model.requires_grad_(True)
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        for remat in (own[0] if own else remats):
            for p in model.parameters():
                p.grad = None
            comm.reset_comm_stats()
            with moe.counting_drops() as drops:
                loss, metrics = model.loss(tb, remat=remat)
                loss.backward()
            grads = full_grads(model, rules)
            out[(name, remat)] = (
                float(loss), {k: float(v) for k, v in metrics.items()},
                grads if rank == 0 else None,
                int(sum(int(d) for d in drops)),
                sorted(k for k in comm.comm_stats() if k.endswith(".bwd")))
    out["modules"] = loaded_modules(rank)
    return out


def collective_vjps(rank, inputs):
    """Each collective's forward and backward on this rank's block of the
    inputs (``{case: (x, cotangent)}``) on the (y 2, x 4) mesh: {case:
    (y, x's gradient)}, plus the backward's counts."""
    from repro_torch.parallel import comm
    mesh = make_test_mesh((2, 4), ("y", "x"))
    fns = {
        "all_gather": lambda t: comm.all_gather(t, mesh, "x", 1),
        "all_gather yx": lambda t: comm.all_gather(t, mesh, ("y", "x"), 0),
        "psum_scatter": lambda t: comm.reduce_scatter(t, mesh, "x", 0),
        "psum": lambda t: comm.all_reduce(t, mesh, ("y", "x")),
        "psum y": lambda t: comm.all_reduce(t, mesh, "y"),
        "all_to_all": lambda t: comm.all_to_all(t, mesh, "x", 0),
        "all_to_all y": lambda t: comm.all_to_all(t, mesh, "y", 1),
        "ppermute": lambda t: comm.ppermute(t, mesh, "x",
                                            [(0, 1), (1, 2), (2, 0)]),
    }
    out = {}
    comm.reset_comm_stats()
    for case, fn in fns.items():
        x, ct = (torch.from_numpy(a[rank]) for a in inputs[case])
        x.requires_grad_(True)
        y = fn(x)
        (g,) = torch.autograd.grad(y, x, ct)
        out[case] = (_np(y), _np(g))
    ints = torch.from_numpy(inputs["ints"][rank])
    out["ints"] = _np(comm.all_to_all(ints, mesh, "x", 0))
    out["stats"] = comm.comm_stats()
    return out


def family_checks(rank, forward_cases, decode_cases):
    """:func:`model_forwards` (the round trips included) and
    :func:`model_decodes`, in one spawn."""
    return {"forward": model_forwards(rank, forward_cases),
            "decode": model_decodes(rank, decode_cases)}


def backward_checks(rank, vjp_inputs, grad_cases):
    """:func:`collective_vjps` on the (y 2, x 4) mesh, then
    :func:`spmd_grads` on (data 2, model 4), in one spawn."""
    return {"vjp": collective_vjps(rank, vjp_inputs),
            "grads": spmd_grads(rank, grad_cases)}


def family_training(rank, grad_cases, step_cases):
    """:func:`spmd_grads` of ``grad_cases``, then :func:`spmd_train_steps`
    of each step case (name, cfg, params, batches, strategies, opt), in
    one spawn: {"grads": ..., "steps": {name: ...}}."""
    return {"grads": spmd_grads(rank, grad_cases),
            "steps": {name: spmd_train_steps(rank, cfg, params, batches,
                                             strategies, opt)
                      for name, cfg, params, batches, strategies, opt
                      in step_cases}}


def spmd_train_steps(rank, cfg, params, batches, strategies, opt):
    """{strategy: (per-step metrics, full parameters and optimizer state
    after the steps (rank 0; None elsewhere), this rank's parameter and
    state bytes)}: ``train_step`` on the (data 2, model 4) mesh under
    ``cell_rules`` of each strategy, from the reference's parameters."""
    from repro_torch import optim
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.step import cell_rules, train_step
    from repro_torch.models.convert import gather_opt_state, gather_params
    mesh = make_test_mesh((2, 4), ("data", "model"))
    B, S = batches[0]["tokens"].shape
    out = {}
    for strategy in strategies:
        rules = cell_rules(mesh, cfg, ShapeConfig("t", S, B, "train"),
                           strategy)
        model = _model(cfg, params, rules)
        model.requires_grad_(True)
        held = dict(model.named_parameters())
        state = optim.init(held, rules=rules,
                           specs=model.param_specs(cfg, rules))
        metrics = []
        for b in batches:
            m = train_step(model, optim.OptConfig(**opt), state,
                           {k: torch.from_numpy(v) for k, v in b.items()},
                           rules.remat, rules)
            metrics.append({k: float(v) for k, v in m.items()})
        full = gather_params(cfg, {k: p.detach() for k, p in held.items()},
                             rules)
        st = gather_opt_state(cfg, state, rules)
        nbytes = lambda ts: sum(t.numel() * t.element_size()  # noqa: E731
                                for t in ts)
        out[strategy] = (
            metrics,
            None if rank else ({k: _np(v) for k, v in full.items()},
                               {p: {k: _np(v) for k, v in st[p].items()}
                                for p in ("master", "m", "v")},
                               int(st["step"])),
            nbytes(held.values()),
            nbytes([t for p in ("master", "m", "v")
                    for t in state[p].values()]))
    return out


def spmd_trainers(rank, cfg, p0, opt, dirs, shape=(2, 4)):
    """The mesh ``Trainer`` (baseline) from the full parameters ``p0`` on
    the deterministic stream, ``{scenario: ...}``:

    * ``run``: 6 steps, checkpoints at 3 and 6 under ``dirs["run"]``:
      (losses, events, full parameters and state at 6 on rank 0);
    * ``resume``: step 3 of that run (copied alone to ``dirs["resume"]``)
      resumed and run to 6: (losses, full parameters at 6 on rank 0);
    * ``fault every rank`` / ``fault rank 0``: 4 steps with one fault
      at step 2 on every rank / at step 1 on rank 0 only: (losses,
      events);
    * ``from one card``: ``dirs["one card"]`` (written by the single-card
      ``Trainer``) restored: (step, full parameters and state on rank 0);
    * ``shrink`` / ``grow``: :func:`elastic` from (2, 4) to (1, 4) and
      back the other way, checkpoints under ``dirs["elastic"]``.
    """
    import shutil
    import torch.distributed as dist
    from repro_torch import optim
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import batch_iterator
    from repro_torch.models.convert import (gather_opt_state, gather_params,
                                            params_from_jax)
    from repro_torch.runtime import FaultInjector, Trainer, TrainerConfig
    mesh = make_test_mesh(shape, ("data", "model"))
    SHAPE = ShapeConfig("t", seq_len=32, global_batch=8, kind="train")

    def full():          # fresh tensors: a trainer updates what it holds
        return params_from_jax(cfg, p0, "cpu")

    def trainer(steps, ckpt_dir, faults=None, on=None):
        return Trainer(cfg, SHAPE, optim.OptConfig(**opt), TrainerConfig(
            total_steps=steps, ckpt_every=3, ckpt_dir=ckpt_dir,
            log_every=100), fault_injector=FaultInjector(faults or {}),
            mesh=on or mesh)

    def run(tr, close=True):
        losses = []
        tr.run(batch_iterator(cfg, SHAPE, start_step=tr.step),
               on_step=lambda s, m: losses.append(float(m["loss"])))
        if close:
            tr.close()
        return losses

    def whole(tr):
        p = gather_params(cfg, {k: v.detach() for k, v in
                                tr.model.named_parameters()}, tr.rules)
        st = gather_opt_state(cfg, tr.opt_state, tr.rules)
        if rank:
            return None
        return ({k: _np(v) for k, v in p.items()},
                {q: {k: _np(v) for k, v in st[q].items()}
                 for q in ("master", "m", "v")})

    out = {}
    tr = trainer(6, dirs["run"]).init(params=full())
    losses = run(tr)
    out["run"] = (losses, tr.events, whole(tr))
    if rank == 0:
        shutil.copytree(f"{dirs['run']}/step_00000003",
                        f"{dirs['resume']}/step_00000003")
    dist.barrier()
    tr = trainer(6, dirs["resume"]).resume_or_init()
    step = tr.step
    out["resume"] = (step, run(tr), whole(tr))
    tr = trainer(4, None, {2: 1}).init(params=full())
    out["fault every rank"] = (run(tr), tr.events)
    tr = trainer(4, None, {1: 1} if rank == 0 else {}).init(params=full())
    out["fault rank 0"] = (run(tr), tr.events)
    tr = trainer(6, dirs["one card"]).resume_or_init()
    out["from one card"] = (tr.step, whole(tr))
    tr.close()
    for case, (a, b) in (("shrink", ((2, 4), (1, 4))),
                         ("grow", ((1, 4), (2, 4)))):
        out[case] = elastic(rank, a, b, f"{dirs['elastic']}/{case}", full,
                            trainer, run, whole)
    out["modules"] = loaded_modules(rank)
    return out


def elastic(rank, shape_a, shape_b, ckpt_dir, full, trainer, run, whole):
    """2 steps on a mesh of ``shape_a``, ``reshard`` to one of
    ``shape_b`` (each on the first ranks of the world), 2 more steps;
    then the last checkpoint (written on the new mesh) resumed there:
    (losses, events, full state at 4 on rank 0, this rank's activity
    before and after, the resumed step and full state on rank 0)."""
    def mesh_of(shape):
        n = shape[0] * shape[1]
        return make_test_mesh(shape, ("data", "model"), ranks=range(n))
    mesh_a, mesh_b = mesh_of(shape_a), mesh_of(shape_b)
    tr = trainer(2, ckpt_dir, on=mesh_a)
    tr.init(params=full())
    losses = run(tr, close=False)
    active = [tr.active]
    tr.reshard(mesh_b)
    active.append(tr.active)
    tr.tcfg.total_steps = 4
    losses += run(tr, close=False)
    state = whole(tr) if tr.active else None
    tr.close()
    tr2 = trainer(4, ckpt_dir, on=mesh_b).resume_or_init()
    resumed = (tr2.step, whole(tr2) if tr2.active else None)
    tr2.close()
    return losses, tr.events, state, active, resumed


# ---------------------------------------------------------------------------
# the rest of SPMD training: compressed cross-pod reduction, the pipeline
# ---------------------------------------------------------------------------

def spmd_compress(rank, psum_x, rounds):
    """``cross_pod_psum`` over ``data`` on the (data 2, model 4) mesh:
    {"psum int8": this rank's (1, 8) row of the reference test's sum,
    (mode, round): (the sum, this rank's new residual)} with error
    feedback carried over ``rounds`` (each {"g": per-rank gradients})."""
    from repro_torch import optim
    from repro_torch.parallel import comm
    mesh = make_test_mesh((2, 4), ("data", "model"))
    d = mesh.index("data")
    out = {}
    x = torch.from_numpy(psum_x[d:d + 1])
    out["psum int8"] = _np(optim.cross_pod_psum(x, mesh, "data", "int8")[0])
    for mode in ("int8", "bf16"):
        err = optim.init_error_state(
            {"g": torch.zeros(rounds[0].shape[1:])})["g"]
        for i, g in enumerate(rounds):
            s, err = optim.cross_pod_psum(torch.from_numpy(g[rank]), mesh,
                                          "data", mode, err)
            out[(mode, i)] = (_np(s), _np(err))
    comm.reset_comm_stats()
    optim.cross_pod_psum(torch.from_numpy(rounds[0][rank]), mesh, "data",
                         "int8")
    out["stats"] = comm.comm_stats()
    out["modules"] = loaded_modules(rank)
    return out


def _tanh_body(lp, x):
    """The reference test's stage body: this stage's layers, tanh(h @ w)."""
    for w in lp:
        x = torch.tanh(x @ w)
    return x


def spmd_pipelines(rank, w, x, tf):
    """``pipeline_apply`` on the (data 2, model 4) mesh, stages over
    ``model``, rows over ``data``:

    * ``tanh``: the reference test's tanh MLP (w (L, D, D), x (n_micro,
      mb, D)): (this rank's outputs, its stage's gradient of the outputs'
      sum summed over ``data``, the hop counts);
    * ``transformer``: ``tf`` = (cfg, params, x): the tiny transformer's
      layers (``layer_apply``, the kernels' plain versions) as the stage
      body, the outputs and its stage's gradients likewise.
    """
    from repro_torch.models.transformer import layer_apply
    from repro_torch.parallel import comm
    from repro_torch.parallel.pipeline import pipeline_apply
    mesh = make_test_mesh((2, 4), ("data", "model"))
    S, d, s = mesh.axis_size("model"), mesh.index("data"), mesh.index("model")
    out = {}

    def rows(a):
        mb = a.shape[1] // mesh.axis_size("data")
        return torch.from_numpy(np.ascontiguousarray(
            a[:, d * mb:(d + 1) * mb]))

    ws = torch.from_numpy(np.ascontiguousarray(
        w.reshape(S, -1, *w.shape[1:])[s])).requires_grad_(True)
    comm.reset_comm_stats()
    y = pipeline_apply(_tanh_body, ws, rows(x), mesh, "model", "data")
    y.sum().backward()
    stats = comm.comm_stats()
    out["tanh"] = (_np(y), _np(comm.all_reduce(ws.grad, mesh, "data")),
                   {k: stats[k]["calls"] for k in ("ppermute",
                                                   "ppermute.bwd")})
    cfg, params, tx = tf
    L = cfg.num_layers
    stage = {k.split("/", 1)[1]: torch.from_numpy(np.ascontiguousarray(
        v.reshape(S, L // S, *v.shape[1:])[s])).requires_grad_(True)
        for k, v in params.items() if k.startswith("layers/")}
    xm = rows(tx)
    pos = torch.arange(xm.shape[2], dtype=torch.int32).expand(xm.shape[1],
                                                              xm.shape[2])

    def body(sp, h):
        for i in range(L // S):
            h = layer_apply(h, {k: v[i] for k, v in sp.items()}, cfg,
                            pos)[0]
        return h
    y = pipeline_apply(body, stage, xm, mesh, "model", "data")
    y.sum().backward()
    out["transformer"] = (_np(y), {k: _np(comm.all_reduce(v.grad, mesh,
                                                          "data"))
                                   for k, v in stage.items()})
    out["modules"] = loaded_modules(rank)
    return out


# ---------------------------------------------------------------------------
# costing: a real step's counts against the same cell's dry run
# ---------------------------------------------------------------------------

def _count_summary(got):
    """What a counted run did, as plain data: comm_stats, phase_stats,
    the kernel records, the collective calls, the aten ops outside
    kernels and the cost."""
    return {"comm": got.comm_stats, "phases": got.phase_stats,
            "records": [dict(r) for r in got.records], "calls": got.calls,
            "ops": got.ops, "cost": got.cost}


def costing_cells(rank, cases, shape=(2, 4)):
    """{name: {"real": summary, "dry": summary}} of each case (name, cfg,
    ShapeConfig, strategy, rule overrides, {input: array}): the cell
    built by ``build_cell`` on the real (data 2, model 4) mesh from
    ``init_params`` and run once under ``costing.count_cost``, then the
    same cell on ``Mesh.dry`` of the same shape at this rank's
    coordinates (``meta``), counted the same way.  Then the first case's
    real cell runs once more outside any count: ``"after"`` holds the
    collectives it counted and how many call lists were left open."""
    from repro_torch.launch import costing
    from repro_torch.launch.step import build_cell, cell_rules
    from repro_torch.models.convert import init_params
    from repro_torch.parallel import comm
    from repro_torch.parallel.comm import Mesh
    axes = ("data", "model")
    mesh = make_test_mesh(shape, axes)
    out = {"modules": loaded_modules(rank)}
    cells = []
    for name, cfg, shp, strategy, overrides, arrays in cases:
        rules = cell_rules(mesh, cfg, shp, strategy, **overrides)
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                             rules=rules)
        t = {k: torch.from_numpy(v) for k, v in arrays.items()}
        inputs = {"tokens": t["tokens"]} if shp.kind == "decode" else \
            {"batch": t}
        real = build_cell(cfg, shp, mesh, strategy, params=params,
                          inputs=inputs, **overrides)
        dry = build_cell(cfg, shp, Mesh.dry(shape, axes, rank), strategy,
                         **overrides)
        out[name] = {
            "real": _count_summary(costing.count_cost(real.run,
                                                      keep_ops=True)),
            "dry": _count_summary(costing.count_cost(dry.run,
                                                     keep_ops=True))}
        cells.append(real)
    comm.reset_comm_stats()
    cells[0].run()
    out["after"] = {"calls": sum(v["calls"]
                                 for v in comm.comm_stats().values()),
                    "open_lists": len(comm._LISTS)}
    return out


# ---------------------------------------------------------------------------
# the examples: the five rank examples of examples/torch_*.py in one world
# ---------------------------------------------------------------------------

def examples(rank, plan):
    """Each rank example's rank function in turn, on the CPU, at the
    sizes of ``plan`` (the example modules import by name: their
    directory is on the parent's ``sys.path``, which the ranks inherit):
    {example: its rank's result}, and the modules this rank loaded."""
    import torch_pgas_scatter_gather as pgas_ex
    import torch_pipeline_parallel as pipe_ex
    import torch_quickstart as quick_ex
    import torch_serve_decode as serve_ex
    import torch_train_lm as train_ex
    return {
        "pgas": pgas_ex.pgas_rank(rank, "cpu"),
        "pipeline": pipe_ex.pipeline_rank(rank, "cpu"),
        "quickstart": quick_ex.quickstart_rank(rank, "cpu",
                                               **plan["quickstart"]),
        "serve": serve_ex.serve_rank(rank, "cpu"),
        "train_lm": train_ex.train_rank(rank, "cpu", **plan["train_lm"]),
        "modules": loaded_modules(rank)}
