"""The port's SPMD mechanisms (``repro_torch.core``) against ``repro.core``
on a (y 2, x 4) mesh.

The JAX side runs in this process on the conftest's ``mesh2x4`` (8 CPU
devices, ``shard_map``); the port runs as 8 gloo ranks in the same layout
(``repro_torch.launch.mesh.spawn``, one spawn per reference module: the
routing collectives, PGAS with the endpoint, the token-queue channel,
the sync primitives), on the same inputs from a numpy seed.  Rank ``r``
is tile ``r`` = (y, x) = (r // 4, r % 4) on both sides.  The cases are
those of ``tests/test_routing.py``, ``test_pgas.py``,
``test_token_queue.py`` (the local queue and the distributed channel),
``test_sync.py`` and ``test_coords.py``, plus random stores and loads.
Integer and boolean results must be equal; float results within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import torch_spmd_ranks as ranks
from repro.compat import shard_map
from repro.core import coords as j_coords
from repro.core import credits as j_credits
from repro.core import endpoint as j_ep
from repro.core import pgas as j_pgas
from repro.core import routing as j_routing
from repro.core import sync as j_sync
from repro.core import token_queue as j_tq
from repro_torch.core import coords, credits, routing, token_queue
from repro_torch.launch.mesh import spawn

T, S, MEM = ranks.T, ranks.S, ranks.MEM
TILES = P(("y", "x"))


def _sm(mesh, fn, *args, in_specs, out_specs):
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs))(*args)


def _stack(results, case):
    """Per-rank results of ``case`` stacked on a leading tile axis (a
    tuple of results stacked field by field)."""
    first = results[0][case]
    if isinstance(first, tuple):
        return tuple(np.stack([r[case][i] for r in results])
                     for i in range(len(first)))
    return np.stack([r[case] for r in results])


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want.astype(got.dtype))


# ---------------------------------------------------------------------------
# routing (C4)
# ---------------------------------------------------------------------------

def _routing_inputs():
    rng = np.random.default_rng(0)
    return {
        "a2a_flat_transpose": rng.standard_normal((T, T, 3), np.float32),
        "a2a_split_axis_1": rng.integers(0, 1000, (T, 2, T), np.int32),
        "a2a_two_blocks_per_tile": rng.integers(0, 1000, (T, 2 * T),
                                                np.int32),
        "all_reduce": rng.standard_normal((T, 4), np.float32),
        "reduce_scatter_gather": rng.standard_normal((T, 2 * T),
                                                     np.float32),
        "shift": rng.integers(0, 1000, (T, 1), np.int32),
        "axis_all_to_all": rng.standard_normal((T, 4, 3), np.float32),
    }


@pytest.fixture(scope="module")
def routing_run():
    inputs = _routing_inputs()
    return inputs, spawn(ranks.core_routing, T, "gloo", args=(inputs,))


def _jax_routing(mesh, case, inputs):
    """The reference's result of ``case`` on the same inputs, stacked
    over tiles."""
    spec3 = P(("y", "x"), None, None)

    def per_tile(f, x, ndim):
        spec = P(("y", "x"), *([None] * (ndim - 1)))
        return np.asarray(_sm(mesh, lambda l: f(l[0])[None], x,
                              in_specs=spec, out_specs=spec))

    x = jnp.asarray(inputs[{"reduce_scatter": "reduce_scatter_gather",
                            "shift_y_back": "shift"}.get(case, case)])
    if case == "a2a_flat_transpose":
        return per_tile(lambda l: j_routing.xy_all_to_all(l, "x", "y"), x, 3)
    if case == "a2a_split_axis_1":
        return per_tile(lambda l: j_routing.xy_all_to_all(
            l, "x", "y", split_axis=1), x, 3)
    if case == "a2a_two_blocks_per_tile":
        return per_tile(lambda l: j_routing.xy_all_to_all(l, "x", "y"), x, 2)
    if case == "all_reduce":
        return np.asarray(_sm(mesh, lambda l: j_routing.xy_all_reduce(
            l, "x", "y"), x, in_specs=P(("y", "x"), None),
            out_specs=P(("y", "x"), None)))
    if case == "reduce_scatter":
        return per_tile(lambda l: j_routing.xy_reduce_scatter(l, "x", "y", 0),
                        x, 2)
    if case == "reduce_scatter_gather":
        return per_tile(lambda l: j_routing.xy_all_gather(
            j_routing.xy_reduce_scatter(l, "x", "y", 0), "x", "y", 0), x, 2)
    if case == "shift":
        return np.asarray(_sm(mesh, lambda l: j_routing.shift(l, "x", 1), x,
                              in_specs=TILES, out_specs=TILES))
    if case == "shift_y_back":
        return np.asarray(_sm(mesh, lambda l: j_routing.shift(l, "y", -1), x,
                              in_specs=TILES, out_specs=TILES))
    if case == "axis_all_to_all":
        return np.asarray(_sm(
            mesh, lambda l: j_routing.axis_all_to_all(l[0], "x", 0, 1)[None],
            x, in_specs=spec3, out_specs=spec3))
    raise KeyError(case)


ROUTING_CASES = ["a2a_flat_transpose", "a2a_split_axis_1",
                 "a2a_two_blocks_per_tile", "all_reduce", "reduce_scatter",
                 "reduce_scatter_gather", "shift", "shift_y_back",
                 "axis_all_to_all"]


@pytest.mark.parametrize("case", ROUTING_CASES)
def test_routing_matches_reference(mesh2x4, routing_run, case):
    inputs, results = routing_run
    _same(_stack(results, case), _jax_routing(mesh2x4, case, inputs))


def test_routing_rejects_bad_split_and_cost_model_is_the_reference(
        routing_run):
    _inputs, results = routing_run
    assert all(bool(r["bad_split_raises"]) for r in results)
    for b, k, bw in [(1e6, 1, 50e9), (1e6, 4, 50e9), (3.5e5, 16, 25e9)]:
        for torus in (True, False):
            assert routing.a2a_phase_cost(b, k, bw, torus=torus) == \
                j_routing.a2a_phase_cost(b, k, bw, torus=torus)
            assert routing.allreduce_cost(b, k, bw, torus=torus) == \
                j_routing.allreduce_cost(b, k, bw, torus=torus)
    for n, s in [(4, 1), (8, -1), (5, 3)]:
        assert routing.ring_neighbors(n, s) == j_routing.ring_neighbors(n, s)


# ---------------------------------------------------------------------------
# PGAS and the endpoint (C1, C3, C5)
# ---------------------------------------------------------------------------

def _pgas_inputs():
    rng = np.random.default_rng(1)
    # random stores: each source writes a random subset of its own
    # addresses src*S + s at every destination (no two sources collide)
    src = np.arange(T)[:, None, None]
    store = {"addr": np.broadcast_to(src * S + np.arange(S)[None, None],
                                     (T, T, S)).astype(np.int32).copy(),
             "data": rng.standard_normal((T, T, S), np.float32),
             "mask": rng.random((T, T, S)) < 0.6,
             "mem": rng.standard_normal((T, MEM), np.float32)}
    load = {"addr": rng.integers(-2, MEM + 2, (T, T, 3), np.int32),
            "mask": rng.random((T, T, 3)) < 0.7,
            "mem": rng.standard_normal((T, MEM), np.float32)}
    return {"store_random": store, "load_random": load}


@pytest.fixture(scope="module")
def pgas_run():
    inputs = _pgas_inputs()
    return inputs, spawn(ranks.core_pgas, T, "gloo", args=(inputs,))


def _jax_pgas(mesh, case, inputs):
    row = P(("y", "x"), None)
    zeros = jnp.zeros((T, MEM), jnp.float32)
    if case == "store_delivers_and_credits":
        def f(mem):
            me = j_pgas.tile_linear_index("x", "y")
            pk = j_pgas.PacketBatch(
                addr=jnp.broadcast_to(me, (T, S)).astype(jnp.int32),
                data=jnp.broadcast_to(me.astype(jnp.float32) + 1, (T, S)),
                mask=jnp.ones((T, S), bool).at[:, 1].set(False))
            m, c = j_pgas.remote_store(mem[0], pk, "x", "y")
            return m[None], c[None]
        return _sm(mesh, f, zeros, in_specs=row, out_specs=(row, row))
    if case == "store_slot_order":
        def f(mem):
            pk = j_pgas.PacketBatch(
                addr=jnp.zeros((T, S), jnp.int32),
                data=jnp.stack([jnp.full((T,), 10.0), jnp.full((T,), 20.0)],
                               1),
                mask=jnp.ones((T, S), bool))
            return j_pgas.remote_store(mem[0], pk, "x", "y")[0][None]
        return _sm(mesh, f, zeros, in_specs=row, out_specs=row)
    if case == "store_random":
        r = inputs[case]
        spec3 = P(("y", "x"), None, None)

        def f(mem, addr, data, mask):
            pk = j_pgas.PacketBatch(addr=addr[0], data=data[0], mask=mask[0])
            m, c = j_pgas.remote_store(mem[0], pk, "x", "y")
            return m[None], c[None]
        return _sm(mesh, f, r["mem"], r["addr"], r["data"], r["mask"],
                   in_specs=(row, spec3, spec3, spec3),
                   out_specs=(row, row))
    if case == "load_request_order":
        spec3 = P(("y", "x"), None, None)

        def f(mem):
            me = j_pgas.tile_linear_index("x", "y")
            mem = mem[0].at[0].set(me.astype(jnp.float32) * 100)
            mem = mem.at[1].set(me.astype(jnp.float32) * 100 + 1)
            pk = j_pgas.PacketBatch(
                addr=jnp.broadcast_to(jnp.array([0, 1], jnp.int32), (T, S)),
                data=jnp.zeros((T, S), jnp.float32),
                mask=jnp.ones((T, S), bool))
            d, v = j_pgas.remote_load(mem, pk, "x", "y")
            return d[None], v[None]
        return _sm(mesh, f, zeros, in_specs=row, out_specs=(spec3, spec3))
    if case == "load_random":
        r = inputs[case]
        spec3 = P(("y", "x"), None, None)

        def f(mem, addr, mask):
            pk = j_pgas.PacketBatch(addr=addr[0],
                                    data=jnp.zeros(addr[0].shape),
                                    mask=mask[0])
            d, v = j_pgas.remote_load(mem[0], pk, "x", "y")
            return d[None], v[None]
        return _sm(mesh, f, r["mem"], r["addr"], r["mask"],
                   in_specs=(row, spec3, spec3), out_specs=(spec3, spec3))
    if case == "cas_single_winner":
        def f(mem):
            me = j_pgas.tile_linear_index("x", "y")
            pk = j_pgas.PacketBatch(
                addr=jnp.zeros((T, 1), jnp.int32),
                data=jnp.broadcast_to(me.astype(jnp.float32) + 1, (T, 1)),
                mask=(jnp.arange(T) == 3)[:, None])
            m, old = j_pgas.remote_cas(mem[0], pk, jnp.zeros((T, 1)), "x",
                                       "y")
            return m[None], (old[3, 0] == 0.0)[None]
        return _sm(mesh, f, zeros, in_specs=row, out_specs=(row, TILES))
    if case == "endpoint_credit_limit_and_fence":
        def f(_):
            st = j_ep.make_endpoint(MEM, max_out_credits=3)
            pk = j_pgas.PacketBatch(
                addr=jnp.broadcast_to(jnp.arange(5, dtype=jnp.int32),
                                      (T, 5)),
                data=jnp.ones((T, 5), jnp.float32),
                mask=(jnp.arange(T) == 0)[:, None] & jnp.ones((T, 5), bool))
            st, sent = j_ep.master_store(st, pk, "x", "y")
            return sent.sum()[None], j_ep.fence(st)[None], st.mem[None]
        return _sm(mesh, f, jnp.zeros((T, 1)), in_specs=row,
                   out_specs=(TILES, TILES, row))
    if case == "frozen_endpoint_sends_nothing":
        def f(_):
            st = j_ep.freeze(j_ep.make_endpoint(MEM, max_out_credits=8))
            pk = j_pgas.PacketBatch(addr=jnp.zeros((T, 1), jnp.int32),
                                    data=jnp.ones((T, 1), jnp.float32),
                                    mask=jnp.ones((T, 1), bool))
            st, sent = j_ep.master_store(st, pk, "x", "y")
            return sent.sum()[None], st.mem[None]
        return _sm(mesh, f, jnp.zeros((T, 1)), in_specs=row,
                   out_specs=(TILES, row))
    if case == "unfreeze":
        st = j_ep.unfreeze(j_ep.freeze(j_ep.make_endpoint(MEM, 8)))
        return np.broadcast_to(np.asarray(st.frozen), (T,))
    raise KeyError(case)


PGAS_CASES = ["store_delivers_and_credits", "store_slot_order",
              "store_random", "load_request_order", "load_random",
              "cas_single_winner", "endpoint_credit_limit_and_fence",
              "frozen_endpoint_sends_nothing", "unfreeze"]


@pytest.mark.parametrize("case", PGAS_CASES)
def test_pgas_and_endpoint_match_reference(mesh2x4, pgas_run, case):
    inputs, results = pgas_run
    got = _stack(results, case)
    want = _jax_pgas(mesh2x4, case, inputs)
    if isinstance(got, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    else:
        _same(got, want)
    if case == "cas_single_winner":        # one winner, and it is tile 0
        assert got[1].sum() == 1 and got[1][0]


# ---------------------------------------------------------------------------
# token queues (C6) and credits (C3)
# ---------------------------------------------------------------------------

def test_distributed_channel_ring_matches_reference(mesh2x4):
    data = np.random.default_rng(2).standard_normal((T, 1)).astype(
        np.float32)
    got = _stack(spawn(ranks.core_channel, T, "gloo", args=(data,)),
                 "channel_ring")

    def f(local):
        fwd = j_tq.channel_send(local, "x")
        return fwd, j_tq.channel_recv(fwd, "x")
    want = _sm(mesh2x4, f, data, in_specs=TILES, out_specs=(TILES, TILES))
    for g, w in zip(got, want):
        _same(g.reshape(T, 1), w)


def _queue_trace(mod, as_tensor, ops, depth):
    """Drive a queue through ``ops`` (True = send the next value, False =
    receive); returns every (head, count, tokens, item, valid)."""
    q = mod.tq_make(depth, (2,))
    trace, nxt = [], 0
    for is_send in ops:
        if is_send:
            q = mod.tq_send(q, as_tensor(np.full(2, nxt, np.float32)))
            nxt += 1
            item, valid = np.zeros(2, np.float32), False
        else:
            q, item, valid = mod.tq_recv(q)
        trace.append((int(q.head), int(q.count), int(q.tokens),
                      np.asarray(item).tolist(), bool(valid)))
    return trace


@pytest.mark.parametrize("depth,seed", [(1, 0), (2, 1), (3, 2), (5, 3)])
def test_token_queue_matches_reference(depth, seed):
    """Send/receive sequences (wraparound, full and empty queues) step
    for step: head, count, tokens, the item and its valid flag."""
    import torch
    ops = (np.random.default_rng(seed).random(40) < 0.55).tolist()
    got = _queue_trace(token_queue, torch.from_numpy, ops, depth)
    want = _queue_trace(j_tq, jnp.asarray, ops, depth)
    assert got == want


def test_credits_match_reference():
    for mx, asks in [(3, [5, 0, 2, 1]), (8, [2, 2, 9])]:
        c, jc = credits.make_credits(mx), j_credits.make_credits(mx)
        for n in asks:
            c, g = credits.issue(c, n)
            jc, jg = j_credits.issue(jc, n)
            assert int(g) == int(jg) and int(c.available) == int(jc.available)
            assert bool(credits.fence_ok(c)) == bool(j_credits.fence_ok(jc))
            c, jc = credits.ack(c, n + 1), j_credits.ack(jc, n + 1)
            assert int(c.available) == int(jc.available)
    for hops, depth, rate in [(20, 4, 1.0), (128, 1, 1.0), (3, 2, 0.1)]:
        assert credits.bdp_credits(hops, depth, rate) == \
            j_credits.bdp_credits(hops, depth, rate)


# ---------------------------------------------------------------------------
# sync (C8)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sync_run():
    return spawn(ranks.core_sync, T, "gloo", args=(None,))


def _jax_sync(mesh, case):
    row = P(("y", "x"), None)
    zeros = jnp.zeros((T, MEM), jnp.float32)
    if case == "mutex":
        def f(mem):
            owner = jnp.asarray(5, jnp.int32)
            m1, acq = j_sync.mutex_try_acquire(mem[0], owner, 0, "x", "y", T)
            m2 = j_sync.mutex_release(m1, owner, 0, acq[None, None], "x",
                                      "y", T)
            return m1[None], m2[None], acq[None]
        return _sm(mesh, f, zeros, in_specs=row, out_specs=(row, row, TILES))
    if case == "barrier":
        def f(mem):
            mem = j_sync.barrier_arrive(mem[0], jnp.asarray(0, jnp.int32),
                                        0, "x", "y", T)
            return mem[None], j_sync.barrier_done(mem, 0, T)[None]
        return _sm(mesh, f, zeros, in_specs=row, out_specs=(row, TILES))
    if case == "spmd_barrier":
        return _sm(mesh, lambda _: j_sync.spmd_barrier("x", "y")[None],
                   jnp.zeros((T, 1)), in_specs=row, out_specs=TILES)
    raise KeyError(case)


@pytest.mark.parametrize("case", ["mutex", "barrier", "spmd_barrier"])
def test_sync_matches_reference(mesh2x4, sync_run, case):
    got = _stack(sync_run, case)
    want = _jax_sync(mesh2x4, case)
    if isinstance(got, tuple):
        for g, w in zip(got, want):
            _same(g, w)
    else:
        _same(got, want)
    if case == "mutex":
        assert got[2].sum() == 1


# ---------------------------------------------------------------------------
# coords (C1, C4): the port's own numpy copy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_coords_match_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        nx, ny = (int(v) for v in rng.integers(1, 33, 2))
        aw = int(rng.integers(4, 24))
        spec, jspec = (m.GridSpec(nx=nx, ny=ny, addr_width=aw)
                       for m in (coords, j_coords))
        x, y = int(rng.integers(0, nx)), int(rng.integers(0, ny))
        local = int(rng.integers(0, 1 << aw))
        a = coords.encode_address(spec, x, y, local)
        assert a == j_coords.encode_address(jspec, x, y, local)
        assert coords.decode_address(spec, a) == \
            j_coords.decode_address(jspec, a) == (x, y, local)
        assert (spec.x_cord_width, spec.y_cord_width, spec.num_tiles,
                spec.region_words, spec.tile_id(x, y),
                spec.tile_xy(spec.tile_id(x, y)), list(spec.tiles()),
                spec.bisection_links("x"), spec.bisection_links("y")) == \
            (jspec.x_cord_width, jspec.y_cord_width, jspec.num_tiles,
             jspec.region_words, jspec.tile_id(x, y),
             jspec.tile_xy(jspec.tile_id(x, y)), list(jspec.tiles()),
             jspec.bisection_links("x"), jspec.bisection_links("y"))
        dst = (int(rng.integers(0, nx)), int(rng.integers(0, ny)))
        assert coords.xy_route((x, y), dst) == j_coords.xy_route((x, y), dst)
        assert coords.manhattan_hops((x, y), dst) == \
            j_coords.manhattan_hops((x, y), dst)
    for m in (coords, j_coords):
        with pytest.raises(ValueError):
            m.encode_address(m.GridSpec(nx=4, ny=4, addr_width=8), 4, 0, 0)
        with pytest.raises(ValueError):
            m.GridSpec(nx=0, ny=3)
