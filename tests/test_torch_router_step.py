"""The port's router-step kernel module (``repro_torch.kernels.router_step``).

On the CPU the wrapper runs the kernel's plain PyTorch version, which is
held here against the JAX package's Pallas router kernel run in interpret
mode (``router_step_call(..., interpret=True)``), including the per-cycle
``done`` / ``drained`` columns.  The rest checks the wrapper's contract:
no launches are counted on the CPU, a CUDA tensor never falls back to the
plain version, and the layout the kernel reads (leaf order, shapes, the
argument structs of ``csrc/router_step.cu``) is the one Python builds.

The kernel itself runs only on a card: ``test_kernel_matches_plain_on_card``
is marked ``gpu`` and skips here.  The JAX package is imported only inside
the test that uses it, so the card test runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu \
        tests/test_torch_router_step.py
"""
import re
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import router_step as rs
from repro_torch.kernels.build import CSRC
from repro_torch.mesh import MeshConfig, Topology, make_traffic
from repro_torch.netsim import (init_state, load_program, program_from_jax,
                                stack_programs, state_from_jax,
                                state_to_numpy)
from repro_torch.netsim.sim import (STATE_LEAVES, flatten_state, simulate,
                                    unflatten_state)


@pytest.mark.parametrize("topo,nx,ny,lat,C", [
    ("mesh", 4, 4, 1, 3), ("torus", 3, 4, 2, 2), ("multi_chip:2:3", 4, 3, 1, 3)])
def test_plain_matches_pallas_interpret(topo, nx, ny, lat, C):
    """From a mid-flight state carried across from JAX, ``C`` cycles of
    the port's wrapper (CPU: the plain version) equal one JAX Pallas
    launch of ``C`` cycles in interpret mode, state and columns alike."""
    import jax
    from repro.kernels.router_step import \
        router_step_call as j_router_step_call
    from repro.mesh import MeshConfig as JMeshConfig
    from repro.mesh import Topology as JTopology
    from repro.mesh import make_traffic as j_make_traffic
    from repro.netsim_jax import init_state as j_init_state
    from repro.netsim_jax import load_program as j_load_program
    from repro.netsim_jax import simulate as j_simulate

    def _jleaves(st):
        return [np.asarray(x) for x in jax.tree_util.tree_leaves(st)]

    jcfg = JMeshConfig(nx=nx, ny=ny, resp_latency=lat,
                       topology=JTopology.parse(topo)).to_sim()
    tcfg = MeshConfig(nx=nx, ny=ny, resp_latency=lat,
                      topology=Topology.parse(topo)).to_sim()
    entries = j_make_traffic("uniform", nx, ny, 12, rate=0.9, seed=9,
                             topology=JTopology.parse(topo))
    jprog = j_load_program(entries)
    jst, _ = j_simulate(jcfg, jprog, j_init_state(jcfg), 9)
    tst = state_from_jax(_jleaves(jst), device="cpu")
    tprog = program_from_jax([np.asarray(x) for x in jprog], device="cpu")

    rs.router_step_call.launches = 0
    tst, tdone, tdrained = rs.router_step_call(tcfg, tprog, tst, C)
    jst, jdone, jdrained = j_router_step_call(jcfg, jprog, jst, C,
                                              interpret=True)
    assert rs.router_step_call.launches == 0      # nothing launched on CPU
    assert tdone.shape == tdrained.shape == (1, C)
    np.testing.assert_array_equal(tdone[0].numpy(), np.asarray(jdone))
    np.testing.assert_array_equal(tdrained[0].numpy(), np.asarray(jdrained))
    for name, a, b in zip(STATE_LEAVES, state_to_numpy(tst), _jleaves(jst)):
        np.testing.assert_array_equal(a[0], b, err_msg=name)


def test_drained_column_turns_on_at_the_fence():
    """The per-cycle drain column flips to 1 exactly after the cycle in
    which the last response registers (a 1-packet program on 2x1)."""
    cfg = MeshConfig(nx=2, ny=1).to_sim()
    e = make_traffic("neighbor", 2, 1, 1, rate=1.0)
    prog = load_program(e, "cpu")
    st = init_state(cfg, device="cpu")
    st, done, dr = rs.router_step_call(cfg, prog, st, 12)
    last = int(np.nonzero(done[0].numpy())[0].max())
    assert dr[0, :last].sum() == 0 and bool(dr[0, last:].all())


class _FakeCudaTensor:
    device = torch.device("cuda")


def test_cuda_tensor_without_card_raises_and_does_not_fall_back(monkeypatch):
    """A state on a CUDA device reaches the kernel or raises: with no card
    the wrapper raises, never runs the plain version, counts nothing."""
    def plain_must_not_run(*a, **k):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(rs, "router_step_plain", plain_must_not_run)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rs.router_step_call.launches = 0
    st = types.SimpleNamespace(cycle=_FakeCudaTensor())
    cfg = MeshConfig(nx=2, ny=2).to_sim()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rs.router_step_call(cfg, None, st, 2)
    assert rs.router_step_call.launches == 0
    with pytest.raises(ValueError, match="cycles_per_call"):
        rs.router_step_call(cfg, None, st, 0)
    # entry points default to the card and refuse to carry on on the CPU
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_state(cfg)


def test_layout_round_trips_and_matches_the_kernel_structs():
    """The leaves the wrapper hands the kernel: flatten/unflatten is the
    identity, every leaf has the public shape and dtype the wrapper checks
    (the packed leaves are covered below), and the ctypes structs list the
    C structs' fields in the C order, the variant's code included."""
    cfg = MeshConfig(nx=3, ny=2, router_fifo=5, ep_fifo=3, mem_words=7,
                     resp_latency=2,
                     topology=Topology.multi_chip(3, 4)).to_sim()
    st = init_state(cfg, [5, 2], [9, 4], device="cpu")
    leaves = flatten_state(st)
    assert [t is u for t, u in zip(flatten_state(unflatten_state(leaves)),
                                   leaves)] == [True] * len(STATE_LEAVES)
    shapes = rs.leaf_shapes(cfg, 2)
    assert list(shapes) == list(STATE_LEAVES)
    for name, t in zip(STATE_LEAVES, leaves):
        assert tuple(t.shape) == shapes[name], name
        assert t.is_contiguous()
        assert t.dtype == (torch.bool if name in ("resp_valid", "reg_valid")
                           else torch.int32), name
    dims = rs.kernel_dims(cfg, 2, 11)
    assert dims == {"B": 2, "ny": 2, "nx": 3, "cap": 5, "ep_fifo": 3,
                    "mem_words": 7, "L": 2, "Lp": 11, "wrap_x": 0,
                    "wrap_y": 0, "chip_w": 1, "period": 4, "variant": 0}
    assert rs.kernel_dims(cfg, 2, 11, "packed")["variant"] == 1
    assert rs.kernel_dims(MeshConfig(nx=4, ny=4, topology=Topology.torus())
                          .to_sim(), 1, 1)["chip_w"] == 0

    src = (CSRC / "router_step.cu").read_text()

    def fields(struct):
        body = re.search(r"struct %s \{(.*?)\};" % struct, src, re.S).group(1)
        body = re.sub(r"//[^\n]*", "", body)
        names = []
        for decl in body.split(";"):
            names += [re.sub(r"[\s*]|u?int(8|32)_t|const|int", "", n)
                      for n in decl.split(",")]
        return tuple(n for n in names if n)

    assert fields("RouterArgs") == rs.ARG_FIELDS
    assert fields("RouterDims") == rs.DIM_FIELDS
    assert [f for f, _ in rs._Args._fields_] == list(rs.ARG_FIELDS)


TOPOLOGIES = ("mesh", "torus", "ring_mesh", "multi_chip:2:3")


def _random_state(spec, resp_latency, seed=0):
    """A 6x4 state of 3 lanes whose every int32 leaf holds random values
    and whose flags are random, so a misplaced word shows."""
    cfg = MeshConfig(nx=6, ny=4, router_fifo=5, ep_fifo=3,
                     resp_latency=resp_latency,
                     topology=Topology.parse(spec)).to_sim()
    st = init_state(cfg, [5, 3, 2], [9, 4, 1], device="cpu")
    g = torch.Generator().manual_seed(seed)
    for t in flatten_state(st):
        if t.dtype == torch.bool:
            t.copy_(torch.randint(0, 2, t.shape, generator=g).bool())
        else:
            t.copy_(torch.randint(-2 ** 31, 2 ** 31 - 1, t.shape,
                                  generator=g, dtype=torch.int64).int())
    return cfg, st


@pytest.mark.parametrize("spec", TOPOLOGIES)
@pytest.mark.parametrize("resp_latency", [1, 2])
def test_pack_unpack_round_trips_every_leaf(spec, resp_latency):
    """The wrapper's working layout: ``pack_state`` has the packed shapes,
    ``unpack_state`` of it restores every packed leaf exactly (into a
    state that was zeroed) and touches no other leaf."""
    cfg, st = _random_state(spec, resp_latency)
    want = [t.clone() for t in flatten_state(st)]
    packed = rs.pack_state(st)
    shapes = rs.packed_shapes(cfg, 3)
    assert tuple(packed["net_buf"].shape) == shapes["net_buf"]
    assert tuple(packed["ports"].shape) == (len(rs.PORT_LEAVES),) + \
        shapes["net_head"]
    assert all(shapes[n] == shapes["net_head"] for n in rs.PORT_LEAVES)
    for name, t in zip(STATE_LEAVES, flatten_state(st)):
        if name in rs.PACKED_LEAVES:
            t.zero_()
    rs.unpack_state(packed, st)
    for name, a, b in zip(STATE_LEAVES, flatten_state(st), want):
        assert torch.equal(a, b), name


def _helpers():
    """The kernel's index helpers (``port_idx``, ``buf_idx``, ``scr_idx``
    of ``csrc/router_step.cu``) as Python functions of keyword arguments,
    their bodies read from the source and evaluated over its own
    constants: ``{(name, packed): (function, parameter names)}``, where a
    helper templated on the layout (``if constexpr (PACKED) return ...;
    else return ...;``) gives one function per layout and ``scr_idx`` one
    for both."""
    src = (CSRC / "router_step.cu").read_text()
    consts = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (NP|NF) = (\d+);", src)}
    m = re.search(r"constexpr int SCR = ([^;]+);", src)
    consts["SCR"] = eval(m.group(1), {}, dict(consts))

    def fn(body):
        return lambda **kw: eval(body, {}, {**consts, **kw})

    out = {}
    for name in ("port_idx", "buf_idx", "scr_idx"):
        m = re.search(name + r"\(([^)]*)\)\s*\{\s*(.*?)\n\}", src, re.S)
        params = [p.split()[-1].lstrip("&") for p in m.group(1).split(",")]
        branches = re.findall(r"return ([^;]+);", m.group(2))
        if "if constexpr (PACKED)" in m.group(2):
            packed, direct = branches
            out[name, True] = (fn(packed), params)
            out[name, False] = (fn(direct), params)
        else:
            out[name, True] = out[name, False] = (fn(branches[0]), params)
    return out, consts


@pytest.mark.parametrize("spec", TOPOLOGIES)
def test_kernel_index_helpers_address_the_packed_tensors(spec):
    """A Python mirror of the kernel's index helpers, read from the
    ``.cu`` source: at every coordinate ``buf_idx`` and ``port_idx``
    address, in the packed layout, the word the public leaf holds there
    in the flat tensors of ``pack_state``, and in the direct layout the
    same word in the flat public leaf; ``scr_idx`` is the row-major
    offset in the scratch's shape."""
    cfg, st = _random_state(spec, 2, seed=3)
    helpers, consts = _helpers()
    assert consts["NP"] == 5 and consts["NF"] == 5
    B, ny, nx, cap = 3, cfg.ny, cfg.nx, cfg.router_fifo
    T = ny * nx
    d = types.SimpleNamespace(ny=ny, nx=nx, cap=cap)
    packed = rs.pack_state(st)
    leaves = dict(zip(STATE_LEAVES, flatten_state(st)))
    b, f, n, y, x, p, s = np.meshgrid(
        *[np.arange(k) for k in (B, 5, 2, ny, nx, 5, cap)], indexing="ij")
    want = st.net.buf.numpy()[b, f, n, y, x, p, s]
    for is_packed, flat in ((True, packed["net_buf"].reshape(-1).numpy()),
                            (False, st.net.buf.reshape(-1).numpy())):
        buf_idx, params = helpers["buf_idx", is_packed]
        assert params == ["d", "b", "f", "n", "p", "s", "t"]
        np.testing.assert_array_equal(
            flat[buf_idx(d=d, b=b, f=f, n=n, p=p, s=s, t=y * nx + x)], want)
    b, n, y, x, p = np.meshgrid(*[np.arange(k) for k in (B, 2, ny, nx, 5)],
                                indexing="ij")
    for is_packed in (True, False):
        port_idx, params = helpers["port_idx", is_packed]
        assert params == ["b", "n", "p", "t", "T"]
        idx = port_idx(b=b, n=n, p=p, t=y * nx + x, T=T)
        for i, name in enumerate(rs.PORT_LEAVES):
            flat = (packed["ports"][i] if is_packed else leaves[name])
            np.testing.assert_array_equal(
                flat.reshape(-1).numpy()[idx],
                leaves[name].numpy()[b, n, y, x, p], err_msg=name)
    scr_idx, params = helpers["scr_idx", True]
    assert params == ["d", "b", "n", "o", "k", "t"]
    shape = rs.packed_shapes(cfg, B)["scratch"]
    assert shape[-2] == consts["SCR"] == rs.SCRATCH_WORDS and shape[-1] == T
    coords = np.meshgrid(*[np.arange(k) for k in shape], indexing="ij")
    np.testing.assert_array_equal(
        scr_idx(d=d, **dict(zip(params[1:], coords))),
        np.ravel_multi_index(coords, shape))


@pytest.mark.parametrize("spec", TOPOLOGIES)
@pytest.mark.parametrize("nx,ny,lanes,cycles,want", [
    (16, 32, 12, 400, "packed"),    # the sweep's measure and drain phases
    (16, 32, 12, 200, "direct"),    # its warm-up
    (16, 32, 12, 1, "direct"),      # a 12-lane drain checking every cycle
    (16, 32, 1, 1, "direct"),       # the facade's drain
    (16, 32, 1, 400, "direct"),     # one lane: the card nearly empty
    (4, 4, 1, 1000, "direct"),
    (32, 32, 24, 100_000, "packed"),
    (16, 32, 12, rs.PACKED_MIN_CYCLES, "packed"),
    (16, 32, 12, rs.PACKED_MIN_CYCLES - 1, "direct"),
    (16, 16, rs.PACKED_MIN_TILES // 256, 400, "packed"),
    (16, 16, rs.PACKED_MIN_TILES // 256 - 1, 400, "direct")])
def test_router_variant_is_a_function_of_config_lanes_and_cycles(
        spec, nx, ny, lanes, cycles, want):
    """The variant is chosen before the launch from the configuration,
    the lane count and the cycles per call alone (packed from
    ``PACKED_MIN_TILES`` lanes x tiles and ``PACKED_MIN_CYCLES`` cycles
    up), the same for every topology; ``kernel_dims`` passes its code and
    the counters cover both variants."""
    cfg = MeshConfig(nx=nx, ny=ny, topology=Topology.parse(spec)).to_sim()
    assert rs.router_variant(cfg, lanes, cycles) == want
    assert rs.kernel_dims(cfg, lanes, 9, want)["variant"] == \
        rs.VARIANTS.index(want)
    assert rs.router_step_call.launches_by_variant.keys() == \
        set(rs.VARIANTS)


def test_build_dir_follows_the_environment_and_the_checkout(monkeypatch,
                                                          tmp_path):
    """Libraries go to ``$REPRO_TORCH_BUILD_DIR`` when it is set, else to
    ``build/kernels`` of the checkout the package runs from."""
    from repro_torch.kernels import build
    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR", raising=False)
    root = CSRC.parents[3]
    assert build.build_dir() == root / "build" / "kernels"
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    lib = build.library_path("router_step")
    assert lib.parent == tmp_path and lib.name.startswith("librouter_step-")


def test_cycle_bytes_is_a_lower_bound_of_the_state():
    """The bound's byte count stays below one read and one write of the
    whole state (it counts only what a cycle must touch)."""
    cfg = MeshConfig(nx=16, ny=32, router_fifo=16,
                     max_out_credits=128).to_sim()
    b = rs.cycle_bytes(cfg, 12)
    state = sum(int(np.prod(s)) * 4 for s in rs.leaf_shapes(cfg, 12).values())
    assert 0 < b < 2 * state
    assert rs.cycle_bytes(cfg, 24) == 2 * b


@pytest.mark.gpu
def test_kernel_matches_plain_on_card():
    """Kernel against plain version on the card, every leaf and column,
    at a small size on all four topologies (lanes of different depth)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA H100 (no CUDA device visible)")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper (sm_90) card")
    for spec in ("mesh", "torus", "ring_mesh", "multi_chip:2:3"):
        topo = Topology.parse(spec)
        cfg = MeshConfig(nx=6, ny=5, router_fifo=6, resp_latency=2,
                         topology=topo).to_sim()
        prog = stack_programs([
            load_program(make_traffic("uniform", 6, 5, 30, rate=r, seed=s,
                                      topology=topo), "cuda")
            for s, r in enumerate((0.4, 0.9))])
        ks = init_state(cfg, [6, 3], [16, 4], device="cuda")
        ps = init_state(cfg, [6, 3], [16, 4], device="cuda")
        before = rs.router_step_call.launches
        for C in (5, 5, 5, 2):
            ks, kd, kr = rs.router_step_call(cfg, prog, ks, C)
            ps, pd, pr = rs.router_step_plain(cfg, prog, ps, C)
            assert torch.equal(kd, pd) and torch.equal(kr, pr), spec
        assert rs.router_step_call.launches == before + 4
        torch.cuda.synchronize()
        for name, a, b in zip(STATE_LEAVES, flatten_state(ks),
                              flatten_state(ps)):
            assert torch.equal(a, b), f"{spec}: {name}"
        before = rs.router_step_call.launches
        _, per_cycle = simulate(cfg, prog,
                                init_state(cfg, [6, 3], [16, 4],
                                           device="cuda"), 7, 3)
        assert per_cycle.shape == (2, 7)
        assert rs.router_step_call.launches == before + 3
        _, whole = simulate(cfg, prog, init_state(cfg, [6, 3], [16, 4],
                                                  device="cuda"), 7)
        assert rs.router_step_call.launches == before + 4
        assert torch.equal(whole, per_cycle), spec


@pytest.mark.gpu
def test_card_pack_matches_pack_state():
    """The kernel's pack (one launch of its tiled transpose) gives the
    working copies ``pack_state`` gives, and its unpack restores every
    packed leaf, on all four topologies."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA H100 (no CUDA device visible)")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs a Hopper (sm_90) card")
    for spec in TOPOLOGIES:
        cfg, cpu_st = _random_state(spec, 2, seed=5)
        st = unflatten_state([t.cuda() for t in flatten_state(cpu_st)])
        want = rs.pack_state(st)
        got = {k: torch.empty_like(v) for k, v in want.items()}
        stream = torch.cuda.current_stream().cuda_stream
        pack = rs._pack_call(rs._library(), st, got)
        pack(False, stream)
        for k in want:
            assert torch.equal(got[k], want[k]), f"{spec}: {k}"
        before = [t.clone() for t in flatten_state(st)]
        for name, t in zip(STATE_LEAVES, flatten_state(st)):
            if name in rs.PACKED_LEAVES:
                t.zero_()
        pack(True, stream)
        torch.cuda.synchronize()
        for name, a, b in zip(STATE_LEAVES, flatten_state(st), before):
            assert torch.equal(a, b), f"{spec}: {name}"
