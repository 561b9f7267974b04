"""Mamba-2, Jamba and Whisper on a mesh against the JAX package: forward
and ``decode_step`` on 8 gloo ranks (data 2, model 4) against the
reference's ``jax.jit`` forward and ``decode_step`` under its rules on
the conftest's ``mesh_dm``, the reduced configs in fp32.

* forward logits (and ``last_only``, and the MoE aux loss): Mamba-2 with
  ``manual_tp`` True (the head-parallel mixer island) and False (the
  mixer's weights gathered); Jamba at capacity factor 8 (nothing drops)
  under ``xy`` and ``ep``, each with ``manual_tp`` True and False;
  Whisper on frames, ``manual_tp`` True and False.  The reduced Mamba-2
  mixer's ``in_proj`` has 560 output columns, 140 a rank on model 4: a
  rank's block is a flat slice of ``[z | x | B | C | dt]`` (rank 0's is
  ``z`` alone), not its heads, and the island still computes the
  reference's function;
* six ``decode_step``s under ``cell_rules`` of a decode cell, with a
  batch of 4 (rows over ``data``) and of 1 (the batch axis dropped, the
  KV over ``("data", "model")``): every step's logits, and every cache
  leaf (the family's ``cache_specs``: the reference's layouts; the
  blocks gathered) against the reference's; Whisper's cross KV built
  from an encoder output (``init_cache(enc_out=...)``);
* each family's ``param_specs`` equal the reference's, spec for spec, at
  published widths and reduced, under ``baseline`` and ``fsdp`` (as
  ``build_cell`` banks a training cell), and the optimizer's banks too
  (a stand-in mesh object serves: layouts need only ``axis_names`` and
  ``shape``);
* each rank's blocks gather back to the full parameters, and
  ``init_params(..., rules=)`` draws the blocks of the full draw;
* ``Rules.ssd_impl`` takes the reference's ``"chunked"`` and
  ``"kernel"`` and refuses its cost-isolation stub ``"skip"``;
* the ranks import nothing of JAX or ``repro``.

Tolerances: 2e-4, 3e-4 for the MoE, as ``test_torch_spmd_models.py``
holds them.  One spawn runs every case, in a thread beside JAX's
compiles.
"""
import dataclasses
import types
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_spmd_ranks as ranks
from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.launch import step as j_step
from repro.models.api import get_model as j_get_model
from repro.parallel.sharding import Rules as JRules
from repro_torch import optim
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.mesh import spawn
from repro_torch.launch.step import cell_rules
from repro_torch.models import get_model
from repro_torch.parallel.sharding import Rules

TOL = dict(rtol=2e-4, atol=2e-4)
MOE_TOL = dict(rtol=3e-4, atol=3e-4)
MAMBA, JAMBA, WHISPER = "mamba2-370m", "jamba-v0.1-52b", "whisper-large-v3"
FAMILIES = (MAMBA, JAMBA, WHISPER)
SEQ = 32

# the layouts need a mesh's shape and axis names only
DM = types.SimpleNamespace(axis_names=("data", "model"),
                           shape={"data": 2, "model": 4})


def _cfgs(arch, cf=None):
    j = j_reduced_config(j_get_config(arch))
    t = reduced_config(get_config(arch))
    if cf is not None:
        j, t = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=cf)) for c in (j, t))
    return j, t


# name -> (arch, capacity factor or None, rule overrides)
FORWARDS = {
    "mamba2": (MAMBA, None, {}),
    "mamba2 gspmd": (MAMBA, None, dict(manual_tp=False)),
    "jamba xy": (JAMBA, 8.0, dict(dispatch="xy")),
    "jamba xy gspmd": (JAMBA, 8.0, dict(dispatch="xy", manual_tp=False)),
    "jamba ep": (JAMBA, 8.0, dict(dispatch="ep")),
    "jamba ep gspmd": (JAMBA, 8.0, dict(dispatch="ep", manual_tp=False)),
    "whisper": (WHISPER, None, {}),
    "whisper gspmd": (WHISPER, None, dict(manual_tp=False)),
}

# name -> (arch, capacity factor or None, batch, decode steps, max_seq)
DECODES = {
    "mamba2 batch 4": (MAMBA, None, 4, 6, SEQ),
    "mamba2 batch 1": (MAMBA, None, 1, 6, SEQ),
    "jamba batch 4": (JAMBA, 8.0, 4, 6, SEQ),
    "jamba batch 1": (JAMBA, 8.0, 1, 6, SEQ),
    "whisper batch 4": (WHISPER, None, 4, 6, SEQ),
    "whisper batch 1": (WHISPER, None, 1, 6, SEQ),
}


def _frames(jcfg, B, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, jcfg.encdec.encoder_seq, jcfg.d_model)).astype(np.float32)


def _j_forward(mesh, jcfg, params, toks, kw, frames):
    model = j_get_model(jcfg)
    rules = JRules(mesh=mesh, **kw)
    extra = {} if frames is None else {"frames": jnp.asarray(frames)}
    with mesh:
        logits, aux = jax.jit(lambda p, t, e: model.forward(
            p, t, jcfg, rules, **e))(params, jnp.asarray(toks), extra)
    return np.asarray(logits, np.float32), float(aux)


def _j_decode(mesh, jcfg, params, steps, max_seq, enc_out):
    """The reference's decode under ``cell_rules`` on ``mesh``: per step
    (logits, cache), and the rules."""
    model = j_get_model(jcfg)
    rules = j_step.cell_rules(mesh, jcfg, JShapeConfig(
        "d", max_seq, steps.shape[1], "decode"))
    fn = jax.jit(lambda p, c, t: model.decode_step(p, c, t, jcfg, rules))
    kw = {} if enc_out is None else {"enc_out": jnp.asarray(enc_out),
                                     "params": params}
    out = []
    with mesh:
        cache = model.init_cache(jcfg, steps.shape[1], max_seq, **kw)
        for tok in steps:
            logits, cache = fn(params, cache, jnp.asarray(tok))
            out.append((np.asarray(logits),
                        {k: np.asarray(v) for k, v in cache.items()}))
    return out, rules


@pytest.fixture(scope="module")
def runs(mesh_dm):
    """{"forward": (the reference's (logits, aux) per case, the ranks'),
    "decode": (the reference's (steps, rules) per case, the ranks')}."""
    toks = np.random.default_rng(0).integers(0, 512, (4, SEQ)).astype(
        np.int32)
    params, fwd_jobs, fwd_cases = {}, [], []

    def params_of(arch, cf, seed):
        jcfg, tcfg = _cfgs(arch, cf)
        if (arch, cf, seed) not in params:
            params[(arch, cf, seed)] = j_get_model(jcfg).init_params(
                jcfg, jax.random.key(seed))
        return jcfg, tcfg, params[(arch, cf, seed)]

    for name, (arch, cf, kw) in FORWARDS.items():
        jcfg, tcfg, p = params_of(arch, cf, 0)
        frames = _frames(jcfg, toks.shape[0]) if arch == WHISPER else None
        fwd_jobs.append((name, jcfg, p, kw, frames))
        fwd_cases.append((name, tcfg, {k: np.asarray(v) for k, v in
                                       p.items()}, toks, None, kw,
                          {} if frames is None else {"frames": frames}))
    dec_jobs, dec_cases = [], []
    for name, (arch, cf, B, n, max_seq) in DECODES.items():
        jcfg, tcfg, p = params_of(arch, cf, 1)
        steps = np.random.default_rng(2).integers(
            0, jcfg.vocab_size, (n, B)).astype(np.int32)
        enc = None
        if arch == WHISPER:
            enc = np.asarray(j_get_model(jcfg).encode(
                p, jnp.asarray(_frames(jcfg, B, 3)), jcfg), np.float32)
        dec_jobs.append((name, jcfg, p, steps, max_seq, enc))
        dec_cases.append((name, tcfg, {k: np.asarray(v) for k, v in
                                       p.items()}, steps, max_seq, {})
                         + (() if enc is None else (enc,)))
    with ThreadPoolExecutor(1) as pool:
        ranks_run = pool.submit(spawn, ranks.family_checks, 8, "gloo",
                                args=(fwd_cases, dec_cases))
        fwd = {name: _j_forward(mesh_dm, jcfg, p, toks, kw, frames)
               for name, jcfg, p, kw, frames in fwd_jobs}
        dec = {name: _j_decode(mesh_dm, jcfg, p, steps, max_seq, enc)
               for name, jcfg, p, steps, max_seq, enc in dec_jobs}
        results = ranks_run.result()
    return {"forward": (fwd, [r["forward"] for r in results]),
            "decode": (dec, [r["decode"] for r in results])}


@pytest.mark.parametrize("name", list(FORWARDS))
def test_forward_matches_reference_under_rules(runs, name):
    want, results = runs["forward"]
    logits, aux = want[name]
    tol = MOE_TOL if name.startswith("jamba") else TOL
    for rank, res in enumerate(results):
        got, got_aux, last, drops = res[name]
        np.testing.assert_allclose(got, logits, err_msg=f"rank {rank}",
                                   **tol)
        np.testing.assert_allclose(last[:, 0], logits[:, -1],
                                   err_msg=f"rank {rank}", **tol)
        assert abs(float(got_aux) - aux) <= 1e-4 * max(1.0, abs(aux))
        assert drops == 0


@pytest.mark.parametrize("name", list(DECODES))
def test_decode_matches_reference_under_cell_rules(runs, name):
    want, results = runs["decode"]
    steps, jrules = want[name]
    tol = MOE_TOL if name.startswith("jamba") else TOL
    for rank, res in enumerate(results):
        got, batch, kv_seq = res[name]
        assert batch == jrules._clean(jrules.batch)
        assert kv_seq == jrules._clean(jrules.kv_seq)
        assert len(got) == len(steps)
        for i, ((logits, cache), (jl, jc)) in enumerate(zip(got, steps)):
            np.testing.assert_allclose(logits, jl, err_msg=f"step {i}",
                                       **tol)
            assert set(cache) == set(jc)
            for k in cache:
                if np.issubdtype(jc[k].dtype, np.floating):
                    np.testing.assert_allclose(cache[k], jc[k], **tol,
                                               err_msg=f"{k} step {i}")
                else:
                    np.testing.assert_array_equal(cache[k], jc[k],
                                                  err_msg=f"{k} step {i}")
    if "batch 1" in name:
        assert results[0][name][1:] == (None, ("data", "model"))


def test_decode_caches_keep_the_reference_layout(runs):
    """Every leaf of each family's decode cache is a block of the
    reference's (``cache_specs``), compared above once gathered: the SSM
    state over heads, the convolution tail's flat ``conv_dim`` over heads
    (the decode island convolves its ``conv_w`` block), the KV over
    ``kv_seq``."""
    _want, results = runs["decode"]
    for name, leaves in (("mamba2 batch 4", {"state", "conv", "len"}),
                         ("jamba batch 4", {"k", "v", "state", "conv",
                                            "len"}),
                         ("whisper batch 4", {"k", "v", "xk", "xv",
                                              "len"})):
        assert set(results[0][name][0][0][1]) == leaves, name


def test_shards_round_trip(runs):
    """Each rank's blocks (``shard_params``) have ``shard_table``'s
    shapes and gather back (``gather_params``) to the full parameters;
    ``init_params(..., rules=)`` draws exactly the blocks of the full
    draw."""
    _want, results = runs["forward"]
    assert all(all(r["round trip"].values()) for r in results)
    assert set(results[0]["round trip"]) == set(FORWARDS)


def test_ranks_import_nothing_of_jax_or_repro(runs):
    for part in ("forward", "decode"):
        _want, results = runs[part]
        assert all(r["modules"] == [] for r in results), \
            results[0]["modules"]


# ---------------------------------------------------------------------------
# layouts (no ranks)
# ---------------------------------------------------------------------------

def _norm(spec, ndim):
    """A spec as a tuple of ``ndim`` entries, a 1-tuple entry as its
    name."""
    out = []
    for e in tuple(spec) + (None,) * (ndim - len(tuple(spec))):
        if isinstance(e, tuple) and len(e) == 1:
            e = e[0]
        out.append(e)
    return tuple(out)


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", FAMILIES)
def test_param_specs_match_the_reference(mesh_dm, arch, reduced):
    """Every parameter's spec (``baseline``; ``fsdp``'s banked ones as
    ``build_cell`` banks them) and the optimizer state's banks equal the
    reference's."""
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    if reduced:
        jcfg, tcfg = j_reduced_config(jcfg), reduced_config(tcfg)
    jshape = JShapeConfig("t", seq_len=SEQ, global_batch=8, kind="train")
    shape = ShapeConfig("t", seq_len=SEQ, global_batch=8, kind="train")
    shapes = j_get_model(jcfg).param_shapes(jcfg)
    model = get_model(tcfg)
    for strategy in ("baseline", "fsdp"):
        cell = j_step.build_cell(jcfg, jshape, mesh_dm, strategy)
        j_params, j_state = cell.in_shardings[0], cell.in_shardings[1]["m"]
        rules = cell_rules(DM, tcfg, shape, strategy)
        specs = model.param_specs(tcfg, rules)
        banked = optim.state_specs(specs, model.param_table(tcfg), rules)
        assert set(specs) == set(j_params) == set(banked["m"])
        for k in specs:
            nd = len(shapes[k].shape)
            assert _norm(specs[k], nd) == _norm(j_params[k].spec, nd), \
                (strategy, k)
            assert _norm(banked["m"][k], nd) == _norm(j_state[k].spec, nd), \
                (strategy, k)


@pytest.mark.parametrize("overrides", [dict(dispatch="tp"),
                                       dict(dispatch="ep"),
                                       dict(manual_tp=False)])
def test_jamba_param_specs_under_other_rules(mesh_dm, overrides):
    """The reference's ``param_specs`` under rules other than the
    defaults (the expert layout follows the dispatch)."""
    jcfg, tcfg = j_get_config(JAMBA), get_config(JAMBA)
    want = j_get_model(jcfg).param_specs(jcfg, JRules(mesh=mesh_dm,
                                                      **overrides))
    got = get_model(tcfg).param_specs(tcfg, Rules(mesh=DM, **overrides))
    shapes = get_model(tcfg).param_table(tcfg)
    assert set(got) == set(want)
    for k, spec in got.items():
        nd = len(shapes[k])
        assert _norm(spec, nd) == _norm(want[k].spec, nd), k


@pytest.mark.parametrize("arch,proj_out,block", [
    (MAMBA, 560, 140), (JAMBA, 560, 140)])
def test_in_proj_blocks_are_flat_slices_not_heads(arch, proj_out, block):
    """The reduced mixers the forward and decode cases run: ``in_proj``'s
    560 columns split 140 a rank on model 4, so rank 0's block is ``z``
    alone (d_inner 256) and every other block straddles a boundary of
    ``[z | x | B | C | dt]``; at full width the blocks are 1,096 columns
    (Mamba-2 370M, 4,384 / 4) and 4,136 (Jamba, 16,544 / 4)."""
    from repro_torch.models import mamba2
    cfg = reduced_config(get_config(arch))
    _s, di, nh, _cd, po = mamba2._dims(cfg)
    assert po == proj_out and po // 4 == block and block < di
    assert nh % 4 == 0 and mamba2.head_blocks(cfg, Rules(mesh=DM)) == 4
    spec = get_model(cfg).layout_specs(cfg, Rules(mesh=DM))
    name = [k for k in spec if k.endswith("in_proj")][0]
    assert spec[name][-1] == "model"
    for full, cols in ((get_config(MAMBA), 1096), (get_config(JAMBA), 4136)):
        assert mamba2._dims(full)[4] // 4 == cols


def test_ssd_impl_takes_the_reference_values():
    for impl in ("chunked", "kernel"):
        assert Rules(mesh=DM, ssd_impl=impl).ssd_impl == impl
    with pytest.raises(ValueError, match="skip"):
        Rules(mesh=DM, ssd_impl="skip")
