"""The port's Jamba model stack against the JAX package on the CPU.

* the port's config copies equal the reference's, field for field;
* ``params_from_jax`` round-trips, and ``init_params`` follows the
  reference's initialisation rules;
* a Mamba-2 mixer and an MoE block (with a capacity factor small enough to
  drop tokens, so the FIFO order is held too) equal the reference's;
* the forward logits equal ``repro.models.jamba.forward`` with
  ``rules=None`` and with the 1x1-mesh flash/kernel rules (the Pallas
  kernels in interpret mode), and teacher-forced ``decode_step`` equals
  ``forward``.

Every comparison runs both packages on the same weights (the JAX
``init_params``, converted with ``params_from_jax``) and the same tokens.
Tolerance: 2e-4 on logits, as ``tests/test_models.py`` holds JAX decode
to JAX forward (fp32, sums in other orders through eight layers);
2e-5 on a single block.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import list_archs as j_list_archs
from repro.configs import reduced_config as j_reduced_config
from repro.configs.base import SHAPES as J_SHAPES
from repro.models import jamba as j_jamba
from repro.models import mamba2 as j_mamba2
from repro.models import moe as j_moe
from repro_torch.configs import get_config, list_archs, reduced_config
from repro_torch.configs.base import SHAPES
from repro_torch.models import get_model, jamba, mamba2, moe
from repro_torch.models.convert import init_params, params_from_jax

ARCH = "jamba-v0.1-52b"
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)
BLOCK_TOL = dict(rtol=2e-5, atol=2e-5)


def _cfgs(**overrides):
    j = j_reduced_config(j_get_config(ARCH))
    t = reduced_config(get_config(ARCH))
    if overrides:
        j, t = dataclasses.replace(j, **overrides), \
            dataclasses.replace(t, **overrides)
    return j, t


def _with_capacity(cfg, cf):
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


@pytest.fixture(scope="module")
def weights():
    """JAX params of the reduced Jamba (2 periods of 2 layers) and the
    port's model on the same weights."""
    jcfg, tcfg = _cfgs()
    jparams = j_jamba.init_params(jcfg, jax.random.PRNGKey(0))
    state = params_from_jax(tcfg, {k: np.asarray(v)
                                   for k, v in jparams.items()},
                            device="cpu")
    return jcfg, tcfg, jparams, state


def _model(tcfg, state):
    m = get_model(tcfg)(tcfg, device="cpu")
    m.load_state_dict(state)
    return m


def _tokens(cfg, B=2, S=10, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(j_list_archs()))
def test_config_copies_equal_the_reference(arch):
    assert sorted(list_archs()) == sorted(j_list_archs())
    j, t = j_get_config(arch), get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(reduced_config(t)) == \
        dataclasses.asdict(j_reduced_config(j))
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()
    assert (t.attention_free, t.subquadratic) == \
        (j.attention_free, j.subquadratic)
    assert str(t.param_dtype).split(".")[-1] == str(j.param_dtype)
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}


def test_param_table_matches_the_reference():
    jcfg, tcfg = _cfgs()
    jt = j_jamba.param_table(jcfg)
    assert jamba.param_table(tcfg) == {k: s for k, (s, _a) in jt.items()}
    js = j_jamba.param_shapes(jcfg)
    for k in jt:
        assert str(jamba.param_dtype(tcfg, k)).split(".")[-1] == \
            str(js[k].dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_round_trips(dtype):
    jcfg, tcfg = _cfgs(dtype=dtype)
    jparams = {k: np.asarray(v) for k, v in
               j_jamba.init_params(jcfg, jax.random.PRNGKey(3)).items()}
    state = params_from_jax(tcfg, jparams, device="cpu")
    for k, v in state.items():
        assert v.dtype == jamba.param_dtype(tcfg, k)
    back = {k: v.to(torch.float32).numpy() for k, v in state.items()}
    assert set(back) == set(jparams)
    for k in jparams:
        np.testing.assert_array_equal(back[k], jparams[k].astype(np.float32),
                                      err_msg=k)
    model = _model(tcfg, state)
    assert set(model.state_dict()) == set(jparams)
    with pytest.raises(KeyError):
        params_from_jax(tcfg, {k: v for k, v in jparams.items()
                               if k != "embed"}, device="cpu")


def test_init_params_follows_the_reference_rules():
    _jcfg, tcfg = _cfgs()
    p = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert set(p) == set(jamba.param_table(tcfg))
    for k, v in p.items():
        assert tuple(v.shape) == jamba.param_table(tcfg)[k]
        assert v.dtype == jamba.param_dtype(tcfg, k)
        if "norm" in k or k.endswith("D_skip"):
            assert bool((v == 1).all()), k
        elif k.endswith(("dt_bias", "conv_b")):
            assert bool((v == 0).all()), k
        elif k.endswith("A_log"):
            want = torch.log(torch.linspace(1.0, 16.0, v.shape[-1]))
            assert torch.equal(v, want.expand(v.shape)), k
        else:                     # truncated normal, fan-in scale
            fan_in = v.shape[-2]
            assert float(v.abs().max()) <= 2 * fan_in ** -0.5 + 1e-6, k
            assert 0.5 < float(v.std()) * fan_in ** 0.5 < 1.0, k
    again = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(p[k], again[k]) for k in p)


def test_get_model_names_the_roadmap_item_of_other_families():
    """Every family has its class (Whisper, the audio family, included);
    an unknown family raises ``KeyError``."""
    import dataclasses
    from repro_torch.models.transformer import Transformer
    from repro_torch.models.whisper import Whisper
    want = {"hybrid": jamba.Jamba, "ssm": mamba2.Mamba2LM,
            "dense": Transformer, "moe": Transformer, "vlm": Transformer,
            "audio": Whisper}
    for arch in sorted(list_archs()):
        cfg = get_config(arch)
        assert get_model(cfg) is want[cfg.family], arch
    with pytest.raises(KeyError, match="unknown model family"):
        get_model(dataclasses.replace(get_config(ARCH), family="speech"))
    assert get_model(get_config(ARCH)) is jamba.Jamba


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def test_mixer_apply_matches_the_reference(weights):
    """One Mamba-2 mixer (the reference with ``rules=None`` runs its
    chunked jnp SSD; the port the SSD op's plain version), S=37: three
    chunks of 16, the last ragged."""
    jcfg, tcfg, jparams, state = weights
    x = np.random.default_rng(4).standard_normal((2, 37, tcfg.d_model)) * 0.5
    for per, i in ((0, 0), (1, 0)):
        jlp = {k[len("periods/mamba_"):]: v[per, i]
               for k, v in jparams.items() if k.startswith("periods/mamba_")}
        tlp = {k[len("periods/mamba_"):]: v[per, i]
               for k, v in state.items() if k.startswith("periods/mamba_")}
        want = j_mamba2.mixer_apply(jlp, jnp.asarray(x, jnp.float32), jcfg,
                                    None)
        got = mamba2.mixer_apply(tlp, torch.tensor(x, dtype=torch.float32),
                                 tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **BLOCK_TOL)


@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_moe_block_matches_the_reference(weights, cf):
    """The MoE block in the single-device layout; at capacity factor 0.5
    experts overflow, so which tokens drop (the FIFO order) is held too."""
    jcfg, tcfg, jparams, state = weights
    jcfg, tcfg = _with_capacity(jcfg, cf), _with_capacity(tcfg, cf)
    x = np.random.default_rng(5).standard_normal((2, 24, tcfg.d_model))
    names = {"router": "router", "w_gate": "moe_gate", "w_up": "moe_up",
             "w_down": "moe_down"}
    jp = {k: jparams[f"periods/{v}"][0, 0] for k, v in names.items()}
    tp = {k: state[f"periods/{v}"][0, 0] for k, v in names.items()}
    want, jaux = j_moe.moe_block(jnp.asarray(x, jnp.float32), jp, jcfg, None)
    got, aux = moe.moe_block(torch.tensor(x, dtype=torch.float32), tp, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    # were tokens dropped?  (same routing as the block above)
    x2d = torch.tensor(x, dtype=torch.float32).reshape(-1, tcfg.d_model)
    idx, _w, _a = moe.router_topk(x2d, tp["router"], tcfg.moe.top_k)
    cap = moe.capacity(x2d.shape[0], tcfg.moe)
    _slot, keep = moe._fifo_slots(idx.reshape(-1), tcfg.moe.num_experts, cap)
    assert bool((~keep).any()) == (cf < 1)


@pytest.mark.parametrize("window", [None, 5])
def test_attention_functions_match_the_reference(window):
    """``repeat_kv``, ``reference_attention``, the flash kernel's op and
    single-shard decode attention against ``repro.models.attention``."""
    from repro.models import attention as j_attn
    from repro_torch.kernels.ops import flash_attention_op
    from repro_torch.models import attention as attn
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               ((2, 11, 4, 16), (2, 11, 2, 16), (2, 11, 2, 16)))
    tq, tk, tv = (torch.tensor(a) for a in (q, k, v))
    np.testing.assert_array_equal(attn.repeat_kv(tk, 2).numpy(),
                                  np.asarray(j_attn.repeat_kv(k, 2)))
    want = j_attn.reference_attention(q, k, v, causal=True, window=window)
    for fn in (attn.reference_attention, flash_attention_op):
        got = fn(tq, tk, tv, causal=True, window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **BLOCK_TOL)
    lens = np.array([11, 6], np.int32)
    jout, (jnum, jm, jden) = j_attn._local_decode(
        q[:, 0], k, v, jnp.asarray(lens), 0, window)
    out, (num, m, den) = attn._local_decode(tq[:, 0], tk, tv,
                                            torch.tensor(lens), 0, window)
    for a, b in ((out, jout), (num, jnum), (m, jm), (den, jden)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **BLOCK_TOL)
    np.testing.assert_array_equal(
        attn.decode_attention(tq[:, 0], tk, tv, torch.tensor(lens),
                              window).numpy(), out.numpy())


def test_fifo_slots_rank_token_major_k_minor():
    slot, keep = moe._fifo_slots(torch.tensor([1, 0, 1, 1, 0, 1]), 2, 2)
    assert slot.tolist() == [0, 0, 1, 2, 1, 3]
    assert keep.tolist() == [True, True, True, False, True, False]


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

def test_forward_matches_the_reference(weights):
    jcfg, tcfg, jparams, state = weights
    tokens = _tokens(tcfg)
    want, jaux = jax.jit(lambda p, t: j_jamba.forward(p, t, jcfg))(
        jparams, jnp.asarray(tokens, jnp.int32))
    got, aux = _model(tcfg, state)(torch.tensor(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-4)
    last, _ = _model(tcfg, state)(torch.tensor(tokens), last_only=True)
    np.testing.assert_allclose(last[:, 0].numpy(), got[:, -1].numpy(),
                               rtol=1e-6, atol=1e-6)


def test_forward_matches_the_reference_with_kernel_rules(weights):
    """Against the reference run on a 1x1 mesh with the flash attention
    and SSD kernels (Pallas, interpret mode)."""
    from repro.launch.mesh import make_test_mesh
    from repro.parallel.sharding import make_rules
    jcfg, tcfg, jparams, state = weights
    mesh = make_test_mesh((1, 1), ("data", "model"))
    rules = make_rules(mesh, attn_impl="flash", ssd_impl="kernel",
                       remat="none")
    tokens = _tokens(tcfg, seed=2)
    with mesh:
        want, _ = jax.jit(lambda p, t: j_jamba.forward(p, t, jcfg, rules))(
            jparams, jnp.asarray(tokens, jnp.int32))
    got, _ = _model(tcfg, state)(torch.tensor(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


def test_decode_step_matches_forward(weights):
    """Teacher-forced decode reproduces the forward logits (capacity
    factor 8: no drops, so the routing of a 2-token decode batch and of
    the 20-token forward agree)."""
    _jcfg, tcfg, _jparams, state = weights
    tcfg = _with_capacity(tcfg, 8.0)
    model = _model(tcfg, state)
    tokens = torch.tensor(_tokens(tcfg))
    logits, _ = model(tokens)
    cache = model.init_cache(tokens.shape[0], tokens.shape[1])
    outs = []
    for i in range(tokens.shape[1]):
        lg, cache = model.decode_step(cache, tokens[:, i])
        outs.append(lg)
    assert cache["len"].tolist() == [tokens.shape[1]] * tokens.shape[0]
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), logits.numpy(),
                               **LOGIT_TOL)


def test_decode_step_matches_the_reference(weights):
    """Three decode steps of the port against the reference's
    ``decode_step`` from the same empty cache."""
    jcfg, tcfg, jparams, state = weights
    model = _model(tcfg, state)
    tokens = _tokens(tcfg, B=3, S=3, seed=6)
    jcache = j_jamba.init_cache(jcfg, 3, 8)
    cache = model.init_cache(3, 8)
    step = jax.jit(lambda p, c, t: j_jamba.decode_step(p, c, t, jcfg))
    for i in range(3):
        want, jcache = step(jparams, jcache, jnp.asarray(tokens[:, i],
                                                         jnp.int32))
        got, cache = model.decode_step(cache, torch.tensor(tokens[:, i]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **LOGIT_TOL)
    for k in ("k", "v", "state", "conv", "len"):
        np.testing.assert_allclose(cache[k].float().numpy(),
                                   np.asarray(jcache[k], np.float32),
                                   **LOGIT_TOL, err_msg=k)
