"""The port's dense / MoE / VLM transformer against the JAX package on the
CPU.

* ``param_table`` and the dtypes equal the reference's (the transformer
  archs and the Mamba-2 LM); ``params_from_jax`` round-trips in fp32 and
  bf16; ``init_params`` follows the reference's rules;
* ``mrope`` equals ``repro.models.layers.mrope``;
* the forward logits equal ``repro.models.transformer.forward`` with
  ``rules=None`` for every transformer arch (``last_only`` too) and with
  the 1x1-mesh flash rules (the Pallas kernel in interpret mode) for
  Mixtral and Qwen2-VL, Qwen2-VL also on image-like positions (repeated
  temporal ids, where the flash path masks by token index);
* teacher-forced ``decode_step`` equals ``forward``; three steps equal
  the reference's ``decode_step`` on every cache leaf; a sliding-window
  cache wraps as the reference's does and is allocated at
  ``min(window, max_seq)``.

Both packages run on the same weights (the JAX ``init_params``, converted
with ``params_from_jax``) and the same tokens from a numpy seed.
Tolerances, as ``tests/test_torch_jamba.py`` states them: 2e-4 on logits
(fp32, sums in other orders through the layers), 1e-4 on the MoE aux
loss; the MoE archs run at capacity factor 8 where decode is compared
with the forward, so no token drops in either.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.models import get_model as j_get_model
from repro.models import layers as j_layers
from repro.models import transformer as j_tf
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import get_model, layers, mamba2, transformer
from repro_torch.models.convert import init_params, params_from_jax

LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)
TRANSFORMERS = ["stablelm-3b", "qwen2-72b", "yi-34b", "qwen1.5-32b",
                "mixtral-8x7b", "moonshot-v1-16b-a3b", "qwen2-vl-72b"]
TABLE_ARCHS = ["stablelm-3b", "qwen2-72b", "mixtral-8x7b",
               "moonshot-v1-16b-a3b", "qwen2-vl-72b", "mamba2-370m"]


def _cfgs(arch, cf=None, **overrides):
    j = j_reduced_config(j_get_config(arch), **overrides)
    t = reduced_config(get_config(arch), **overrides)
    if cf is not None:
        j, t = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=cf)) for c in (j, t))
    return j, t


_WEIGHTS = {}


def _weights(arch, cf=None, **overrides):
    """(JAX config, port config, JAX params, port model) of the reduced
    ``arch`` on the same weights (cached per arguments)."""
    key = (arch, cf, tuple(sorted(overrides.items())))
    if key not in _WEIGHTS:
        jcfg, tcfg = _cfgs(arch, cf, **overrides)
        jparams = j_get_model(jcfg).init_params(jcfg, jax.random.PRNGKey(0))
        state = params_from_jax(tcfg, {k: np.asarray(v) for k, v in
                                       jparams.items()}, device="cpu")
        _WEIGHTS[key] = (jcfg, tcfg, jparams,
                         get_model(tcfg)(tcfg, device="cpu", params=state))
    return _WEIGHTS[key]


def _tokens(cfg, B=2, S=12, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def _image_positions(B, S, seed=3):
    """(3, B, S) positions of an image-like stretch: temporal ids repeat
    over 2x2 patches, height and width walk the patch grid."""
    rng = np.random.default_rng(seed)
    t = np.arange(S) // 4
    h = (np.arange(S) // 2) % 2 + t
    w = np.arange(S) % 2 + t
    pos = np.stack([t, h, w])[:, None, :].repeat(B, 1)
    return (pos + rng.integers(0, 2, (1, B, 1))).astype(np.int32)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", TABLE_ARCHS)
def test_param_table_and_dtypes_match_the_reference(arch):
    jcfg, tcfg = _cfgs(arch)
    jmod = j_get_model(jcfg)
    model = get_model(tcfg)
    assert model is (mamba2.Mamba2LM if arch == "mamba2-370m"
                     else transformer.Transformer)
    jt = jmod.param_table(jcfg)
    assert model.param_table(tcfg) == {k: s for k, (s, _a) in jt.items()}
    js = jmod.param_shapes(jcfg)
    for k in jt:
        assert str(model.param_dtype(tcfg, k)).split(".")[-1] == \
            str(js[k].dtype), k


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen2-vl-72b",
                                  "mamba2-370m"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_round_trips(arch, dtype):
    jcfg, tcfg = _cfgs(arch, dtype=dtype)
    model = get_model(tcfg)
    jparams = {k: np.asarray(v) for k, v in
               j_get_model(jcfg).init_params(jcfg, jax.random.PRNGKey(3))
               .items()}
    state = params_from_jax(tcfg, jparams, device="cpu")
    for k, v in state.items():
        assert v.dtype == model.param_dtype(tcfg, k)
        np.testing.assert_array_equal(v.float().numpy(),
                                      jparams[k].astype(np.float32),
                                      err_msg=k)
    assert set(model(tcfg, "cpu", params=state).state_dict()) == \
        set(jparams)
    with pytest.raises(KeyError):
        params_from_jax(tcfg, {k: v for k, v in jparams.items()
                               if k != "embed"}, device="cpu")


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "mixtral-8x7b",
                                  "mamba2-370m"])
def test_init_params_follows_the_reference_rules(arch):
    """Compared with the reference's own ``init_params`` leaf by leaf:
    constant leaves equal (``A_log`` within an fp32 ulp), dense leaves truncated normal at the same
    fan-in scale, every dtype the reference's."""
    jcfg, tcfg = _cfgs(arch)
    want = {k: np.asarray(v, np.float32) for k, v in
            j_get_model(jcfg).init_params(jcfg, jax.random.PRNGKey(0))
            .items()}
    p = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    model = get_model(tcfg)
    assert set(p) == set(want)
    for k, v in p.items():
        assert v.dtype == model.param_dtype(tcfg, k), k
        got = v.float().numpy()
        rule = model.init_rule(k)
        if rule != "dense":      # A_log: two libraries' log, within 1 ulp
            np.testing.assert_allclose(got, want[k], rtol=1.2e-7, atol=0,
                                       err_msg=k)
        else:
            fan_in = v.shape[-2] if v.dim() >= 2 else v.shape[-1]
            assert float(v.abs().max()) <= 2 * fan_in ** -0.5 + 1e-6, k
            assert 0.5 < float(v.std()) * fan_in ** 0.5 < 1.0, k
    biases = [k for k in p if k.startswith("layers/b")]
    assert bool(biases) == tcfg.qkv_bias


def test_mrope_matches_the_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 3, 32)).astype(np.float32)
    pos = rng.integers(0, 50, (3, 2, 9)).astype(np.int32)
    sections = reduced_config(get_config("qwen2-vl-72b")).mrope_sections
    want = j_layers.mrope(jnp.asarray(x), jnp.asarray(pos), sections, 1e6)
    got = layers.mrope(torch.tensor(x), torch.tensor(pos), sections, 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # one stream everywhere is RoPE
    same = np.broadcast_to(pos[:1], pos.shape)
    np.testing.assert_allclose(
        layers.mrope(torch.tensor(x), torch.tensor(same), sections).numpy(),
        layers.rope(torch.tensor(x), torch.tensor(pos[0]), 1e6).numpy(),
        rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        layers.mrope(torch.tensor(x), torch.tensor(pos), (4, 4, 4))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", TRANSFORMERS)
def test_forward_matches_the_reference(arch):
    jcfg, tcfg, jparams, model = _weights(arch)
    tokens = _tokens(tcfg)
    want, jaux = jax.jit(lambda p, t: j_tf.forward(p, t, jcfg))(
        jparams, jnp.asarray(tokens, jnp.int32))
    got, aux = model(torch.tensor(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-4,
                               atol=1e-4)
    assert (float(aux) > 0) == (tcfg.moe is not None)
    last, _ = model(torch.tensor(tokens), last_only=True)
    np.testing.assert_allclose(last[:, 0].numpy(), got[:, -1].numpy(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch,image", [("mixtral-8x7b", False),
                                        ("qwen2-vl-72b", False),
                                        ("qwen2-vl-72b", True)])
def test_forward_matches_the_reference_with_flash_rules(arch, image):
    """Against the reference on a 1x1 mesh with its flash kernel (Pallas,
    interpret mode), which masks by token index as the port's does; for
    Qwen2-VL also on image-like positions, where the reference's
    ``rules=None`` path would mask by ``positions[0]`` instead."""
    from repro.launch.mesh import make_test_mesh
    from repro.parallel.sharding import make_rules
    jcfg, tcfg, jparams, model = _weights(arch)
    mesh = make_test_mesh((1, 1), ("data", "model"))
    rules = make_rules(mesh, attn_impl="flash", remat="none")
    tokens = _tokens(tcfg, S=20, seed=2)
    pos = _image_positions(2, 20) if image else None
    with mesh:
        want, _ = jax.jit(lambda p, t, q: j_tf.forward(
            p, t, jcfg, rules, positions=q))(
                jparams, jnp.asarray(tokens, jnp.int32),
                None if pos is None else jnp.asarray(pos))
    got, _ = model(torch.tensor(tokens),
                   positions=None if pos is None else torch.tensor(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    if image:      # the positions matter: text positions give other logits
        text, _ = model(torch.tensor(tokens))
        assert float((text - got).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["stablelm-3b", "mixtral-8x7b",
                                  "moonshot-v1-16b-a3b", "qwen2-vl-72b"])
def test_decode_step_matches_forward(arch):
    """Teacher-forced decode reproduces the forward logits at every
    position (capacity factor 8: no drops in either)."""
    _jcfg, tcfg, _jp, model = _weights(arch, cf=8.0 if arch in (
        "mixtral-8x7b", "moonshot-v1-16b-a3b") else None)
    tokens = torch.tensor(_tokens(tcfg))
    logits, _ = model(tokens)
    cache = model.init_cache(2, 16)
    outs = []
    for i in range(tokens.shape[1]):
        lg, cache = model.decode_step(cache, tokens[:, i])
        outs.append(lg)
    assert cache["len"].tolist() == [tokens.shape[1]] * 2
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), logits.numpy(),
                               **LOGIT_TOL)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen2-vl-72b"])
def test_decode_step_matches_the_reference(arch):
    """Three decode steps of the port against the reference's
    ``decode_step`` from the same empty cache, every cache leaf compared
    (``pos`` and ``len`` exactly)."""
    jcfg, tcfg, jparams, model = _weights(arch)
    tokens = _tokens(tcfg, B=3, S=3, seed=6)
    jcache = j_tf.init_cache(jcfg, 3, 8)
    cache = model.init_cache(3, 8)
    step = jax.jit(lambda p, c, t: j_tf.decode_step(p, c, t, jcfg))
    for i in range(3):
        want, jcache = step(jparams, jcache, jnp.asarray(tokens[:, i],
                                                         jnp.int32))
        got, cache = model.decode_step(cache, torch.tensor(tokens[:, i]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **LOGIT_TOL)
    assert set(cache) == set(jcache)
    for k in ("k", "v"):
        np.testing.assert_allclose(cache[k].float().numpy(),
                                   np.asarray(jcache[k], np.float32),
                                   **LOGIT_TOL, err_msg=k)
    for k in ("pos", "len"):
        np.testing.assert_array_equal(cache[k].numpy(), np.asarray(jcache[k]))


def test_sliding_window_decode_wraps_as_the_reference():
    """A 6-slot window cache over 20 tokens wraps three times: logits at
    every step equal the reference's decode and the port's forward, and
    ``pos`` (the position held in each slot) equals the reference's
    after every step."""
    jcfg, tcfg, jparams, model = _weights("mixtral-8x7b", cf=8.0,
                                          sliding_window=6)
    tokens = _tokens(tcfg, B=1, S=20, seed=4)
    logits, _ = model(torch.tensor(tokens))
    jcache = j_tf.init_cache(jcfg, 1, 20)
    cache = model.init_cache(1, 20)
    assert cache["k"].shape[2] == jcache["k"].shape[2] == 6
    step = jax.jit(lambda p, c, t: j_tf.decode_step(p, c, t, jcfg))
    for i in range(20):
        want, jcache = step(jparams, jcache, jnp.asarray(tokens[:, i],
                                                         jnp.int32))
        got, cache = model.decode_step(cache, torch.tensor(tokens[:, i]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **LOGIT_TOL)
        np.testing.assert_allclose(got.numpy(), logits[:, i].numpy(),
                                   **LOGIT_TOL)
        np.testing.assert_array_equal(cache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))
    assert cache["pos"].tolist() == [[18, 19, 14, 15, 16, 17]]


def test_cache_is_allocated_at_the_window():
    _j, tcfg, _p, model = _weights("mixtral-8x7b")
    assert tcfg.sliding_window == 16
    for max_seq, want in ((8, 8), (16, 16), (64, 16)):
        c = model.init_cache(2, max_seq)
        assert c["k"].shape == (tcfg.num_layers, 2, want, 2, 32)
        assert c["pos"].shape == (2, want)
    c = model.init_cache(1, 64, filled=3)
    assert c["pos"][0, :5].tolist() == [0, 1, 2, -1, -1]
    assert c["len"].tolist() == [3]
    _j, tcfg, _p, dense = _weights("qwen2-72b")
    assert dense.init_cache(1, 64)["k"].shape[2] == 64
