"""The port's Whisper encoder-decoder against the JAX package on the CPU.

* ``param_table`` and the dtypes equal the reference's; ``params_from_jax``
  round-trips in fp32 and bf16, the ``enc/`` and ``dec/`` names included;
  ``init_params`` follows the reference's rules;
* ``encode`` and ``forward`` (with ``frames``, with ``embeds`` in place of
  the encoder output, and ``last_only``) equal ``repro.models.whisper``
  with ``rules=None``;
* every leaf of ``init_cache(enc_out=...)`` equals the reference's;
* ``decode_step`` logits and every cache leaf equal the reference's over
  more steps than the self-attention cache holds, so it wraps; on a cache
  that does not wrap, teacher-forced decode equals ``forward``.

The reduced config has ``encoder_seq`` 20, so the cross KV is padded to 32
and decode's cross-attention mask (to ``encoder_seq``, not the padded
length) matters.  Both packages run on the same weights (the JAX
``init_params``, converted with ``params_from_jax``) and the same inputs
from a numpy seed.  Tolerances, as ``tests/test_torch_jamba.py`` states
them: 2e-4 on logits and activations (fp32, sums in other orders through
the layers).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.configs.base import EncDecConfig as JEncDecConfig
from repro.models import get_model as j_get_model
from repro.models import whisper as j_whisper
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import EncDecConfig
from repro_torch.models import get_model, whisper
from repro_torch.models.convert import init_params, params_from_jax

ARCH = "whisper-large-v3"
ENC_SEQ = 20
TOL = dict(rtol=2e-4, atol=2e-4)


def _cfgs(**overrides):
    j = j_reduced_config(j_get_config(ARCH), encdec=JEncDecConfig(
        encoder_layers=2, encoder_seq=ENC_SEQ), **overrides)
    t = reduced_config(get_config(ARCH), encdec=EncDecConfig(
        encoder_layers=2, encoder_seq=ENC_SEQ), **overrides)
    return j, t


@pytest.fixture(scope="module")
def weights():
    """(JAX config, port config, JAX params, port model) on the same
    weights."""
    jcfg, tcfg = _cfgs()
    jparams = j_whisper.init_params(jcfg, jax.random.PRNGKey(0))
    state = params_from_jax(tcfg, {k: np.asarray(v) for k, v in
                                   jparams.items()}, device="cpu")
    return jcfg, tcfg, jparams, get_model(tcfg)(tcfg, device="cpu",
                                                params=state)


def _frames(cfg, B=2, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.encdec.encoder_seq, cfg.d_model)).astype(np.float32)


def _tokens(cfg, B=2, S=9, seed=2):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(tol or TOL))


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def test_get_model_of_the_audio_family_is_whisper():
    assert get_model(get_config(ARCH)) is whisper.Whisper


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_param_table_and_dtypes_match_the_reference(dtype):
    jcfg, tcfg = _cfgs(dtype=dtype)
    jt = j_whisper.param_table(jcfg)
    assert whisper.param_table(tcfg) == {k: s for k, (s, _a) in jt.items()}
    js = j_whisper.param_shapes(jcfg)
    for k in jt:
        assert str(whisper.param_dtype(tcfg, k)).split(".")[-1] == \
            str(js[k].dtype), k
    full = whisper.param_table(get_config(ARCH))
    assert full["dec/cross_wk"] == (32, 1280, 1280)
    assert full["enc/enc_w_gate"] == (32, 1280, 5120)
    # 2.02 B parameters, 3.76 GiB in bf16 (the config's param_count
    # leaves out enc_final_norm's 1280)
    assert sum(int(np.prod(s)) for s in full.values()) == 2_020_421_120


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_jax_round_trips(dtype):
    jcfg, tcfg = _cfgs(dtype=dtype)
    jparams = {k: np.asarray(v) for k, v in
               j_get_model(jcfg).init_params(jcfg, jax.random.PRNGKey(3))
               .items()}
    state = params_from_jax(tcfg, jparams, device="cpu")
    assert any(k.startswith("enc/") for k in state)
    assert any(k.startswith("dec/cross_") for k in state)
    for k, v in state.items():
        assert v.dtype == whisper.param_dtype(tcfg, k)
        np.testing.assert_array_equal(v.float().numpy(),
                                      np.asarray(jparams[k], np.float32),
                                      err_msg=k)
    model = get_model(tcfg)(tcfg, device="cpu", params=state)
    assert model.state_dict().keys() == state.keys()


def test_init_params_follows_the_reference_rules():
    _j, tcfg = _cfgs()
    p = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert set(p) == set(whisper.param_table(tcfg))
    for k, v in p.items():
        if "norm" in k:
            assert bool((v == 1).all()), k
        else:
            fan_in = v.shape[-2]
            assert float(v.abs().max()) <= 2 * fan_in ** -0.5 + 1e-6, k
    again = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(p[k], again[k]) for k in p)


# ---------------------------------------------------------------------------
# encode and forward
# ---------------------------------------------------------------------------

def test_encode_matches_the_reference(weights):
    jcfg, tcfg, jparams, model = weights
    frames = _frames(tcfg)
    want = j_whisper.encode(jparams, jnp.asarray(frames), jcfg)
    got = model.encode(torch.from_numpy(frames))
    assert tuple(got.shape) == (2, ENC_SEQ, tcfg.d_model)
    _close(got, want)


@pytest.mark.parametrize("source", ["frames", "embeds"])
@pytest.mark.parametrize("last_only", [False, True])
def test_forward_logits_match_the_reference(weights, source, last_only):
    jcfg, tcfg, jparams, model = weights
    tokens = _tokens(tcfg)
    x = _frames(tcfg, seed=4)
    jl, jaux = j_whisper.forward(jparams, jnp.asarray(tokens), jcfg, None,
                                 last_only=last_only,
                                 **{source: jnp.asarray(x)})
    tl, taux = model(torch.from_numpy(tokens), last_only=last_only,
                     **{source: torch.from_numpy(x)})
    assert tuple(tl.shape) == tuple(jl.shape)
    _close(tl, jl)
    assert float(taux) == float(jaux) == 0.0


def test_forward_needs_frames_or_embeds(weights):
    _j, tcfg, _p, model = weights
    with pytest.raises(ValueError, match="frames"):
        model(torch.from_numpy(_tokens(tcfg)))


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _j_cache(jcfg, jparams, B, max_seq, enc_out):
    return j_whisper.init_cache(jcfg, B, max_seq, enc_out=enc_out,
                                params=jparams)


def test_init_cache_leaves_match_the_reference(weights):
    jcfg, tcfg, jparams, model = weights
    enc = model.encode(torch.from_numpy(_frames(tcfg, seed=5)))
    want = _j_cache(jcfg, jparams, 2, 8, jnp.asarray(enc.numpy()))
    got = model.init_cache(2, 8, enc_out=enc)
    assert set(got) == set(want) == {"k", "v", "xk", "xv", "len"}
    assert got["xk"].shape[2] == whisper.cross_seq(tcfg) == 32
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        _close(got[k], want[k])
    assert float(got["xk"][:, :, ENC_SEQ:].abs().sum()) == 0
    # without enc_out the cross KV stays zero, as the reference Server's
    empty = model.init_cache(2, 8)
    assert float(empty["xk"].abs().sum()) == float(empty["xv"].abs().sum()) \
        == 0


def test_decode_matches_the_reference_through_a_wrapping_cache(weights):
    """Nine steps against a self-attention cache of 5 rows (it wraps), the
    cross KV filled from an encoder output: logits and every cache leaf
    equal the reference's at every step."""
    jcfg, tcfg, jparams, model = weights
    enc = model.encode(torch.from_numpy(_frames(tcfg, seed=6)))
    jc = _j_cache(jcfg, jparams, 2, 5, jnp.asarray(enc.numpy()))
    tc = model.init_cache(2, 5, enc_out=enc)
    tokens = _tokens(tcfg, S=9, seed=7)
    for i in range(tokens.shape[1]):
        jl, jc = j_whisper.decode_step(jparams, jc,
                                       jnp.asarray(tokens[:, i]), jcfg)
        tl, tc = model.decode_step(tc, torch.from_numpy(tokens[:, i]))
        _close(tl, jl)
        for k in jc:
            _close(tc[k], jc[k])
    assert tc["len"].tolist() == [9, 9]


def test_teacher_forced_decode_equals_forward(weights):
    _j, tcfg, _p, model = weights
    tokens = torch.from_numpy(_tokens(tcfg, S=7, seed=8))
    enc = model.encode(torch.from_numpy(_frames(tcfg, seed=9)))
    full, _ = model(tokens, embeds=enc)
    cache = model.init_cache(2, 7, enc_out=enc)
    steps = []
    for i in range(tokens.shape[1]):
        lg, cache = model.decode_step(cache, tokens[:, i])
        steps.append(lg)
    _close(torch.stack(steps, 1), full)


def test_reset_slot_zeroes_only_the_length(weights):
    _j, _t, _p, model = weights
    cache = model.init_cache(2, 4)
    for leaf in cache.values():
        leaf.fill_(3)
    before = {k: v.clone() for k, v in cache.items()}
    model.reset_slot(cache, 1)
    assert cache["len"].tolist() == [3, 0]
    for k in ("k", "v", "xk", "xv"):
        assert torch.equal(cache[k], before[k])
