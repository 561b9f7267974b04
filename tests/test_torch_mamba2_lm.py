"""The port's Mamba-2 LM (``mamba2-370m``) against the JAX package on the
CPU: forward logits against ``repro.models.mamba2.forward`` with
``rules=None`` (its chunked jnp SSD) and with the 1x1-mesh
``ssd_impl="kernel"`` rules (the Pallas SSD kernel in interpret mode);
``decode_step`` against the reference's, every cache leaf compared; and
teacher-forced decode against the forward.

Same weights (the JAX ``init_params`` converted with ``params_from_jax``)
and tokens from a numpy seed.  Tolerance 2e-4 on logits and on the fp32
state, as ``tests/test_torch_jamba.py`` states it (fp32, sums in other
orders through the layers); S = 37 runs three chunks of 16, the last
ragged.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.models import mamba2 as j_mamba2
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import get_model
from repro_torch.models.convert import params_from_jax
from repro_torch.models.mamba2 import Mamba2LM

ARCH = "mamba2-370m"
LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def weights():
    jcfg = j_reduced_config(j_get_config(ARCH))
    tcfg = reduced_config(get_config(ARCH))
    jparams = j_mamba2.init_params(jcfg, jax.random.PRNGKey(0))
    state = params_from_jax(tcfg, {k: np.asarray(v)
                                   for k, v in jparams.items()},
                            device="cpu")
    model = get_model(tcfg)(tcfg, device="cpu", params=state)
    assert isinstance(model, Mamba2LM)
    return jcfg, tcfg, jparams, model


def _tokens(cfg, B=2, S=37, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


@pytest.mark.parametrize("kernel_rules", [False, True])
def test_forward_matches_the_reference(weights, kernel_rules):
    jcfg, tcfg, jparams, model = weights
    tokens = _tokens(tcfg)
    if kernel_rules:
        from repro.launch.mesh import make_test_mesh
        from repro.parallel.sharding import make_rules
        mesh = make_test_mesh((1, 1), ("data", "model"))
        rules = make_rules(mesh, ssd_impl="kernel", remat="none")
        with mesh:
            want, _ = jax.jit(lambda p, t: j_mamba2.forward(
                p, t, jcfg, rules))(jparams, jnp.asarray(tokens, jnp.int32))
    else:
        want, _ = jax.jit(lambda p, t: j_mamba2.forward(p, t, jcfg))(
            jparams, jnp.asarray(tokens, jnp.int32))
    got, aux = model(torch.tensor(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    assert float(aux) == 0.0
    last, _ = model(torch.tensor(tokens), last_only=True)
    np.testing.assert_allclose(last[:, 0].numpy(), got[:, -1].numpy(),
                               rtol=1e-6, atol=1e-6)


def test_decode_step_matches_the_reference(weights):
    """Four decode steps against the reference's ``decode_step`` from the
    same empty cache: logits, ``state``, ``conv`` and ``len``."""
    jcfg, tcfg, jparams, model = weights
    tokens = _tokens(tcfg, B=3, S=4, seed=6)
    jcache = j_mamba2.init_cache(jcfg, 3, 8)
    cache = model.init_cache(3, 8)
    assert set(cache) == set(jcache)
    for k in cache:
        assert tuple(cache[k].shape) == jcache[k].shape, k
        assert str(cache[k].dtype).split(".")[-1] == str(jcache[k].dtype), k
    step = jax.jit(lambda p, c, t: j_mamba2.decode_step(p, c, t, jcfg))
    for i in range(4):
        want, jcache = step(jparams, jcache, jnp.asarray(tokens[:, i],
                                                         jnp.int32))
        got, cache = model.decode_step(cache, torch.tensor(tokens[:, i]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **LOGIT_TOL)
    for k in ("state", "conv"):
        np.testing.assert_allclose(cache[k].float().numpy(),
                                   np.asarray(jcache[k], np.float32),
                                   **LOGIT_TOL, err_msg=k)
    np.testing.assert_array_equal(cache["len"].numpy(),
                                  np.asarray(jcache["len"]))


def test_decode_step_matches_forward(weights):
    _jcfg, tcfg, _jp, model = weights
    tokens = torch.tensor(_tokens(tcfg, S=20, seed=2))
    logits, _ = model(tokens)
    cache = model.init_cache(2)
    outs = []
    for i in range(tokens.shape[1]):
        lg, cache = model.decode_step(cache, tokens[:, i])
        outs.append(lg)
    assert cache["len"].tolist() == [20, 20]
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), logits.numpy(),
                               **LOGIT_TOL)
