"""The port's training path against the JAX package on the CPU: the cross
entropy, every family's loss and gradients, remat, AdamW and the train
step.

* ``models/layers.cross_entropy`` against ``repro.models.layers.
  cross_entropy``, with and without a mask;
* each family's ``loss`` and the gradient of every parameter against
  ``jax.value_and_grad`` of the reference's ``loss_fn`` with
  ``rules=None`` (its jnp attention, chunked SSD and einsum GMM): the
  hybrid (Jamba), the MoE transformer (Mixtral, with a capacity factor
  small enough that experts drop tokens), the VLM (Qwen2-VL, with distinct
  (3, B, S) M-RoPE positions), a dense transformer (StableLM), the SSM
  (Mamba-2) and the encoder-decoder (Whisper); the port runs its kernels'
  plain versions and their backward (the recompute);
* ``remat="full"`` against ``"none"``: the same loss and gradients;
* ``schedule``, ``no_decay``, ``clip_by_global_norm`` and three
  ``apply``s against ``repro.optim`` (master, m, v, parameters, bf16
  parameters included);
* three ``train_step``s against ``make_train_step(cfg, None, opt_cfg)``:
  losses, metrics and parameters.

Same weights (the reference's ``init_params`` through
``params_from_jax``) and batches (``synthetic_batch``, numpy).
Tolerances: the loss within 1e-5 relative, each gradient within 1e-4 of
its largest magnitude plus 1e-3 relative (fp32, sums in other orders
through a few layers; the largest seen is 1.3e-5 of the magnitude, on
Jamba's ``A_log``).  AdamW in fp32: 1e-6 relative (the same arithmetic,
one fused multiply-add apart).  Parameters after three train steps: all
but 1% within 1e-6, every one within 2e-4 (2% of the peak lr): Adam's
first update is g / (|g| + eps), so a gradient within a few eps of zero
moves its parameter by an amount its rounding decides, up to ``lr``;
those few then route the next steps a little apart (seen: 0.4% beyond
1e-6 after three steps, the largest 1.0e-4).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as j_optim
from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.data.pipeline import synthetic_batch as j_synthetic_batch
from repro.launch.step import make_train_step
from repro.models import layers as j_layers
from repro.models.api import get_model as j_get_model
from repro_torch import optim
from repro_torch.configs import get_config, reduced_config
from repro_torch.launch.step import train_step
from repro_torch.models import get_model, layers, moe
from repro_torch.models.convert import params_from_jax

SEQ, BATCH = 24, 2
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)


def _cfgs(arch, capacity_factor=None):
    j = j_reduced_config(j_get_config(arch))
    t = reduced_config(get_config(arch))
    if capacity_factor is not None:
        j, t = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=capacity_factor)) for c in (j, t))
    return j, t


def _batch(jcfg, step=0, seq=SEQ, batch=BATCH):
    b = j_synthetic_batch(jcfg, JShapeConfig("t", seq, batch, "train"), step)
    if jcfg.mrope_sections is not None:
        # distinct h/w streams; the temporal one is the token index, since
        # the reference's rules=None attention masks by it where the port's
        # flash masks by index (ROADMAP C-5)
        i = np.arange(seq, dtype=np.int32)
        b["positions"] = np.broadcast_to(
            np.stack([i, i // 2, i // 4])[:, None], (3, batch, seq)).copy()
    return b


def _port_model(jcfg, tcfg, jparams):
    state = params_from_jax(tcfg, {k: np.asarray(v)
                                   for k, v in jparams.items()}, "cpu")
    return get_model(tcfg)(tcfg, "cpu", params=state)


def _tensors(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _assert_grads(model, jgrads):
    for name, p in model.named_parameters():
        want = np.asarray(jgrads[name], np.float32)
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-3,
                                   atol=1e-4 * scale + 1e-9, err_msg=name)


# ---------------------------------------------------------------------------
# cross entropy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_the_reference(masked):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) > 0.3).astype(np.float32) if masked else None
    want = j_layers.cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask))
    got = layers.cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_cross_entropy_with_an_empty_mask_is_zero():
    got = layers.cross_entropy(torch.randn(2, 3, 5),
                               torch.zeros(2, 3, dtype=torch.int32),
                               torch.zeros(2, 3))
    assert float(got) == 0.0


# ---------------------------------------------------------------------------
# every family's loss and gradients
# ---------------------------------------------------------------------------

FAMILIES = [("jamba-v0.1-52b", None), ("mixtral-8x7b", 0.5),
            ("qwen2-vl-72b", None), ("stablelm-3b", None),
            ("mamba2-370m", None), ("whisper-large-v3", None)]


@pytest.mark.parametrize("arch,capacity_factor", FAMILIES)
def test_loss_and_gradients_match_the_reference(arch, capacity_factor,
                                                monkeypatch):
    jcfg, tcfg = _cfgs(arch, capacity_factor)
    dropped = []
    fifo_slots = moe._fifo_slots

    def recording(*a):
        slot, keep = fifo_slots(*a)
        dropped.append(not bool(keep.all()))
        return slot, keep

    monkeypatch.setattr(moe, "_fifo_slots", recording)
    jm = j_get_model(jcfg)
    jparams = jm.init_params(jcfg, jax.random.PRNGKey(0))
    batch = _batch(jcfg)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss_fn(p, b, jcfg, None), has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    model = _port_model(jcfg, tcfg, jparams).requires_grad_(True)
    tb = _tensors(batch)
    loss, met = model.loss(tb)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **LOSS_TOL)
    assert set(met) == set(jmet)
    for k in met:
        np.testing.assert_allclose(met[k].item(), float(jmet[k]),
                                   **LOSS_TOL)
    _assert_grads(model, jgrads)
    dropped = any(dropped)
    if capacity_factor is not None:
        assert dropped, "no expert overflowed: the case tests no drops"


# ``"full"`` for Jamba and Whisper keep their ids from before ``"dots"``
REMAT_CASES = [pytest.param(arch, remat, id=arch if remat == "full" and arch
                            in ("jamba-v0.1-52b", "whisper-large-v3")
                            else f"{remat}-{arch}")
               for remat in ("full", "dots") for arch, _cf in FAMILIES]


@pytest.mark.parametrize("arch,remat", REMAT_CASES)
def test_remat_full_gives_the_same_loss_and_gradients(arch, remat):
    """``remat`` ("full", and "dots" the reference's
    ``checkpoint_dots_with_no_batch_dims``) against ``"none"``: the same
    loss and gradients in every family."""
    jcfg, tcfg = _cfgs(arch)
    jparams = j_get_model(jcfg).init_params(jcfg, jax.random.PRNGKey(1))
    batch = _tensors(_batch(jcfg, step=1))
    out = {}
    for policy in ("none", remat):
        model = _port_model(jcfg, tcfg, jparams).requires_grad_(True)
        loss, _ = model.loss(batch, remat=policy)
        loss.backward()
        out[policy] = (loss.item(), {k: p.grad.clone() for k, p
                                     in model.named_parameters()})
    assert out[remat][0] == pytest.approx(out["none"][0], rel=1e-6)
    for k, g in out["none"][1].items():
        torch.testing.assert_close(out[remat][1][k], g, rtol=1e-5,
                                   atol=1e-7)


def _jax_layer(arch, jcfg, jparams, positions):
    """(one layer of the reference under its ``remat="dots"`` treatment,
    its parameters): the transformer's ``_layer_body``, Jamba's period,
    Mamba-2's block, Whisper's encoder layer (``jax.checkpoint`` with no
    policy: the reference's Whisper takes "dots" as "full")."""
    from repro.models import jamba as jj, mamba2 as jm
    from repro.models import transformer as jt, whisper as jw
    from repro.models.layers import rms_norm
    policy = jax.checkpoint_policies.checkpoint_dots_with_no_batch_dims
    first = lambda tree: jax.tree.map(lambda a: a[0], tree)  # noqa: E731
    if jcfg.family == "hybrid":
        body = lambda x, pp: jj._period_body(  # noqa: E731
            x, pp, positions, jcfg, None)[0]
        return jax.checkpoint(body, policy=policy), first(
            jj._split(jparams)[1])
    if jcfg.family == "ssm":
        body = lambda x, lp: x + jm.mixer_apply(  # noqa: E731
            lp, rms_norm(x, lp["norm"], jcfg.norm_eps), jcfg, None)
        return jax.checkpoint(body, policy=policy), first(
            jm._split(jparams)[1])
    if jcfg.family == "audio":
        body = lambda x, lp: jw._mlp(jw._sa(  # noqa: E731
            x, lp, "enc", jcfg, None, positions, causal=False), lp, "enc",
            jcfg, None)
        return jax.checkpoint(body), first(jw._split(jparams)[1])
    body = lambda x, lp: jt._layer_body(  # noqa: E731
        x, lp, positions, jcfg, None)[0]
    return jax.checkpoint(body, policy=policy), first(
        jt._split_layers(jparams)[1])


def _port_layer(model, x, positions):
    """(the port's function of the same layer, its arguments)."""
    if model.cfg.family == "hybrid":
        return (lambda *a: model._period(*a)[0]), (x, 0, positions)
    if model.cfg.family == "ssm":
        return model._block, (x, 0)
    if model.cfg.family == "audio":
        return model._enc_layer, (x, 0, positions)
    return (lambda *a: model._block(*a)[0]), (x, 0, positions)


def _flat(shape):
    """A product's output as the 2-D matrix ``mm`` writes: its leading
    dimensions folded (the reference keeps them; the port's ``x @ w``
    folds them and views the result back)."""
    lead = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
    return (lead, int(shape[-1]))


@pytest.mark.parametrize("arch", [a for a, _cf in FAMILIES])
def test_dots_saves_the_references_products(arch, monkeypatch):
    """What one layer keeps for its backward under ``remat="dots"``.

    * The reference: ``jax.ad_checkpoint.print_saved_residuals`` of the
      layer under ``checkpoint_dots_with_no_batch_dims``: its arguments
      and the outputs of the products with no batch dimensions that its
      backward reads.
    * The port: the tensors autograd saves, counted with
      ``torch.autograd.graph.saved_tensors_hooks`` (the checkpoint keeps
      the layer's inputs), and the products the selective checkpoint
      caches, counted by a dispatch mode beside it in the forward and in
      the recompute.

    The products the recompute reads are the reference's residual
    products, shape for shape (the leading dimensions folded); the
    forward may cache, beyond them, only a last product whose output the
    backward never reads (``run_layer``'s docstring).  The layer's saved
    bytes (parameters not counted) order ``none > dots > full``;
    Whisper's ``dots`` is its ``full``."""
    import contextlib
    import io
    import jax.ad_checkpoint
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.models import base, whisper
    jcfg, tcfg = _cfgs(arch)
    jparams = j_get_model(jcfg).init_params(jcfg, jax.random.PRNGKey(3))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((BATCH, SEQ, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(SEQ, dtype=np.int32), (BATCH, SEQ))
    if jcfg.mrope_sections is not None:
        pos = np.broadcast_to(pos, (3, BATCH, SEQ))
    fn, lp = _jax_layer(arch, jcfg, jparams, jnp.asarray(pos))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jax.ad_checkpoint.print_saved_residuals(
            lambda x, lp: fn(x, lp).sum(), jnp.asarray(x), lp)
    lines = buf.getvalue().splitlines()

    def shape_of(line):
        dims = line.split("[", 1)[1].split("]", 1)[0]
        return tuple(int(d) for d in dims.split(",") if d)
    want_products = sorted(_flat(shape_of(ln)) for ln in lines
                           if " output of " in ln)
    want_args = sorted(shape_of(ln) for ln in lines
                       if "from the argument x" in ln)

    class Products(TorchDispatchMode):
        def __init__(self, seen):
            super().__init__()
            self.seen = seen

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func in base._NO_BATCH_PRODUCTS:
                self.seen.append(tuple(out.shape))
            return out

    cached, read = [], []
    dots_context = base._dots_context

    def counting():
        fwd, rec = dots_context()

        @contextlib.contextmanager
        def both(ctx, seen):
            with ctx, Products(seen):
                yield
        return both(fwd, cached), both(rec, read)

    monkeypatch.setattr(base, "_dots_context", counting)
    model = _port_model(jcfg, tcfg, jparams).requires_grad_(True)
    held = {p.untyped_storage().data_ptr() for p in model.parameters()}
    saved_bytes = {}
    for remat in ("none", "full", "dots"):
        cached.clear(), read.clear()
        saved = []

        def pack(t):
            if t.untyped_storage().data_ptr() not in held:
                saved.append(t)
            return t
        xt = torch.from_numpy(x).requires_grad_(True)
        layer, args = _port_layer(model, xt, torch.from_numpy(pos.copy()))
        policy = whisper._remat(remat) if tcfg.family == "audio" else remat
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            y = base.run_layer(layer, policy, *args)
        y.sum().backward()
        saved_bytes[remat] = sum(t.numel() * t.element_size()
                                 for t in saved) + 4 * sum(
            int(np.prod(s)) for s in cached)
        if remat == "dots":
            assert sorted(tuple(t.shape) for t in saved
                          if t.is_floating_point()) == want_args
            assert sorted(_flat(s) for s in read) == want_products
            extra = list(cached)
            for s in read:
                extra.remove(s)
            assert extra in ([], [(BATCH * SEQ, jcfg.d_model)]), extra
    if tcfg.family == "audio":
        assert want_products == []
        assert saved_bytes["none"] > saved_bytes["dots"] == \
            saved_bytes["full"]
    else:
        assert want_products
        assert saved_bytes["none"] > saved_bytes["dots"] > \
            saved_bytes["full"]


def test_remat_rejects_unknown_policies():
    _jcfg, tcfg = _cfgs("mamba2-370m")
    from repro_torch.models.convert import init_params
    model = get_model(tcfg)(tcfg, "cpu", params=init_params(
        tcfg, torch.Generator().manual_seed(0), "cpu"))
    with pytest.raises(ValueError, match="remat"):
        model(torch.zeros(1, 4, dtype=torch.long), remat="offload")


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

OPT = dict(lr_peak=1e-2, lr_min=1e-3, warmup_steps=2, total_steps=10)


def test_schedule_matches_the_reference():
    cfg, jcfg = optim.OptConfig(**OPT), j_optim.OptConfig(**OPT)
    for s in range(12):
        np.testing.assert_allclose(
            float(optim.schedule(cfg, torch.tensor(s, dtype=torch.int32))),
            float(j_optim.schedule(jcfg, jnp.asarray(s))), rtol=1e-6)
    assert float(optim.schedule(cfg, 0)) == 0.0


@pytest.mark.parametrize("name", ["layers/attn_norm", "layers/bq",
                                  "layers/A_log", "layers/dt_bias",
                                  "layers/D_skip", "layers/conv_b",
                                  "layers/wq", "embed", "lm_head",
                                  "periods/router", "final_norm"])
def test_no_decay_matches_the_reference(name):
    assert optim.no_decay(name) == j_optim.no_decay(name)


def _opt_inputs(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"w": (4, 8), "layers/b": (8,), "norm": (3,), "r": (2, 5)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * 3).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    return params, grads


def test_clip_by_global_norm_matches_the_reference():
    _params, grads = _opt_inputs()
    for max_norm in (1.0, 1e3):
        jc, jn = j_optim.clip_by_global_norm(
            {k: jnp.asarray(v) for k, v in grads[0].items()}, max_norm)
        tc, tn = optim.clip_by_global_norm(
            {k: torch.from_numpy(v) for k, v in grads[0].items()}, max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for k in jc:
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_three_applies_match_the_reference(param_dtype):
    """Master, m, v, step and the parameters (cast back to their dtype)
    after three steps; weight decay skipped for the bias and norm."""
    params, grads = _opt_inputs()
    cfg, jcfg = optim.OptConfig(**OPT), j_optim.OptConfig(**OPT)
    jp = {k: jnp.asarray(v).astype(param_dtype) for k, v in params.items()}
    tp = {k: torch.from_numpy(v).to(getattr(torch, param_dtype))
          for k, v in params.items()}
    js, ts = j_optim.init(jp), optim.init(tp)
    for g in grads:
        jp, js, jm = j_optim.apply(jcfg, jp, {k: jnp.asarray(v).astype(
            param_dtype) for k, v in g.items()}, js)
        tp, ts, tm = optim.apply(cfg, tp, {k: torch.from_numpy(v).to(
            getattr(torch, param_dtype)) for k, v in g.items()}, ts)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 3
    for part in ("master", "m", "v"):
        for k in params:
            np.testing.assert_allclose(ts[part][k].numpy(),
                                       np.asarray(js[part][k]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{part}/{k}")
    for k in params:
        assert tp[k].dtype == getattr(torch, param_dtype)
        np.testing.assert_allclose(tp[k].float().numpy(),
                                   np.asarray(jp[k], np.float32),
                                   rtol=1e-6 if param_dtype == "float32"
                                   else 2 ** -8, atol=1e-7)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def test_three_train_steps_match_make_train_step():
    jcfg, tcfg = _cfgs("mixtral-8x7b")
    jparams = j_get_model(jcfg).init_params(jcfg, jax.random.PRNGKey(2))
    model = _port_model(jcfg, tcfg, jparams).requires_grad_(True)
    cfg, jocfg = optim.OptConfig(**OPT), j_optim.OptConfig(**OPT)
    jstep = jax.jit(make_train_step(jcfg, None, jocfg))
    jstate = j_optim.init(jparams)
    state = optim.init(dict(model.named_parameters()))
    for i in range(3):
        batch = _batch(jcfg, step=i)
        jparams, jstate, jm = jstep(jparams, jstate, {
            k: jnp.asarray(v) for k, v in batch.items()})
        tm = train_step(model, cfg, state, _tensors(batch))
        assert set(tm) == set(jm) == {"loss", "ce", "moe_aux", "grad_norm",
                                      "lr"}
        for k in tm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
    diffs = []
    for name, p in model.named_parameters():
        assert p.grad is None
        diff = np.abs(p.detach().numpy() - np.asarray(jparams[name]))
        assert diff.max() <= 2e-4, (name, diff.max())
        diffs.append(diff.ravel())
    assert np.mean(np.concatenate(diffs) > 1e-6) <= 1e-2
