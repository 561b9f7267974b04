"""The three step kinds and the per-cell sharding rules (the port's
counterpart of ``repro.launch.step``).

* ``train_step``   — loss, backward and the AdamW update (one card, or
                     a mesh with ZeRO-1 / FSDP);
* ``prefill_step`` — forward, last-token logits only;
* ``serve_step``   — one ``decode_step`` against the KV cache, then greedy
                     next tokens.

The reference's ``make_train_step(cfg, rules, opt_cfg)``,
``make_prefill_step(cfg, rules)`` and ``make_serve_step(cfg, rules)``
build closures over the config and the sharding rules; here they are
plain functions of the model (an ``nn.Module`` from
``repro_torch.models.get_model``), each with an optional ``rules``:
without it they run on one card exactly as before; with it (on a mesh,
every rank calling them in lockstep with the global batch) the model
runs its SPMD islands and every rank gets the global result, the
training step the global loss and every rank's blocks updated.  Every
family runs them on a mesh: the transformer's, Mamba-2, Jamba and
Whisper.
:func:`cell_rules` adapts a strategy to a cell as the reference's does.
``batch["positions"]`` is passed through as the reference passes it: (B,
S), or (3, B, S) for Qwen2-VL's M-RoPE; for the ``audio`` family
(Whisper) ``batch["frames"]`` (B, encoder_seq, D) too.  The serving steps
build no autograd graph, whether or not the parameters require
gradients.  ``remat`` is ``"none"``, ``"full"`` or ``"dots"``
(``models/base.py::run_layer``).  The pipeline schedule is
``parallel/pipeline.py`` and the compressed cross-pod reduction
``optim/compress.py``; as in the reference, neither is part of this step.

**Cells** (the reference's ``build_cell`` and what it reads):
:func:`cell_applicable` and :func:`all_cells` decide the (architecture x
shape) cells as the reference does; :func:`input_specs` gives the data
inputs as ``meta`` tensors (the ``ShapeDtypeStruct`` stand-ins; a decode
cell's cache from the model's ``init_cache`` on ``meta``);
:func:`batch_shardings` their layouts as the port's spec tuples;
:func:`make_train_step`, :func:`make_prefill_step` and
:func:`make_serve_step` are closures over the three steps; and
:func:`build_cell` bundles one step with its arguments on the cell's
device and the layouts of its parameters, optimizer state, batch and
cache (:class:`Cell`).  :meth:`Cell.run` runs the step: on a dry mesh
(``comm.Mesh.dry``) with ``meta`` arguments that is the costing tools'
dry run (``launch/costing.py``), on a real mesh with real tensors a real
step.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch.profiler import record_function

from repro_torch import optim
from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.parallel import comm
from repro_torch.parallel.sharding import Rules, make_rules

__all__ = ["train_step", "prefill_step", "serve_step", "cell_rules",
           "Cell", "input_specs", "batch_shardings", "build_cell",
           "cell_applicable", "all_cells", "make_train_step",
           "make_prefill_step", "make_serve_step"]


def cell_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether the cell runs, and why not (the reference's rule: a pure
    full-attention architecture skips the 500k-token shape)."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("pure full-attention arch: 500k-token KV does not fit "
                       "any chip; skipped per DESIGN.md §6")
    return True, ""


def all_cells():
    """[(cfg, shape, applicable, why)] of every architecture x shape."""
    from repro_torch.configs import get_config, list_archs
    out = []
    for arch in list_archs():
        cfg = get_config(arch)
        for shape in SHAPES.values():
            ok, why = cell_applicable(cfg, shape)
            out.append((cfg, shape, ok, why))
    return out


def cell_rules(mesh, cfg: ModelConfig, shape: ShapeConfig,
               strategy: str = "baseline", **overrides) -> Rules:
    """The strategy's rules adapted to the cell's divisibility: a batch
    that does not divide the data-parallel axes is not sharded, and a
    decode cell then spreads the KV cache's sequence over every axis
    ("virtual mesh" over the whole edge); inference rematerialises
    nothing and banks no parameters (``fsdp`` is a training cell's, as
    the reference's ``build_cell`` applies it)."""
    rules = make_rules(mesh, strategy, **overrides)
    dp = rules.axis_size(rules.batch)
    if shape.global_batch % max(dp, 1) != 0:
        kv = tuple(a for a in ("data", "model") if rules.has_axis(a))
        rules = dataclasses.replace(rules, batch=None, zero1=None,
                                    kv_seq=kv if shape.kind == "decode"
                                    else rules.kv_seq)
    if shape.kind != "train":
        rules = dataclasses.replace(rules, remat="none", fsdp=False)
    return rules


def train_step(model, opt_cfg: optim.OptConfig, opt_state: Dict[str, Any],
               batch: Dict[str, torch.Tensor], remat: str = "none",
               rules: Optional[Rules] = None) -> Dict[str, torch.Tensor]:
    """One training step on ``batch`` (``tokens``, ``labels``, ``mask``;
    ``positions`` or ``frames`` where the family reads them): the model's
    ``loss``, its gradients, then ``optim.apply``, which updates the
    model's parameters and ``opt_state`` in place.  Nothing is written
    before the loss and every gradient exist, so a step that raises before
    then can be retried.  Returns {"loss", "ce"[, "moe_aux"], "grad_norm",
    "lr"} as 0-d tensors, as the reference's step does.  The three phases
    are profiler ranges (``train_step: loss``, ``: backward``,
    ``: optimizer``), free unless a profiler runs.

    On a mesh (``rules``, or the model's own; collective: every rank calls
    it in lockstep with the global batch) the loss is the global loss,
    the backward leaves each rank its share of its blocks' gradients, and
    the mesh ``apply`` reduces them into the optimizer's banks (ZeRO-1)
    and all-gathers the updated blocks; the collectives are counted under
    the phases ``loss``, ``backward`` and ``optimizer``
    (``comm.phase_stats``).  ``opt_state`` is the banked state of
    ``optim.init(params, rules=, specs=)``."""
    rules = rules if rules is not None else getattr(model, "rules", None)
    params = dict(model.named_parameters())
    for p in params.values():
        p.grad = None
    on_mesh = {} if rules is None else {
        "rules": rules, "specs": model.param_specs(model.cfg, rules)}
    # each stacked parameter's layers sliced from one unbind, held through
    # the backward, where a rematerialised layer slices them again
    # (models/base.py::TableModule.layer_views)
    with model.layer_views():
        with record_function("train_step: loss"), _phase(rules, "loss"):
            loss, metrics = model.loss(batch, remat=remat, **(
                {} if rules is None else {"rules": rules}))
        with record_function("train_step: backward"), \
                _phase(rules, "backward"):
            loss.backward()
    grads = {k: torch.zeros_like(p) if p.grad is None else p.grad
             for k, p in params.items()}
    with record_function("train_step: optimizer"), \
            _phase(rules, "optimizer"):
        _, _, om = optim.apply(opt_cfg, params, grads, opt_state, **on_mesh)
    for p in params.values():
        p.grad = None
    return {"loss": loss.detach(),
            **{k: v.detach() for k, v in metrics.items()}, **om}


def _phase(rules, name: str):
    return contextlib.nullcontext() if rules is None else \
        comm.counting_phase(name)


@torch.no_grad()
def prefill_step(model, batch: Dict[str, torch.Tensor],
                 rules: Optional[Rules] = None) -> torch.Tensor:
    """(B, V) next-token logits of ``batch["tokens"]`` (B, S) (optional
    ``batch["positions"]``, (B, S) or (3, B, S); ``batch["frames"]`` for
    the audio family); on a mesh under ``rules``."""
    kwargs = {}
    if model.cfg.family == "audio":
        kwargs["frames"] = batch["frames"]
    if rules is not None:
        kwargs["rules"] = rules
    logits, _aux = model(batch["tokens"], positions=batch.get("positions"),
                         last_only=True, **kwargs)
    return logits[:, 0]


@torch.no_grad()
def serve_step(model, cache: Dict[str, torch.Tensor], tokens: torch.Tensor,
               rules: Optional[Rules] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step, then the argmax of the logits: (next_tokens (B,)
    int32, cache); on a mesh under ``rules``."""
    kwargs = {} if rules is None else {"rules": rules}
    logits, cache = model.decode_step(cache, tokens, **kwargs)
    return logits.argmax(-1).to(torch.int32), cache


# ---------------------------------------------------------------------------
# cells: the inputs, their layouts, the step closures and the bundle
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """The cell's data inputs as ``meta`` tensors of their global shapes
    and dtypes (the reference's ``ShapeDtypeStruct`` stand-ins):
    {"batch": {...}} for training and prefill, {"cache", "tokens"} for
    decode (the cache from the model's ``init_cache`` on ``meta``)."""
    from repro_torch.models import get_model
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        batch = {"tokens": _meta((B, S), i32)}
        if shape.kind == "train":
            batch["labels"] = _meta((B, S), i32)
            batch["mask"] = _meta((B, S), torch.float32)
        if cfg.family == "audio":
            batch["frames"] = _meta((B, cfg.encdec.encoder_seq, cfg.d_model),
                                    torch.float32)
        if cfg.family == "vlm":
            batch["positions"] = _meta((3, B, S), i32)
        return {"batch": batch}
    cache = get_model(cfg)(cfg, "meta").init_cache(B, S)
    return {"cache": cache, "tokens": _meta((B,), i32)}


def batch_shardings(cfg: ModelConfig, shape: ShapeConfig, rules: Rules
                    ) -> Dict[str, Tuple]:
    """The layouts of the data inputs: each dimension's mesh axes (None:
    whole on every rank), the reference's ``batch_shardings`` as spec
    tuples.  (Every rank passes the global batch to the port's steps,
    which cut their own rows; the layout says which rows a rank reads.)"""
    b = rules._clean(rules.batch)
    out = {"tokens": (b, None)}
    if shape.kind == "train":
        out["labels"] = (b, None)
        out["mask"] = (b, None)
    if cfg.family == "audio":
        out["frames"] = (b, None, None)
    if cfg.family == "vlm":
        out["positions"] = (None, b, None)
    return out


def make_train_step(cfg: ModelConfig, rules: Optional[Rules],
                    opt_cfg: optim.OptConfig, remat: Optional[str] = None):
    """``step(model, opt_state, batch)``: :func:`train_step` under
    ``rules`` (None: one card) with ``rules.remat`` (or ``remat``)."""
    remat = remat or (rules.remat if rules is not None else "full")

    def step(model, opt_state, batch):
        return train_step(model, opt_cfg, opt_state, batch, remat, rules)

    return step


def make_prefill_step(cfg: ModelConfig, rules: Optional[Rules]):
    """``step(model, batch)``: :func:`prefill_step` under ``rules``."""
    def step(model, batch):
        return prefill_step(model, batch, rules)

    return step


def make_serve_step(cfg: ModelConfig, rules: Optional[Rules]):
    """``step(model, cache, tokens)``: :func:`serve_step` under
    ``rules``."""
    def step(model, cache, tokens):
        return serve_step(model, cache, tokens, rules)

    return step


@dataclasses.dataclass
class Cell:
    """One (architecture x shape) cell: the step ``fn`` and its ``args``
    on the cell's device (the model, which holds this rank's parameter
    blocks, then the optimizer state and the batch, the batch, or the
    cache and the tokens), with the layouts of its inputs in the order of
    the reference's ``in_shardings`` (``in_specs``: parameters, optimizer
    state and batch; parameters and batch; parameters, cache and tokens),
    each a dict of the port's spec tuples (the tokens' one tuple; ``None``
    for a cell on one card).  The reference's ``jitted()``, ``lower()``,
    ``out_shardings`` and ``donate_argnums`` have no counterpart: the
    port compiles nothing, its steps update the parameters, the
    optimizer state and the cache in place, and every rank returns the
    global result."""

    cfg: ModelConfig
    shape: ShapeConfig
    rules: Optional[Rules]
    fn: Any
    args: tuple
    in_specs: tuple

    @property
    def model(self):
        return self.args[0]

    def run(self):
        """Run the step once: the dry run on a dry mesh (``meta``
        arguments), a real step on a real mesh."""
        return self.fn(*self.args)


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
               strategy: str = "baseline",
               opt_cfg: Optional[optim.OptConfig] = None, *,
               params: Optional[Dict[str, torch.Tensor]] = None,
               inputs: Optional[Dict[str, Any]] = None, device=None,
               **rule_overrides) -> Cell:
    """The cell of ``cfg`` x ``shape`` on ``mesh`` (a dry mesh for the
    dry run, or a real one; None: one card on ``device``, where
    ``remat`` is the only override, "full" by default for training as
    the reference's rules) under ``cell_rules(mesh, ..., strategy)``.

    The model holds ``params`` (this rank's blocks, on the mesh's device)
    or, without, uninitialised tensors (on ``meta``: nothing).  The
    inputs are ``inputs`` ({"batch"}, or {"tokens"[, "cache"]}: global
    batches, this rank's cache block; a real step needs them) or, where
    absent, :func:`input_specs`' ``meta`` stand-ins (a decode cache from
    the sharded model's ``init_cache``).  A training cell's model
    requires gradients and its optimizer state is ``optim.init`` of its
    blocks; under FSDP the parameters, and so the state, are banked over
    ``zero1`` (the model's ``param_specs``), as the reference's
    ``build_cell`` banks them."""
    from repro_torch.models import get_model
    if mesh is None:
        remat = rule_overrides.pop("remat", "full" if shape.kind == "train"
                                   else "none")
        if rule_overrides:
            raise ValueError(f"a cell on one card takes no rules but remat; "
                             f"got {sorted(rule_overrides)}")
        rules = None
    else:
        rules = cell_rules(mesh, cfg, shape, strategy, **rule_overrides)
        device = mesh.device
        remat = rules.remat
    cls = get_model(cfg)
    model = cls(cfg, device, params=params, rules=rules)
    p_specs = None if rules is None else model.param_specs(cfg, rules)
    inputs = dict(inputs or {})
    if shape.kind in ("train", "prefill"):
        batch = inputs.get("batch") or input_specs(cfg, shape)["batch"]
        b_specs = None if rules is None else batch_shardings(cfg, shape,
                                                             rules)
        if shape.kind == "prefill":
            return Cell(cfg, shape, rules, make_prefill_step(cfg, rules),
                        (model, batch), (p_specs, b_specs))
        opt_cfg = opt_cfg or optim.OptConfig()
        model.requires_grad_(True)
        held = dict(model.named_parameters())
        if rules is None:
            state, s_specs = optim.init(held), None
        else:
            state = optim.init(held, rules=rules, specs=p_specs)
            s_specs = optim.state_specs(p_specs, cls.param_table(cfg), rules)
        return Cell(cfg, shape, rules,
                    make_train_step(cfg, rules, opt_cfg, remat),
                    (model, state, batch), (p_specs, s_specs, b_specs))
    cache = inputs.get("cache")
    if cache is None:
        cache = model.init_cache(shape.global_batch, shape.seq_len)
    tokens = inputs.get("tokens")
    if tokens is None:
        tokens = _meta((shape.global_batch,), torch.int32)
    c_specs = tok_spec = None
    if rules is not None:
        c_specs = cls.cache_specs(cfg, rules)
        tok_spec = (rules._clean(rules.batch),)
    return Cell(cfg, shape, rules, make_serve_step(cfg, rules),
                (model, cache, tokens), (p_specs, c_specs, tok_spec))
