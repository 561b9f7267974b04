"""Model API: the model class of a config's family (the port's counterpart
of ``repro.models.api``).  Every family of the JAX package is ported: the
hybrid, the dense/MoE/VLM transformer, the SSM and the encoder-decoder
``audio`` family (Whisper)."""
from __future__ import annotations

from torch import nn

from repro_torch.configs.base import ModelConfig

__all__ = ["get_model"]


def get_model(cfg: ModelConfig) -> type[nn.Module]:
    """The ``nn.Module`` class implementing ``cfg``'s family; build it as
    ``get_model(cfg)(cfg, device=...)``.  Each class also carries its
    family's ``param_table``, ``param_dtype`` and ``init_rule``."""
    if cfg.family == "hybrid":
        from .jamba import Jamba
        return Jamba
    if cfg.family in ("dense", "moe", "vlm"):
        from .transformer import Transformer
        return Transformer
    if cfg.family == "ssm":
        from .mamba2 import Mamba2LM
        return Mamba2LM
    if cfg.family == "audio":
        from .whisper import Whisper
        return Whisper
    raise KeyError(f"unknown model family {cfg.family!r}")
