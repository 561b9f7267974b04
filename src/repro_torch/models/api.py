"""Model API: the model class of a config's family (the port's counterpart
of ``repro.models.api``).  The port has ported the hybrid family so far;
the others raise, naming the ROADMAP item that ports them."""
from __future__ import annotations

from torch import nn

from repro_torch.configs.base import ModelConfig

__all__ = ["get_model"]

_NOT_YET = {
    "dense": "ROADMAP A-6a (the dense and MoE transformer)",
    "moe": "ROADMAP A-6a (the dense and MoE transformer)",
    "ssm": "ROADMAP A-6b (the Mamba-2 LM)",
    "audio": "ROADMAP A-6c (Whisper)",
    "vlm": "ROADMAP A-6d (Qwen2-VL's M-RoPE)",
}


def get_model(cfg: ModelConfig) -> type[nn.Module]:
    """The ``nn.Module`` class implementing ``cfg``'s family; build it as
    ``get_model(cfg)(cfg, device=...)``."""
    if cfg.family == "hybrid":
        from .jamba import Jamba
        return Jamba
    if cfg.family in _NOT_YET:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet; see "
            f"{_NOT_YET[cfg.family]}")
    raise KeyError(f"unknown model family {cfg.family!r}")
