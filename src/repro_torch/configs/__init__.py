"""Assigned architecture configs (one module per ``--arch`` id)."""
import importlib

from .base import (REGISTRY, SHAPES, EncDecConfig, ModelConfig, MoEConfig,
                   ShapeConfig, SSMConfig, get_config, list_archs,
                   reduced_config, register)

_MODULES = [
    "qwen2_72b", "yi_34b", "qwen15_32b", "stablelm_3b", "jamba_v01_52b",
    "moonshot_v1_16b_a3b", "mixtral_8x7b", "whisper_large_v3", "mamba2_370m",
    "qwen2_vl_72b",
]

_loaded = False


def _load_all() -> None:
    global _loaded
    if _loaded:
        return
    _loaded = True
    for m in _MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
