"""Architecture + shape configuration system (the port's copy of
``repro.configs.base``, data only).

Every assigned architecture is a :class:`ModelConfig`; every workload cell is
a (:class:`ModelConfig`, :class:`ShapeConfig`) pair.  ``REGISTRY`` maps
``--arch`` ids to configs; ``SHAPES`` holds the four assigned input shapes.
The fields equal the reference's field for field; only
:attr:`ModelConfig.param_dtype` differs, returning a ``torch.dtype``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

__all__ = ["MoEConfig", "SSMConfig", "EncDecConfig", "ModelConfig",
           "ShapeConfig", "SHAPES", "REGISTRY", "register", "get_config",
           "list_archs", "reduced_config"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    every_n_layers: int = 1        # 1 = every layer is MoE (mixtral/moonshot)
    capacity_factor: float = 1.25  # FIFO provisioning rule (paper C2/C6)
    router_jitter: float = 0.0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128           # N
    head_dim: int = 64             # P
    expand: int = 2                # d_inner = expand * d_model
    num_groups: int = 1            # G (B/C groups)
    conv_width: int = 4
    chunk: int = 256               # SSD chunk length Q

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    encoder_layers: int
    encoder_seq: int = 1500        # whisper: 30 s of audio -> 1500 frames


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int                 # query heads (0 for attention-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    qkv_bias: bool = False
    norm_eps: float = 1e-6
    rope_theta: float = 1e6
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl M-RoPE
    sliding_window: Optional[int] = None                   # mixtral SWA
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_period: Optional[int] = None  # jamba: one attn layer per this many
    encdec: Optional[EncDecConfig] = None
    dtype: str = "bfloat16"
    source: str = ""               # citation tag from the assignment

    # ------------------------------------------------------------------
    @property
    def param_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """May run the 500k-token long-context shape (DESIGN.md §6)."""
        return (self.family in ("ssm", "hybrid")
                or self.sliding_window is not None)

    def param_count(self) -> int:
        """Total parameters (used for MODEL_FLOPS = 6*N*D)."""
        return _param_count(self, active_only=False)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k experts only)."""
        return _param_count(self, active_only=True)


def _param_count(cfg: ModelConfig, active_only: bool) -> int:
    D, hd = cfg.d_model, cfg.head_dim
    H, K = cfg.num_heads, cfg.num_kv_heads
    total = cfg.vocab_size * D * (1 if cfg.tie_embeddings else 2)

    def attn_params() -> int:
        p = D * H * hd + 2 * D * K * hd + H * hd * D
        if cfg.qkv_bias:
            p += H * hd + 2 * K * hd
        return p

    def dense_mlp(ff: int) -> int:
        return 3 * D * ff  # SwiGLU: gate, up, down

    def moe_mlp() -> int:
        m = cfg.moe
        experts = m.top_k if active_only else m.num_experts
        return D * m.num_experts + experts * 3 * D * m.d_ff_expert

    def ssm_params() -> int:
        s = cfg.ssm
        di = s.d_inner(D)
        nh = s.num_heads(D)
        # in_proj (x, z, B, C, dt) + conv + out_proj + A/D/dt_bias
        inp = D * (2 * di + 2 * s.num_groups * s.state_dim + nh)
        conv = s.conv_width * (di + 2 * s.num_groups * s.state_dim)
        return inp + conv + di * D + 3 * nh

    per_layer = []
    for layer in range(cfg.num_layers):
        is_attn = True
        if cfg.family == "ssm":
            is_attn = False
        elif cfg.family == "hybrid":
            is_attn = (layer % cfg.attn_period) == (cfg.attn_period - 1)
        mixer = attn_params() if is_attn else ssm_params()
        if cfg.moe is not None and (layer % cfg.moe.every_n_layers
                                    == cfg.moe.every_n_layers - 1):
            mlp = moe_mlp()
        elif cfg.d_ff > 0:
            mlp = dense_mlp(cfg.d_ff)
        else:
            mlp = 0
        per_layer.append(mixer + mlp + 2 * D)
    total += sum(per_layer) + D
    if cfg.encdec is not None:
        # encoder self-attn + mlp, and decoder cross-attention blocks
        enc = cfg.encdec.encoder_layers * (attn_params() + dense_mlp(cfg.d_ff) + 2 * D)
        cross = cfg.num_layers * (attn_params() + D)
        total += enc + cross
    return total


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode
    def __post_init__(self):
        assert self.kind in ("train", "prefill", "decode")


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    from . import _load_all  # lazy: populate the registry
    _load_all()
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]


def list_archs() -> Sequence[str]:
    from . import _load_all
    _load_all()
    return sorted(REGISTRY)


def reduced_config(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    small = dict(
        num_layers=min(cfg.num_layers, 4 if cfg.family == "hybrid" else 2),
        d_model=128,
        num_heads=4 if cfg.num_heads else 0,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads else 0,
        head_dim=32,
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        dtype="float32",
    )
    if cfg.mrope_sections is not None:
        # keep the 2:3:3 t/h/w split but sum to the reduced head_dim/2
        half = small["head_dim"] // 2
        s1 = half // 4
        small["mrope_sections"] = (s1, (half - s1) // 2,
                                   half - s1 - (half - s1) // 2)
    if cfg.moe is not None:
        small["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=min(cfg.moe.top_k, 2), d_ff_expert=64)
    if cfg.ssm is not None:
        small["ssm"] = dataclasses.replace(
            cfg.ssm, state_dim=16, head_dim=16, chunk=16)
    if cfg.attn_period is not None:
        small["attn_period"] = 2
    if cfg.encdec is not None:
        small["encdec"] = EncDecConfig(encoder_layers=2, encoder_seq=16)
    if cfg.sliding_window is not None:
        small["sliding_window"] = 16
    small.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **small)
