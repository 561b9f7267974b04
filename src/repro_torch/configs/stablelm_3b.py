"""stablelm-3b [dense] — MHA [hf:stabilityai/stablelm-2-1_6b; unverified]."""
from .base import ModelConfig, register

STABLELM_3B = register(ModelConfig(
    name="stablelm-3b",
    family="dense",
    num_layers=32,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=6912,
    vocab_size=50304,
    qkv_bias=False,
    rope_theta=1e4,
    source="hf:stabilityai/stablelm-2-1_6b; unverified",
))
