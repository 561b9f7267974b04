"""qwen2-vl-72b [vlm] — qwen2-72b backbone with M-RoPE; the vision frontend
is a STUB (input_specs() provides patch embeddings + 3D position ids)
[arXiv:2409.12191; hf]."""
from .base import ModelConfig, register

QWEN2_VL_72B = register(ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    mrope_sections=(16, 24, 24),         # t/h/w sections of head_dim/2
    rope_theta=1e6,
    source="arXiv:2409.12191; hf",
))
