"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887; hf].  One attention layer per 8; MoE on every second
layer (e=16, k=2); the rest dense SwiGLU MLPs."""
from .base import ModelConfig, MoEConfig, SSMConfig, register

JAMBA_52B = register(ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    attn_period=8,                       # 1 attn : 7 mamba
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=14336,
                  every_n_layers=2),
    ssm=SSMConfig(state_dim=16, head_dim=64, expand=2, num_groups=1,
                  conv_width=4, chunk=256),
    rope_theta=1e4,
    source="arXiv:2403.19887; hf",
))
