"""mamba2-370m [ssm] — SSD (state-space duality), attention-free
[arXiv:2405.21060; unverified]."""
from .base import ModelConfig, SSMConfig, register

MAMBA2_370M = register(ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, num_groups=1,
                  conv_width=4, chunk=256),
    source="arXiv:2405.21060; unverified",
))
