"""moonshot-v1-16b-a3b [moe] — kimi/moonlight, 64 experts top-6
[hf:moonshotai/Moonlight-16B-A3B; hf].  Every layer is MoE; the assigned
d_ff=1408 is the per-expert FFN width."""
from .base import ModelConfig, MoEConfig, register

MOONSHOT_16B = register(ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=0,                              # no dense MLP; MoE every layer
    vocab_size=163840,
    moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408,
                  every_n_layers=1),
    rope_theta=5e4,
    source="hf:moonshotai/Moonlight-16B-A3B; hf",
))
