"""whisper-large-v3 [audio] — encoder-decoder; the conv/audio frontend is a
STUB: input_specs() provides precomputed 1500-frame embeddings
[arXiv:2212.04356; unverified]."""
from .base import EncDecConfig, ModelConfig, register

WHISPER_LARGE_V3 = register(ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,                       # decoder layers
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    encdec=EncDecConfig(encoder_layers=32, encoder_seq=1500),
    rope_theta=1e4,                      # (whisper uses learned pos; rope as stand-in)
    source="arXiv:2212.04356; unverified",
))
