"""MusicGen-large: decoder-only transformer over EnCodec tokens.

The EnCodec conv codec is a stub frontend — ``input_specs`` supplies
precomputed conditioning-frame embeddings; the decoder generates audio
tokens from vocab 2048. [arXiv:2306.05284]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    arch_type="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,       # MHA
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    frontend="audio",
    frontend_tokens=256,   # text/melody conditioning frames
    rope_theta=10_000.0,
    source="arXiv:2306.05284",
)
