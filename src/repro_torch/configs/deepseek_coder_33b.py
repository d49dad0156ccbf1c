"""DeepSeek-Coder-33B: llama-arch dense GQA. [arXiv:2401.14196]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    arch_type="dense",
    num_layers=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=19200,
    vocab_size=32256,
    rope_theta=100_000.0,
    source="arXiv:2401.14196",
)
