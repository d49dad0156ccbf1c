"""xLSTM-125M: sLSTM + mLSTM blocks (7:1-style mix at small scale).
d_ff = 0 — projections live inside the xLSTM blocks. [arXiv:2405.04517]
"""
from repro_torch.models.config import MLSTM, SLSTM, ModelConfig

# 12 layers, sLSTM at positions 3 and 9 (paper places a few sLSTM blocks
# among mLSTM blocks)
_PATTERN = "".join(SLSTM if i in (3, 9) else MLSTM for i in range(12))

CONFIG = ModelConfig(
    name="xlstm-125m",
    arch_type="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab_size=50304,
    layer_pattern=_PATTERN,
    xlstm_proj_factor=2.0,
    source="arXiv:2405.04517",
)
