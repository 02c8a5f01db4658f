"""xlstm-125m — alternating sLSTM + mLSTM blocks.

[arXiv:2405.04517; unverified] 12L d_model=768 4H vocab=50304, d_ff=0
(xLSTM blocks carry their own up/down projections).
"""
from repro_torch.configs.base import ArchConfig, MLSTM, SLSTM, register

CONFIG = register(ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    block_pattern=(MLSTM, SLSTM),
    rnn_width=1536,                 # 2x up-projection inside blocks
    gated_mlp=False,
    act="gelu",
    norm="layernorm",
    tie_embeddings=True,
    subquadratic=True,
    source="[arXiv:2405.04517; unverified]",
))
