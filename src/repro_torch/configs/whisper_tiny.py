"""whisper-tiny — encoder-decoder, conv audio frontend (STUB).

[arXiv:2212.04356; unverified] 4L d_model=384 6H d_ff=1536 vocab=51865.
Frontend is a stub per the assignment: ``input_specs()`` provides
precomputed mel-frame embeddings of shape (batch, frames, d_model).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,                     # decoder layers
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51_865,
    gated_mlp=False,
    act="gelu",
    norm="layernorm",
    mlp_bias=True,
    qkv_bias=True,
    is_encoder_decoder=True,
    n_encoder_layers=4,
    encoder_seq_len=1500,           # 30 s @ 50 Hz after conv stride-2
    tie_embeddings=True,
    subquadratic=False,
    source="[arXiv:2212.04356; unverified]",
))
