"""llama3.2-3b — small llama3 dense GQA.

[hf:meta-llama/Llama-3.2-1B; unverified] 28L d_model=3072 24H (GQA kv=8)
d_ff=8192 vocab=128256.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=128_256,
    gated_mlp=True,
    act="silu",
    rope_theta=500_000.0,
    tie_embeddings=True,
    subquadratic=False,
    source="[hf:meta-llama/Llama-3.2-1B; unverified]",
))
