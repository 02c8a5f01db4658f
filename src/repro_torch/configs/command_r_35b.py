"""command-r-35b — dense GQA, no-bias, layernorm.

[hf:CohereForAI/c4ai-command-r-v01; unverified] 40L d_model=8192 64H
(GQA kv=8) d_ff=22528 vocab=256000.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab_size=256_000,
    gated_mlp=True,
    act="silu",
    norm="layernorm",
    tie_embeddings=True,
    rope_theta=8_000_000.0,
    subquadratic=False,
    source="[hf:CohereForAI/c4ai-command-r-v01; unverified]",
))
