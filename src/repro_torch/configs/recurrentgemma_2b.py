"""recurrentgemma-2b — RG-LRU + local attention hybrid, 1:2 pattern.

[arXiv:2402.19427; hf] 26L d_model=2560 10H (GQA kv=1) d_ff=7680
vocab=256000.  Pattern: two RG-LRU (recurrent) blocks then one local
sliding-window attention block (window 2048), per the Griffin paper.
"""
from repro_torch.configs.base import ArchConfig, LOCAL_ATTN, RGLRU, register

CONFIG = register(ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    local_window=2048,
    block_pattern=(RGLRU, RGLRU, LOCAL_ATTN),
    rnn_width=2560,
    conv1d_width=4,
    gated_mlp=True,
    act="gelu",
    tie_embeddings=True,
    subquadratic=True,
    source="[arXiv:2402.19427; hf]",
))
