"""llama4-maverick-400b-a17b — MoE top-1 + shared expert, chunked attention.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified] 48L d_model=5120 40H
(GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1, early fusion.
iRoPE-style chunked attention (8192 window) on 3 of 4 layers makes
long-context decode sub-quadratic in practice.
"""
from repro_torch.configs.base import ArchConfig, ATTN, LOCAL_ATTN, MoEConfig, register

CONFIG = register(ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,                      # shared-path FFN width
    vocab_size=202_048,
    gated_mlp=True,
    act="silu",
    rope_theta=500_000.0,
    local_window=8192,
    block_pattern=(LOCAL_ATTN, LOCAL_ATTN, LOCAL_ATTN, ATTN),
    moe=MoEConfig(
        num_experts=128,
        top_k=1,
        d_ff_expert=8192,
        num_shared_experts=1,
        d_ff_shared=8192,
        first_moe_layer=1,
        moe_every=2,                # llama4 interleaved MoE (every other layer)
    ),
    subquadratic=True,              # NoPE global layers skipped at 500k via window
    source="[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]",
))
