"""deepseek-v3-671b — MLA + MoE (1 shared + 256 routed, top-8).

[arXiv:2412.19437; hf] 61L d_model=7168 128H (kv=128 via MLA latent)
d_ff_expert=2048 vocab=129280.  First 3 layers dense (d_ff=18432),
remaining 58 MoE.  MTP head noted; primary step is next-token.
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=18432,                     # dense layers' FFN width
    vocab_size=129_280,
    gated_mlp=True,
    act="silu",
    rope_theta=10_000.0,
    moe=MoEConfig(
        num_experts=256,
        top_k=8,
        d_ff_expert=2048,
        num_shared_experts=1,
        d_ff_shared=2048,
        first_moe_layer=3,
    ),
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    subquadratic=False,
    source="[arXiv:2412.19437; hf]",
))
