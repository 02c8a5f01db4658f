"""phi-3-vision-4.2b — phi3-mini backbone + CLIP frontend (stub).

[hf:microsoft/Phi-3-vision-128k-instruct; hf] 32L d_model=3072 32H
(GQA kv=32) d_ff=8192 vocab=32064.  Vision frontend is a STUB per the
assignment: ``input_specs()`` provides precomputed patch embeddings
(num_patch_tokens per image) that are prepended to the text sequence.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32_064,
    gated_mlp=True,
    act="silu",
    num_patch_tokens=576,          # CLIP ViT-L/14 @336px → 24×24 patches
    subquadratic=False,
    source="[hf:microsoft/Phi-3-vision-128k-instruct; hf]",
))
