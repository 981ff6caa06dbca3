"""pixtral-12b [vlm]: 40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072.

Verbatim copy of ``repro/configs/pixtral_12b.py:1``.

[hf:mistralai/Pixtral-12B-2409] pixtral-ViT vision encoder + mistral-nemo
decoder. The ViT + projector is a STUB: input_specs() provides precomputed
patch embeddings (1024 patches = one 1024px image at patch 32) early-fused
into the first P sequence positions.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=160,
    d_ff=14336,
    vocab=131072,
    frontend="vision",
    n_frontend_tokens=1024,
    d_frontend=1024,
    serve_window=8192,
    source="hf:mistralai/Pixtral-12B-2409",
)
