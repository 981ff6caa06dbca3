"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8) d_ff=8192

Copy of ``repro/configs/llama4_scout_17b_a16e.py``, field for field.
vocab=202048, MoE 16 experts top-1 + 1 shared, early fusion.

[hf:meta-llama/Llama-4-Scout-17B-16E]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=202048,
    n_experts=16,
    n_shared_experts=1,
    top_k=1,
    d_ff_shared=8192,
    serve_window=8192,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
