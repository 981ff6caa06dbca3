"""smollm-360m [dense]: 32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152.

Verbatim copy of ``repro/configs/smollm_360m.py:1``.
[hf:HuggingFaceTB/SmolLM-135M family, 360M member] llama-arch small.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab=49152,
    serve_window=8192,
    tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-360M",
)
