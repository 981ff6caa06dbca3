"""granite-3-2b [dense]: 40L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=49155.

Copy of ``repro/configs/granite_3_2b.py``, field for field.

[hf:ibm-granite/granite-3.0-2b-base]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-2b",
    family="dense",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab=49155,
    serve_window=8192,
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-2b-base",
)
