"""yi-6b [dense]: 32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.

Copy of ``repro/configs/yi_6b.py``, field for field.

[arXiv:2403.04652] llama-arch GQA.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="yi-6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab=64000,
    serve_window=8192,
    source="arXiv:2403.04652",
)
