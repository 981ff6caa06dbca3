"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001.

Verbatim copy of ``repro/configs/hymba_1_5b.py:1``.
[arXiv:2411.13676] parallel attention + mamba heads inside each block,
ssm_state=16; most attention layers use sliding windows (native long_500k).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab=32001,
    ssm_state=16,
    window=1024,
    serve_window=1024,
    source="arXiv:2411.13676",
)
