"""deepseek-moe-16b [moe]: 28L d_model=2048 16H d_ff=1408 vocab=102400.

Copy of ``repro/configs/deepseek_moe_16b.py``, field for field.

[arXiv:2401.06066] fine-grained MoE: 2 shared + 64 routed experts, top-6,
expert d_ff=1408. kv=16 (MHA). Deviation noted in DESIGN.md: the real
model's first dense block is folded into the uniform MoE stack for scan
homogeneity.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=102400,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    d_ff_shared=2816,
    serve_window=8192,
    source="arXiv:2401.06066",
)
