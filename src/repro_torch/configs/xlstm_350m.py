"""xlstm-350m [ssm]: 24L d_model=1024 4H (GQA kv=4) d_ff=0 vocab=50304.

Verbatim copy of ``repro/configs/xlstm_350m.py:1``.
[arXiv:2405.04517] sLSTM + mLSTM blocks. d_ff=0 per assignment: blocks are
pre-up-projected mLSTM cells (proj factor 2) without a separate FFN, as in
the xLSTM[7:1] configuration; every 8th block is an sLSTM block.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    ssm_state=256,     # head_dim of the matrix memory (d_model / n_heads)
    slstm_every=8,
    source="arXiv:2405.04517",
)
