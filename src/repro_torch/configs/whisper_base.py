"""whisper-base [audio]: enc-dec transformer backbone, conv/mel frontend stubbed.

Verbatim copy of ``repro/configs/whisper_base.py:1``.

[arXiv:2212.04356] Whisper base: 6 encoder + 6 decoder layers, d_model=512,
8 heads (MHA -> kv=8), d_ff=2048, vocab=51865. The assignment lists "6L";
we interpret it as the decoder depth with a matching 6-layer encoder
(the canonical whisper-base layout). The mel-spectrogram + conv feature
extractor is a STUB: input_specs() provides precomputed frame embeddings
(1500 frames at d_model, the 30s window after 2x conv stride).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,
    n_enc_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51865,
    frontend="audio",
    n_frontend_tokens=1500,
    d_frontend=512,
    serve_window=8192,
    source="arXiv:2212.04356",
)
