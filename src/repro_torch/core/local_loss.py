"""Local-loss cross-entropy (pair: ``repro/core/local_loss.py:27``, ``token_xent``).

The per-token term runs on kernel K3 (``kernels/fused_xent.py``): the
hand-written CUDA kernels for a CUDA tensor, their plain version for a CPU
tensor. The weighted mean over the pad ``mask`` stays in torch ops on the
(C, ...) per-token losses.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fused_xent import fused_xent


def token_xent(logits: torch.Tensor, labels: torch.Tensor,
               weight: torch.Tensor | None = None) -> torch.Tensor:
    """Per-client mean cross-entropy; logits fp32 or bf16, stats in fp32.

    ``logits`` (C, ..., V), ``labels`` (C, ...): the leading client axis is
    kept, everything else is reduced, so the result is (C,) — the JAX
    function's scalar for each client. ``weight`` (leading-axes
    broadcastable, e.g. a per-sample (C, B) pad mask from
    ``data/pipeline.py``) turns the mean into a weighted mean so padded
    samples contribute nothing."""
    V = logits.shape[-1]
    per = fused_xent(logits.reshape(-1, V).contiguous(), labels.reshape(-1))
    per = per.reshape(labels.shape)
    dims = tuple(range(1, per.ndim))
    if weight is None:
        return per.mean(dim=dims)
    w = weight.float()
    w = w.reshape(w.shape + (1,) * (per.ndim - w.ndim)).expand(per.shape)
    return (per * w).sum(dim=dims) / torch.clamp_min(w.sum(dim=dims), 1.0)
