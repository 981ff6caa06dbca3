"""Local-loss cross-entropy (pair: ``repro/core/local_loss.py:27``, ``token_xent``).

Only the weighted mean with the pad ``mask`` is ported here; the rest of
that module belongs to the transformer path.
"""
from __future__ import annotations

import torch


def token_xent(logits: torch.Tensor, labels: torch.Tensor,
               weight: torch.Tensor | None = None) -> torch.Tensor:
    """Per-client mean cross-entropy; logits any float dtype, stats in fp32.

    ``logits`` (C, ..., V), ``labels`` (C, ...): the leading client axis is
    kept, everything else is reduced, so the result is (C,) — the JAX
    function's scalar for each client. ``weight`` (leading-axes
    broadcastable, e.g. a per-sample (C, B) pad mask from
    ``data/pipeline.py``) turns the mean into a weighted mean so padded
    samples contribute nothing."""
    x = logits.float()
    lse = torch.logsumexp(x, dim=-1)
    picked = torch.gather(x, -1, labels.long()[..., None])[..., 0]
    per = lse - picked
    dims = tuple(range(1, per.ndim))
    if weight is None:
        return per.mean(dim=dims)
    w = weight.float()
    w = w.reshape(w.shape + (1,) * (per.ndim - w.ndim)).expand(per.shape)
    return (per * w).sum(dim=dims) / torch.clamp_min(w.sum(dim=dims), 1.0)
