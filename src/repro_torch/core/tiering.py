"""Tier -> split-point mapping for the transformer (pair: ``repro/core/tiering.py:1``).

Verbatim copy, except that ``split_params`` and ``merge_params`` take the
layer axis of the stacked blocks: 0 for one model, 1 behind the port's
client axis.

The paper divides the global model into 8 "modules" (md1..md8); tier m's
client-side model is modules md1..md_m (Table 10/11). For the transformer
port, modules are 8 ~equal groups of blocks; md8 (the paper's avgpool+fc)
is the final norm + LM head, which always stays server-side, so tiers run
1..7 (M <= n_modules - 1).

This module owns the *policy* (tier -> block boundary); the split/merge
*mechanics* live in :mod:`repro_torch.core.splitting` (shared with the
ResNet). Because block parameters are stacked on a layer axis, a tier split
is a slice; merge is a concatenate. Split/merge is lossless (tested), which
is what makes cross-tier FedAvg aggregation exact.
"""
from __future__ import annotations

from repro_torch.core import splitting

Params = dict


def module_boundaries(n_layers: int, n_modules: int = 8) -> list[int]:
    """Cumulative block counts for md1..md_{n_modules-1}.

    boundary[m] = number of blocks in modules md1..md_{m+1}; the final module
    (head) contains no blocks. Every boundary is >= 1 so each tier's client
    model is non-empty, and <= n_layers - 1 so the server always keeps work.
    """
    n_split = n_modules - 1  # modules that contain blocks
    bounds = []
    for m in range(1, n_split + 1):
        b = round(n_layers * m / n_split)
        b = max(1, min(b, n_layers - 1)) if n_layers > 1 else 1
        bounds.append(b)
    return bounds


def n_tiers(cfg) -> int:
    return cfg.n_modules - 1


def split_layer(cfg, tier: int) -> int:
    """Client-side block count for ``tier`` (1-based, 1..n_tiers)."""
    bounds = module_boundaries(cfg.n_layers, cfg.n_modules)
    if not 1 <= tier <= len(bounds):
        raise ValueError(f"tier {tier} out of range 1..{len(bounds)}")
    return bounds[tier - 1]


def split_params(params: Params, cfg, tier: int, axis: int = 0) -> tuple[Params, Params]:
    """Split the full parameter tree at ``tier``. Returns (client, server)."""
    return splitting.split_params(params, split_layer(cfg, tier),
                                  splitting.TRANSFORMER, axis)


def merge_params(client: Params, server: Params, axis: int = 0) -> Params:
    return splitting.merge_params(client, server, splitting.TRANSFORMER, axis)
