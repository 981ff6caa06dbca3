"""ResNet adapter for DTFL (pair: ``repro/fed/adapter.py:49``, ``ResNetAdapter``).

Provides global init, tier split/merge, the two DTFL local-loss objectives,
eval, and the per-tier cost table used by the time simulator and the
scheduler's profiling. Losses and activations carry the leading client
axis: ``client_loss`` returns a (C,) loss per client. The dcor regularizer
and patch shuffling come in a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.core import splitting, timemodel
from repro_torch.core.local_loss import token_xent
from repro_torch.models import resnet as R
from repro_torch.tree import tree_map

Params = Any


class DTFLStepState(NamedTuple):
    client: Params
    aux: Params
    server: Params
    c_opt: Any
    a_opt: Any
    s_opt: Any


class ResNetAdapter:
    def __init__(self, cfg, *, cost_cfg=None, dcor_alpha: float = 0.0,
                 patch_shuffle: bool = False):
        if dcor_alpha > 0.0:
            raise NotImplementedError("dcor_alpha > 0 is not yet ported")
        if patch_shuffle:
            raise NotImplementedError("patch_shuffle is not yet ported")
        self.cfg = cfg
        # time model may price the full-size model; tier count must match
        cost_cfg = cost_cfg or cfg
        if cost_cfg.n_modules != cfg.n_modules:
            cost_cfg = dataclasses.replace(cost_cfg, n_modules=cfg.n_modules)
        self.cost_cfg = cost_cfg
        self.n_tiers = cfg.n_modules - 1

    def init_global(self, gen: torch.Generator) -> Params:
        return R.init(gen, self.cfg)

    def split(self, params: Params, tier: int):
        # tier is 0-based here; paper tier m keeps modules md1..md{m+1}
        nb = R.n_blocks_in_modules(self.cfg, tier + 1)
        return splitting.split_params(params, nb, splitting.RESNET)

    def merge(self, client: Params, server: Params) -> Params:
        return splitting.merge_params(client, server, splitting.RESNET)

    def aux_init(self, gen: torch.Generator, tier: int) -> Params:
        return R.aux_init(gen, self.cfg, tier + 1)

    # ---- losses (leading client axis) ----
    def client_loss(self, cp: Params, ap: Params, batch: dict):
        z = R.client_forward(cp, self.cfg, batch["images"])
        logits = R.aux_apply(ap, z)
        return token_xent(logits, batch["labels"], batch.get("mask")), z

    def server_loss(self, sp: Params, z: torch.Tensor, batch: dict, tier: int):
        logits = R.server_forward(sp, self.cfg, z, tier + 1)
        return token_xent(logits, batch["labels"], batch.get("mask"))

    def eval_acc(self, params: Params, batch: dict) -> torch.Tensor:
        """Accuracy of one model (no client axis) on one batch."""
        one = tree_map(lambda t: t[None], params)
        logits = R.forward(one, self.cfg, batch["images"][None])[0]
        return (logits.argmax(-1) == batch["labels"]).float().mean()

    def tier_costs(self, batch_size: int) -> timemodel.TierCostTable:
        return timemodel.resnet_tier_costs(self.cost_cfg, batch_size)
