"""Model adapters for DTFL (pair: ``repro/fed/adapter.py:49``,
``ResNetAdapter``, and ``:128``, ``TransformerAdapter``).

Each provides global init, tier split/merge, the two DTFL local-loss
objectives, the full-model objective of the baselines (``full_loss``),
FedGKT's hooks (``client_features``, ``aux_logits``, ``server_logits``),
eval, and the per-tier cost table used by the time simulator and the
scheduler's profiling. ``split`` takes one model (the global tree);
``merge`` takes a cohort's halves, whose leaves carry the leading client
axis, as do the losses and activations: ``client_loss`` and ``full_loss``
return a (C,) loss per client. ``dcor_alpha > 0`` adds the §4.4
distance-correlation regularizer (``privacy.dcor``, on kernel K2) to the
client loss of either adapter; for the ResNet,
``patch_shuffle`` shuffles the uploaded ``z`` only when a generator is
passed, which the DTFL step does not do, as in the JAX package
(``repro/fed/dtfl.py:133``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch import privacy
from repro_torch.core import splitting, tiering, timemodel
from repro_torch.core.local_loss import MOE_AUX_WEIGHT, token_xent
from repro_torch.models import model as M
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
        self.cfg = cfg
        # time model may price the full-size model; tier count must match
        cost_cfg = cost_cfg or cfg
        if cost_cfg.n_modules != cfg.n_modules:
            cost_cfg = dataclasses.replace(cost_cfg, n_modules=cfg.n_modules)
        self.cost_cfg = cost_cfg
        self.n_tiers = cfg.n_modules - 1
        self.dcor_alpha = dcor_alpha
        self.patch_shuffle = patch_shuffle

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
    def client_loss(self, cp: Params, ap: Params, batch: dict,
                    rng: torch.Generator | None = None):
        z = R.client_forward(cp, self.cfg, batch["images"])
        if self.patch_shuffle and rng is not None:
            zs = z.reshape(z.shape[0], z.shape[1], -1, z.shape[-1])
            z_up = privacy.patch_shuffle(rng, zs, 16).reshape(z.shape)
        else:
            z_up = z
        logits = R.aux_apply(ap, z)
        loss = token_xent(logits, batch["labels"], batch.get("mask"))
        if self.dcor_alpha > 0.0:
            # dcor sees the un-shuffled z and the padded rows too, as in
            # repro/fed/adapter.py:89-96
            loss = (1 - self.dcor_alpha) * loss + self.dcor_alpha * privacy.dcor(
                batch["images"], z)
        return loss, z_up

    def server_loss(self, sp: Params, z: torch.Tensor, batch: dict, tier: int):
        logits = R.server_forward(sp, self.cfg, z, tier + 1)
        return token_xent(logits, batch["labels"], batch.get("mask"))

    def full_loss(self, params: Params, batch: dict):
        return token_xent(R.forward(params, self.cfg, batch["images"]),
                          batch["labels"], batch.get("mask"))

    # ---- FedGKT hooks (leading client axis) ----
    def client_features(self, cp: Params, batch: dict) -> torch.Tensor:
        return R.client_forward(cp, self.cfg, batch["images"])

    def aux_logits(self, ap: Params, z: torch.Tensor) -> torch.Tensor:
        return R.aux_apply(ap, z)

    def server_logits(self, sp: Params, z: torch.Tensor, tier: int) -> torch.Tensor:
        return R.server_forward(sp, self.cfg, z, tier + 1)

    def eval_acc(self, params: Params, batch: dict) -> torch.Tensor:
        """Accuracy of one model (no client axis) on one batch."""
        one = tree_map(lambda t: t[None], params)
        logits = R.forward(one, self.cfg, batch["images"][None])[0]
        return (logits.argmax(-1) == batch["labels"]).float().mean()

    def tier_costs(self, batch_size: int) -> timemodel.TierCostTable:
        return timemodel.resnet_tier_costs(self.cost_cfg, batch_size)


class TransformerAdapter:
    """The transformer archs: the dense family (SmolLM-360M, granite-3-2b, yi-6b,
    deepseek-67b), the MoE family (deepseek-moe-16b, llama4-scout; each loss
    adds ``MOE_AUX_WEIGHT * moe_aux`` (0.01 x), the blocks' load-balance loss,
    (C,)) the xLSTM family (xLSTM-350M: mLSTM blocks on kernel K5, every
    ``slstm_every``-th an sLSTM block, its ``is_slstm`` flags split and merged
    with the other stacked leaves) and the hybrid family (hymba-1.5b: windowed
    attention beside the Mamba heads). The encoder-decoder and VLM families
    (whisper-base, pixtral-12b) build, and their first step raises ``KeyError:
    'frontend'`` as the JAX package's does: the LM batches carry tokens and
    labels only. ``dcor_alpha > 0`` adds the §4.4 regularizer to the client
    loss, between the embedded tokens and the uploaded activations
    (``privacy.dcor``, on kernel K2), as ``repro/fed/adapter.py:157-162``."""

    def __init__(self, cfg, *, seq_len: int, cost_cfg=None, dcor_alpha: float = 0.0):
        # DTFL split training unties embeddings: the halves live on
        # different hosts.
        self.cfg = cfg.replace(tie_embeddings=False)
        cost_cfg = (cost_cfg or cfg).replace(tie_embeddings=False)
        if cost_cfg.n_modules != self.cfg.n_modules:
            cost_cfg = cost_cfg.replace(n_modules=self.cfg.n_modules)
        self.cost_cfg = cost_cfg
        self.seq_len = seq_len
        self.n_tiers = tiering.n_tiers(self.cfg)
        self.dcor_alpha = dcor_alpha

    def init_global(self, gen: torch.Generator) -> Params:
        return M.init(gen, self.cfg)

    def split(self, params: Params, tier: int):
        return tiering.split_params(params, self.cfg, tier + 1)

    def merge(self, client: Params, server: Params) -> Params:
        return tiering.merge_params(client, server, axis=1)

    def aux_init(self, gen: torch.Generator, tier: int) -> Params:
        return M.aux_head_init(gen, self.cfg)

    # ---- losses (leading client axis) ----
    def client_loss(self, cp: Params, ap: Params, batch: dict,
                    rng: torch.Generator | None = None):
        z, moe_aux = M.client_forward(cp, self.cfg, batch)
        logits = M.aux_head_apply(ap, self.cfg, z)
        loss = token_xent(logits, batch["labels"], batch.get("mask")) + MOE_AUX_WEIGHT * moe_aux
        if self.dcor_alpha > 0.0:
            x_in = M.embed_tokens(cp, self.cfg, batch)
            loss = (1 - self.dcor_alpha) * loss + self.dcor_alpha * privacy.dcor(x_in, z)
        return loss, z

    def server_loss(self, sp: Params, z: torch.Tensor, batch: dict, tier: int):
        logits, moe_aux = M.server_forward(sp, self.cfg, z)
        return token_xent(logits, batch["labels"], batch.get("mask")) + MOE_AUX_WEIGHT * moe_aux

    def full_loss(self, params: Params, batch: dict):
        logits, moe_aux = M.forward(params, self.cfg, batch)
        return token_xent(logits, batch["labels"], batch.get("mask")) + MOE_AUX_WEIGHT * moe_aux

    # ---- FedGKT hooks (leading client axis) ----
    def client_features(self, cp: Params, batch: dict) -> torch.Tensor:
        z, _ = M.client_forward(cp, self.cfg, batch)
        return z

    def aux_logits(self, ap: Params, z: torch.Tensor) -> torch.Tensor:
        return M.aux_head_apply(ap, self.cfg, z)

    def server_logits(self, sp: Params, z: torch.Tensor, tier: int) -> torch.Tensor:
        logits, _ = M.server_forward(sp, self.cfg, z)
        return logits

    def eval_acc(self, params: Params, batch: dict) -> torch.Tensor:
        """Next-token accuracy of one model (no client axis) on one batch."""
        one = tree_map(lambda t: t[None], params)
        logits, _ = M.forward(one, self.cfg, {k: v[None] for k, v in batch.items()})
        return (logits[0].argmax(-1) == batch["labels"]).float().mean()

    def tier_costs(self, batch_size: int) -> timemodel.TierCostTable:
        return timemodel.transformer_tier_costs(self.cost_cfg, batch_size, self.seq_len)
