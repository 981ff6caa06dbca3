"""Local-loss split training (pair: ``repro/core/local_loss.py:1``).

``token_xent``: the per-token term runs on kernel K3
(``kernels/fused_xent.py``): the hand-written CUDA kernels for a CUDA
tensor, their plain version for a CPU tensor. The weighted mean over the
pad ``mask`` stays in torch ops on the (C, ...) per-token losses.

``make_dtfl_train_step`` and ``make_full_train_step`` are the JAX
package's functional steps (``:73-142``) over the port's trees, for the
transformer archs. They are the trainers' own steps
(``fed/dtfl.py::tier_step``, ``fed/base.py::full_step``) at the identity
codec, so every tree and loss carries the port's leading client axis; the
dry-run (``launch/steps.py``) runs them at one client (C = 1).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels.fused_xent import fused_xent

Params = dict
MOE_AUX_WEIGHT = 0.01


def token_xent(logits: torch.Tensor, labels: torch.Tensor,
               weight: torch.Tensor | None = None) -> torch.Tensor:
    """Per-client mean cross-entropy; logits fp32 or bf16, stats in fp32.

    ``logits`` (C, ..., V), ``labels`` (C, ...): the leading client axis is
    kept, everything else is reduced, so the result is (C,) — the JAX
    function's scalar for each client. ``weight`` (leading-axes
    broadcastable, e.g. a per-sample (C, B) pad mask from
    ``data/pipeline.py``) turns the mean into a weighted mean so padded
    samples contribute nothing."""
    if isinstance(logits, DTensor):  # the dry-run's sharded trace: rows stay placed
        per = fused_xent(logits, labels)
    else:
        V = logits.shape[-1]
        per = fused_xent(logits.reshape(-1, V).contiguous(), labels.reshape(-1))
        per = per.reshape(labels.shape)
    dims = tuple(range(1, per.ndim))
    if weight is None:
        return per.mean(dim=dims)
    w = weight.float()
    w = w.reshape(w.shape + (1,) * (per.ndim - w.ndim)).expand(per.shape)
    return (per * w).sum(dim=dims) / torch.clamp_min(w.sum(dim=dims), 1.0)


class DTFLState(NamedTuple):
    client_params: Params
    aux_params: Params
    server_params: Params
    client_opt: Any
    aux_opt: Any
    server_opt: Any


class DTFLMetrics(NamedTuple):
    client_loss: torch.Tensor      # (C,)
    server_loss: torch.Tensor      # (C,)


def init_tier_state(gen: "torch.Generator | None", cfg, params: Params, tier: int,
                    optimizer) -> DTFLState:
    """``params`` (one model, as ``models/model.py::init`` gives it) split at
    ``tier`` (1-based), a fresh aux head drawn from ``gen`` on the params'
    device, and each half's optimizer state, with a client axis of 1."""
    from repro_torch.core import tiering
    from repro_torch.fed.cohort import broadcast_state
    from repro_torch.models import model as M

    client_p, server_p = tiering.split_params(params, cfg, tier)
    aux_p = M.aux_head_init(gen, cfg, device=params["embed"].device)
    state = DTFLState(client_p, aux_p, server_p, optimizer.init(client_p),
                      optimizer.init(aux_p), optimizer.init(server_p))
    return broadcast_state(state, 1)


def make_dtfl_train_step(cfg, optimizer, *, dcor_alpha: float = 0.0) -> Callable:
    """Returns ``step(state, batch) -> (state, DTFLMetrics)``: the client
    half and the aux head on the local loss, the server half on the
    detached ``z``, each through ``optimizer``. ``dcor_alpha`` > 0 adds the
    §4.4 regularizer ``(1-a)·loss + a·DCor(x, z)`` to the client objective
    (``privacy.dcor``, on kernel K2)."""
    from repro_torch.core.codec import IdentityCodec
    from repro_torch.fed.adapter import DTFLStepState, TransformerAdapter
    from repro_torch.fed.dtfl import tier_step

    adapter = TransformerAdapter(cfg, seq_len=0, dcor_alpha=dcor_alpha)
    inner = tier_step(adapter, optimizer, IdentityCodec(), None)

    def step(state: DTFLState, batch: dict) -> tuple[DTFLState, DTFLMetrics]:
        new, (closs, sloss) = inner(DTFLStepState(*state), batch)
        return DTFLState(*new), DTFLMetrics(closs, sloss)

    return step


def make_full_train_step(cfg, optimizer) -> Callable:
    """Conventional single-loss step over the unsplit model:
    ``step(params, opt_state, batch) -> (params, opt_state, loss)``."""
    from repro_torch.fed.adapter import TransformerAdapter
    from repro_torch.fed.base import full_step

    inner = full_step(TransformerAdapter(cfg, seq_len=0), optimizer)

    def step(params: Params, opt_state, batch: dict):
        new, loss = inner({"p": params, "o": opt_state}, batch)
        return new["p"], new["o"], loss

    return step
