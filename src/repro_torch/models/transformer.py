"""Transformer blocks and the stacked layer run (pair: ``repro/models/transformer.py:1``).

Dense family only: GQA attention + SwiGLU MLP. Layer parameters are
stacked on a layer axis, which is axis 1 behind the client axis (C, L,
...); a DTFL tier is a slice of that axis (``core/tiering.py``).
``stack_apply`` loops over it (the JAX package scans it, with remat; at
the sizes the port trains, the activations of every layer fit). The MoE,
xLSTM, hybrid and encoder-decoder families raise "not yet ported".
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import (Params, attn_apply, attn_param_init,
                                       mlp_apply, mlp_param_init, rmsnorm)
from repro_torch.tree import tree_map


def block_kind(cfg) -> str:
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not yet ported")
    return "dense"


def block_init(gen, cfg, *, lead: tuple = (), device="cpu") -> Params:
    """One dense block's parameters, with ``lead`` prepended to every leaf."""
    d = cfg.d_model
    return {
        "ln1": torch.ones(lead + (d,), device=device),
        "attn": attn_param_init(gen, cfg, lead=lead, device=device),
        "ln2": torch.ones(lead + (d,), device=device),
        "mlp": mlp_param_init(gen, d, cfg.d_ff, lead=lead, device=device),
    }


def stack_init(gen, cfg, n_layers: int, *, device="cpu") -> Params:
    """``n_layers`` blocks stacked on a leading layer axis."""
    block_kind(cfg)
    return block_init(gen, cfg, lead=(n_layers,), device=device)


def block_apply(x: torch.Tensor, bp: Params, cfg) -> torch.Tensor:
    """x (C, B, S, D); ``bp`` one layer's leaves (C, ...)."""
    x = x + attn_apply(rmsnorm(x, bp["ln1"], cfg.norm_eps), bp["attn"], cfg, causal=True)
    return x + mlp_apply(rmsnorm(x, bp["ln2"], cfg.norm_eps), bp["mlp"], cfg)


def stack_apply(x: torch.Tensor, stacked: Params, cfg) -> tuple[torch.Tensor, float]:
    """Run x through the stacked blocks (leaves (C, L, ...)). Returns
    (x, moe_aux_loss); the latter is 0 for dense blocks."""
    block_kind(cfg)
    for layer in range(stacked["ln1"].shape[1]):
        x = block_apply(x, tree_map(lambda t: t[:, layer], stacked), cfg)
    return x, 0.0
