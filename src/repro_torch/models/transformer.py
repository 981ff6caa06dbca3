"""Transformer blocks and the stacked layer run (pair: ``repro/models/transformer.py:1``).

Three block kinds so far:
  dense : GQA attention + SwiGLU MLP (SmolLM-360M, granite-3-2b, yi-6b,
          deepseek-67b);
  moe   : GQA attention + the shared and routed top-k MoE FFN
          (deepseek-moe-16b, llama4-scout; ``models/moe.py``);
  ssm   : the xLSTM block, an mLSTM or an sLSTM cell chosen per layer by
          the float leaf ``is_slstm`` (xLSTM-350M).
Layer parameters are stacked on a layer axis, which is axis 1 behind the
client axis (C, L, ...); a DTFL tier is a slice of that axis
(``core/tiering.py``). ``stack_apply`` loops over it (the JAX package scans
it, with remat; at the sizes the port trains, the activations of every
layer fit). The hybrid and encoder-decoder families raise "not yet
ported".
"""
from __future__ import annotations

import torch

from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (Params, attn_apply, attn_param_init,
                                       mlp_apply, mlp_param_init, rmsnorm)
from repro_torch.tree import tree_map


def block_kind(cfg) -> str:
    """The block kind of a config's family (``dense``, ``moe`` or ``ssm``)."""
    if cfg.family not in ("dense", "moe", "ssm"):
        raise NotImplementedError(f"family {cfg.family!r} is not yet ported")
    return cfg.family


def block_init(gen, cfg, *, lead: tuple = (), device="cpu") -> Params:
    """One block's parameters, with ``lead`` prepended to every leaf."""
    d = cfg.d_model
    if block_kind(cfg) == "ssm":
        return {
            "mlstm": ssm_lib.mlstm_param_init(gen, cfg, lead=lead, device=device),
            "slstm": ssm_lib.slstm_param_init(gen, cfg, lead=lead, device=device),
        }
    block = {
        "ln1": torch.ones(lead + (d,), device=device),
        "attn": attn_param_init(gen, cfg, lead=lead, device=device),
        "ln2": torch.ones(lead + (d,), device=device),
    }
    if block_kind(cfg) == "moe":
        block["moe"] = moe_lib.moe_param_init(gen, cfg, lead=lead, device=device)
    else:
        block["mlp"] = mlp_param_init(gen, d, cfg.d_ff, lead=lead, device=device)
    return block


def stack_init(gen, cfg, n_layers: int, *, device="cpu") -> Params:
    """``n_layers`` blocks stacked on a leading layer axis. An xLSTM stack
    with ``slstm_every`` also holds the float flags ``is_slstm`` (L,): 1.0
    for every ``slstm_every``-th layer (``repro/models/transformer.py:103-106``)."""
    stacked = block_init(gen, cfg, lead=(n_layers,), device=device)
    if block_kind(cfg) == "ssm" and cfg.slstm_every:
        layer = torch.arange(n_layers, device=device)
        stacked["is_slstm"] = (layer % cfg.slstm_every == cfg.slstm_every - 1).float()
    return stacked


def block_apply(x: torch.Tensor, bp: Params, cfg) -> torch.Tensor:
    """A dense block; x (C, B, S, D), ``bp`` one layer's leaves (C, ...)."""
    x = x + attn_apply(rmsnorm(x, bp["ln1"], cfg.norm_eps), bp["attn"], cfg, causal=True)
    return x + mlp_apply(rmsnorm(x, bp["ln2"], cfg.norm_eps), bp["mlp"], cfg)


def moe_block_apply(x: torch.Tensor, bp: Params, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """An MoE block; returns (x, the layer's load-balance loss (C,))."""
    x = x + attn_apply(rmsnorm(x, bp["ln1"], cfg.norm_eps), bp["attn"], cfg, causal=True)
    y, aux = moe_lib.moe_apply(rmsnorm(x, bp["ln2"], cfg.norm_eps), bp["moe"], cfg)
    return x + y, aux


def ssm_block_apply(x: torch.Tensor, bp: Params, cfg, slstm: bool) -> torch.Tensor:
    """An xLSTM block: the flagged cell only, so the other cell's leaves
    get no gradient (the trainer gives them exact zeros, as the JAX
    package's select does)."""
    if slstm:
        return ssm_lib.slstm_apply(x, bp["slstm"], cfg)
    return ssm_lib.mlstm_apply(x, bp["mlstm"], cfg)


def stack_apply(x: torch.Tensor, stacked: Params, cfg
                ) -> tuple[torch.Tensor, "torch.Tensor | float"]:
    """Run x through the stacked blocks (leaves (C, L, ...)). Returns
    (x, moe_aux_loss): for MoE blocks the sum over layers of each client's
    load-balance loss, (C,); 0.0 for dense and xLSTM blocks, which have none."""
    kind = block_kind(cfg)
    if kind in ("dense", "moe"):
        aux = 0.0
        for layer in range(stacked["ln1"].shape[1]):
            bp = tree_map(lambda t: t[:, layer], stacked)
            if kind == "dense":
                x = block_apply(x, bp, cfg)
            else:
                x, layer_aux = moe_block_apply(x, bp, cfg)
                aux = aux + layer_aux
        return x, aux
    n_layers = stacked["mlstm"]["ln"].shape[1]
    flags = [False] * n_layers
    if "is_slstm" in stacked:
        # one host read per stack; every client holds the global flags (a
        # leaf with zero gradients, which Adam and FedAvg leave on its side
        # of 0.5)
        per_client = (stacked["is_slstm"] > 0.5).cpu()
        if not bool((per_client == per_client[:1]).all()):
            raise ValueError("clients disagree on which layers are sLSTM blocks")
        flags = per_client[0].tolist()
    cells = {k: stacked[k] for k in ("mlstm", "slstm")}
    for layer in range(n_layers):
        x = ssm_block_apply(x, tree_map(lambda t: t[:, layer], cells), cfg, flags[layer])
    return x, 0.0
