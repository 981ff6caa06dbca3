"""Transformer blocks and the stacked layer run (pair: ``repro/models/transformer.py:1``).

Two block kinds so far:
  dense : GQA attention + SwiGLU MLP (SmolLM-360M);
  ssm   : the xLSTM block, an mLSTM or an sLSTM cell chosen per layer by
          the float leaf ``is_slstm`` (xLSTM-350M).
Layer parameters are stacked on a layer axis, which is axis 1 behind the
client axis (C, L, ...); a DTFL tier is a slice of that axis
(``core/tiering.py``). ``stack_apply`` loops over it (the JAX package scans
it, with remat; at the sizes the port trains, the activations of every
layer fit). The MoE, hybrid and encoder-decoder families raise "not yet
ported".
"""
from __future__ import annotations

import torch

from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (Params, attn_apply, attn_param_init,
                                       mlp_apply, mlp_param_init, rmsnorm)
from repro_torch.tree import tree_map


def block_kind(cfg) -> str:
    """The block kind of a config's family (``dense`` or ``ssm``)."""
    if cfg.family not in ("dense", "ssm"):
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
    return {
        "ln1": torch.ones(lead + (d,), device=device),
        "attn": attn_param_init(gen, cfg, lead=lead, device=device),
        "ln2": torch.ones(lead + (d,), device=device),
        "mlp": mlp_param_init(gen, d, cfg.d_ff, lead=lead, device=device),
    }


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


def ssm_block_apply(x: torch.Tensor, bp: Params, cfg, slstm: bool) -> torch.Tensor:
    """An xLSTM block: the flagged cell only, so the other cell's leaves
    get no gradient (the trainer gives them exact zeros, as the JAX
    package's select does)."""
    if slstm:
        return ssm_lib.slstm_apply(x, bp["slstm"], cfg)
    return ssm_lib.mlstm_apply(x, bp["mlstm"], cfg)


def stack_apply(x: torch.Tensor, stacked: Params, cfg) -> tuple[torch.Tensor, float]:
    """Run x through the stacked blocks (leaves (C, L, ...)). Returns
    (x, moe_aux_loss); the latter is 0 for dense and xLSTM blocks."""
    if block_kind(cfg) == "dense":
        for layer in range(stacked["ln1"].shape[1]):
            x = block_apply(x, tree_map(lambda t: t[:, layer], stacked), cfg)
        return x, 0.0
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
