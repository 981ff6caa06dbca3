"""Transformer blocks and the stacked layer run (pair: ``repro/models/transformer.py:1``).

Block kinds:
  dense  : GQA attention + SwiGLU MLP (SmolLM-360M, granite-3-2b, yi-6b,
           deepseek-67b; pixtral-12b, the VLM, whose patches are fused
           into the embeddings);
  moe    : GQA attention + the shared and routed top-k MoE FFN
           (deepseek-moe-16b, llama4-scout; ``models/moe.py``);
  ssm    : the xLSTM block, an mLSTM or an sLSTM cell chosen per layer by
           the float leaf ``is_slstm`` (xLSTM-350M);
  hybrid : the hymba block, windowed GQA attention beside the Mamba heads
           on one norm, their normed outputs fused, then the MLP
           (hymba-1.5b);
  enc    : bidirectional attention + MLP (whisper-base's encoder);
  dec    : causal self-attention, cross-attention over the encoder's
           output, then the MLP (whisper-base's decoder).
Layer parameters are stacked on a layer axis, which is axis 1 behind the
client axis (C, L, ...); a DTFL tier is a slice of that axis
(``core/tiering.py``). ``stack_apply`` loops over it (the JAX package scans
it, with remat; at the sizes the port trains, the activations of every
layer fit, and the Mamba scan recomputes its chunks in the backward).
``stack_decode`` steps one token through the layers, each with its own
cache (``block_cache_init``); a decoder layer's cache also holds the
cross-attention's keys and values over the encoder's output, filled once
before the first step (``models/model.py::fill_cross_cache``).
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (Params, attn_apply, attn_decode_apply,
                                       attn_param_init, cdtype, cross_attn_decode_apply,
                                       mlp_apply, mlp_param_init, per_client, rmsnorm)
from repro_torch.models.shardctx import constrain
from repro_torch.sharding import placed_as
from repro_torch.tree import tree_map


def block_kind(cfg) -> str:
    """The block kind of a config's family's layer stack
    (``repro/models/transformer.py:39-47``): the VLM's is ``dense``, the
    encoder-decoder's ``dec`` (its encoder's is ``enc``)."""
    return {"dense": "dense", "vlm": "dense", "moe": "moe", "ssm": "ssm",
            "hybrid": "hybrid", "encdec": "dec"}[cfg.family]


def block_init(gen, cfg, *, kind: str | None = None, lead: tuple = (),
               device="cpu") -> Params:
    """One block's parameters, of ``kind`` (the config's stack's by
    default), with ``lead`` prepended to every leaf."""
    d = cfg.d_model
    kind = kind or block_kind(cfg)
    if kind == "ssm":
        return {
            "mlstm": ssm_lib.mlstm_param_init(gen, cfg, lead=lead, device=device),
            "slstm": ssm_lib.slstm_param_init(gen, cfg, lead=lead, device=device),
        }

    def ones():
        return torch.ones(lead + (d,), device=device)

    if kind == "hybrid":
        return {
            "ln1": ones(),
            "attn": attn_param_init(gen, cfg, lead=lead, device=device),
            "mamba": ssm_lib.mamba_param_init(gen, cfg, lead=lead, device=device),
            "beta_attn": ones(),
            "beta_ssm": ones(),
            "ln_attn": ones(),
            "ln_ssm": ones(),
            "ln2": ones(),
            "mlp": mlp_param_init(gen, d, cfg.d_ff, lead=lead, device=device),
        }
    block = {
        "ln1": ones(),
        "attn": attn_param_init(gen, cfg, lead=lead, device=device),
    }
    if kind == "dec":
        block["ln_x"] = ones()
        block["xattn"] = attn_param_init(gen, cfg, lead=lead, device=device)
    block["ln2"] = ones()
    if kind == "moe":
        block["moe"] = moe_lib.moe_param_init(gen, cfg, lead=lead, device=device)
    else:
        block["mlp"] = mlp_param_init(gen, d, cfg.d_ff, lead=lead, device=device)
    return block


def stack_init(gen, cfg, n_layers: int, *, kind: str | None = None,
               device="cpu") -> Params:
    """``n_layers`` blocks of ``kind`` (the config's stack's by default)
    stacked on a leading layer axis. An xLSTM stack with ``slstm_every``
    also holds the float flags ``is_slstm`` (L,): 1.0 for every
    ``slstm_every``-th layer (``repro/models/transformer.py:103-106``,
    ``is_slstm_layer``)."""
    kind = kind or block_kind(cfg)
    stacked = block_init(gen, cfg, kind=kind, lead=(n_layers,), device=device)
    if kind == "ssm" and cfg.slstm_every:
        # made on the host and moved, so that under a fake-tensor trace on
        # the meta device it is a fake tensor too
        stacked["is_slstm"] = torch.tensor(
            [float(is_slstm_layer(cfg, i)) for i in range(n_layers)]).to(device)
    return stacked


def block_apply(x: torch.Tensor, bp: Params, cfg, *, causal: bool = True) -> torch.Tensor:
    """A dense block, or an encoder block with ``causal=False``; x
    (C, B, S, D), ``bp`` one layer's leaves (C, ...)."""
    x = x + attn_apply(rmsnorm(x, bp["ln1"], cfg.norm_eps), bp["attn"], cfg, causal=causal)
    return x + mlp_apply(rmsnorm(x, bp["ln2"], cfg.norm_eps), bp["mlp"], cfg)


def dec_block_apply(x: torch.Tensor, bp: Params, cfg, enc_out: torch.Tensor) -> torch.Tensor:
    """A decoder block (``repro/models/transformer.py:155-162``): causal
    self-attention, then cross-attention over ``enc_out`` (C, B, P, D) on
    ``ln_x``, no RoPE, then the MLP."""
    x = x + attn_apply(rmsnorm(x, bp["ln1"], cfg.norm_eps), bp["attn"], cfg, causal=True)
    x = x + attn_apply(rmsnorm(x, bp["ln_x"], cfg.norm_eps), bp["xattn"], cfg, causal=False,
                       kv_source=enc_out, use_rope=False)
    return x + mlp_apply(rmsnorm(x, bp["ln2"], cfg.norm_eps), bp["mlp"], cfg)


def moe_block_apply(x: torch.Tensor, bp: Params, cfg) -> tuple[torch.Tensor, torch.Tensor]:
    """An MoE block; returns (x, the layer's load-balance loss (C,))."""
    x = x + attn_apply(rmsnorm(x, bp["ln1"], cfg.norm_eps), bp["attn"], cfg, causal=True)
    y, aux = moe_lib.moe_apply(rmsnorm(x, bp["ln2"], cfg.norm_eps), bp["moe"], cfg)
    return x + y, aux


def _fuse(x: torch.Tensor, a: torch.Tensor, m: torch.Tensor, bp: Params, cfg) -> torch.Tensor:
    """The hybrid block's head fusion, ``0.5 (beta_attn norm(a) + beta_ssm
    norm(m))`` in fp32, cast to x's dtype (``repro/models/transformer.py:146-149``)."""
    na = rmsnorm(a, bp["ln_attn"], cfg.norm_eps)
    nm = rmsnorm(m, bp["ln_ssm"], cfg.norm_eps)
    return (0.5 * (per_client(bp["beta_attn"], na) * na
                   + per_client(bp["beta_ssm"], nm) * nm)).to(x.dtype)


def hybrid_block_apply(x: torch.Tensor, bp: Params, cfg) -> torch.Tensor:
    """A hymba block: attention at ``window=cfg.window`` and the Mamba heads
    on one norm of x, fused, then the MLP."""
    h = rmsnorm(x, bp["ln1"], cfg.norm_eps)
    a = attn_apply(h, bp["attn"], cfg, causal=True, window=cfg.window)
    m = ssm_lib.mamba_apply(h, bp["mamba"], cfg)
    x = x + _fuse(x, a, m, bp, cfg)
    return x + mlp_apply(rmsnorm(x, bp["ln2"], cfg.norm_eps), bp["mlp"], cfg)


def ssm_block_apply(x: torch.Tensor, bp: Params, cfg, slstm: bool) -> torch.Tensor:
    """An xLSTM block: the flagged cell only, so the other cell's leaves
    get no gradient (the trainer gives them exact zeros, as the JAX
    package's select does)."""
    if slstm:
        return ssm_lib.slstm_apply(x, bp["slstm"], cfg)
    return ssm_lib.mlstm_apply(x, bp["mlstm"], cfg)


def stack_apply(x: torch.Tensor, stacked: Params, cfg, *, kind: str | None = None,
                enc_out: torch.Tensor | None = None, first_layer: int = 0
                ) -> tuple[torch.Tensor, "torch.Tensor | float"]:
    """Run x through the stacked blocks (leaves (C, L, ...)) of ``kind``
    (the config's stack's by default; ``dec`` blocks attend to
    ``enc_out``); ``first_layer`` is the model's index of the stack's first
    block (a server half's is the split layer). Returns (x, moe_aux_loss):
    for MoE blocks the sum over layers of each client's load-balance loss,
    (C,); 0.0 for the other blocks, which have none."""
    kind = kind or block_kind(cfg)
    if kind in ("dense", "moe", "hybrid", "enc", "dec"):
        aux = 0.0
        # the carry's layout, every layer: a layer scan's carry enters as it
        # leaves (the encoder's projected frames are placed nowhere before)
        x = constrain(x, "act")
        for layer in range(stacked["ln1"].shape[1]):
            bp = tree_map(lambda t: t[:, layer], stacked)
            if kind in ("dense", "enc"):
                x = block_apply(x, bp, cfg, causal=kind == "dense")
            elif kind == "dec":
                x = dec_block_apply(x, bp, cfg, enc_out)
            elif kind == "hybrid":
                x = hybrid_block_apply(x, bp, cfg)
            else:
                x, layer_aux = moe_block_apply(x, bp, cfg)
                aux = aux + layer_aux
            x = constrain(x, "act")
        return x, aux
    flags = slstm_flags(stacked, cfg, first_layer)
    cells = {k: stacked[k] for k in ("mlstm", "slstm")}
    for layer, slstm in enumerate(flags):
        x = ssm_block_apply(x, tree_map(lambda t: t[:, layer], cells), cfg, slstm)
    return x, 0.0


def slstm_flags(stacked: Params, cfg, first_layer: int = 0) -> list[bool]:
    """Which layers of an xLSTM stack are sLSTM blocks: one host read of
    ``is_slstm`` per stack; every client holds the global flags (a leaf with
    zero gradients, which Adam and FedAvg leave on its side of 0.5).

    A trace on fake tensors (``launch/dryrun.py``) has no values to read:
    there the flags are the config's rule (``is_slstm_layer``) from the
    stack's ``first_layer``, as ``stack_init`` wrote them."""
    n_layers = stacked["mlstm"]["ln"].shape[1]
    if "is_slstm" not in stacked:
        return [False] * n_layers
    flags = stacked["is_slstm"]
    if is_fake(flags):
        if first_layer + n_layers > cfg.n_layers:
            raise ValueError(f"a stack of {n_layers} layers from layer {first_layer} exceeds "
                             f"the model's {cfg.n_layers}")
        return [is_slstm_layer(cfg, first_layer + i) for i in range(n_layers)]
    per_client = (flags > 0.5).cpu()
    if not bool((per_client == per_client[:1]).all()):
        raise ValueError("clients disagree on which layers are sLSTM blocks")
    return per_client[0].tolist()


# ---------------------------------------------------------------------------
# one-token decode, a cache per layer
# ---------------------------------------------------------------------------

def is_slstm_layer(cfg, layer: int) -> bool:
    """Whether layer ``layer`` of an xLSTM stack is an sLSTM block, the
    rule ``stack_init`` writes into ``is_slstm``."""
    return bool(cfg.slstm_every) and layer % cfg.slstm_every == cfg.slstm_every - 1


def block_cache_init(cfg, batch: int, cache_len: int, *, slstm: bool = False,
                     device="cpu") -> Params:
    """One layer's decode cache (``repro/models/transformer.py:193-221``) for
    one model (a client axis of 1): attention k and v (1, B, W, KV, hd) in
    the compute dtype, and the recurrent state of the Mamba heads or of the
    xLSTM layer's cell, fp32; a decoder layer also holds the
    cross-attention's xk and xv (1, B, n_frontend_tokens, KV, hd), zero
    until ``models/model.py::fill_cross_cache`` fills them. An xLSTM layer
    keeps the state of the cell it runs only, the sLSTM's if ``slstm``, so
    the cache says which cell a step runs (the JAX package keeps both and
    picks by ``is_slstm``)."""
    kind = block_kind(cfg)
    lead = (1,)
    if kind == "ssm":
        if slstm:
            return {"slstm": ssm_lib.slstm_state_init(cfg, batch, lead=lead, device=device)}
        return {"mlstm": ssm_lib.mlstm_state_init(cfg, batch, lead=lead, device=device)}
    shape = lead + (batch, cache_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    cache = {"k": torch.zeros(shape, dtype=cdtype(cfg), device=device),
             "v": torch.zeros(shape, dtype=cdtype(cfg), device=device)}
    if kind == "hybrid":
        cache["mamba"] = ssm_lib.mamba_state_init(cfg, batch, lead=lead, device=device)
    if kind == "dec":
        xshape = lead + (batch, cfg.n_frontend_tokens, cfg.n_kv_heads, cfg.resolved_head_dim)
        cache["xk"] = torch.zeros(xshape, dtype=cdtype(cfg), device=device)
        cache["xv"] = torch.zeros(xshape, dtype=cdtype(cfg), device=device)
    return cache


def block_decode(x: torch.Tensor, bp: Params, cache: Params, cfg, pos: torch.Tensor, *,
                 ring: bool) -> tuple[torch.Tensor, Params, "torch.Tensor | float"]:
    """One token through one block, x (C, B, 1, D) (``repro/models/transformer.py:224-287``).
    Returns (x, the layer's cache, the MoE load-balance loss (C,) or 0.0).
    An xLSTM layer runs the cell whose state its cache holds; a decoder
    layer reads its cross caches and returns them as they were."""
    kind = block_kind(cfg)
    if kind == "ssm":
        cell, step = (("slstm", ssm_lib.slstm_decode) if "slstm" in cache
                      else ("mlstm", ssm_lib.mlstm_decode))
        x, state = step(x, bp[cell], cfg, cache[cell])
        return x, {cell: state}, 0.0
    h = rmsnorm(x, bp["ln1"], cfg.norm_eps)
    a, kv = attn_decode_apply(h, bp["attn"], cfg, {"k": cache["k"], "v": cache["v"]}, pos,
                              ring=ring)
    cache = {**cache, **kv}
    if kind == "hybrid":
        m, cache["mamba"] = ssm_lib.mamba_decode(h, bp["mamba"], cfg, cache["mamba"])
        x = x + _fuse(x, a, m, bp, cfg)
    else:
        x = x + a
    if kind == "dec":
        x = x + cross_attn_decode_apply(rmsnorm(x, bp["ln_x"], cfg.norm_eps), bp["xattn"], cfg,
                                        cache["xk"], cache["xv"])
    h = rmsnorm(x, bp["ln2"], cfg.norm_eps)
    if kind == "moe":
        y, aux = moe_lib.moe_apply(h, bp["moe"], cfg)
        return x + y, cache, aux
    return x + mlp_apply(h, bp["mlp"], cfg), cache, 0.0


def stack_decode(x: torch.Tensor, stacked: Params, caches: list, cfg, pos: torch.Tensor, *,
                 ring: bool) -> tuple[torch.Tensor, list, "torch.Tensor | float"]:
    """One token through the stacked blocks (leaves (C, L, ...)), layer i
    with ``caches[i]``. Returns (x, the new caches, the summed MoE loss).
    It reads nothing back from the device, so a CUDA graph can capture it."""
    new, aux, layout = [], 0.0, x
    for layer, cache in enumerate(caches):
        bp = tree_map(lambda t: t[:, layer], stacked)
        x, cache, layer_aux = block_decode(x, bp, cache, cfg, pos, ring=ring)
        x = placed_as(x, layout)  # a sharded trace keeps the token's layout, layer to layer
        new.append(cache)
        aux = aux + layer_aux
    return x, new, aux
