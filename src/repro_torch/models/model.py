"""Public model API of the transformer (pair: ``repro/models/model.py:1``).

Dense family only. The parameter tree keeps the JAX package's keys, with
the blocks stacked on a layer axis so a DTFL tier splits it by slicing
(``core/tiering.py``)::

    params = {
      'embed':    (V, D),
      'blocks':   {... leading axis L ...},
      'final_ln': (D,),
      'lm_head':  (D, V)     # absent when cfg.tie_embeddings
    }

``init`` returns one model (no client axis); every apply function takes a
leading client axis C on the parameters and on the batch: tokens (C, B, S)
int32. ``count_params_analytic`` counts the shapes of ``init`` built on the
meta device.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.layers import Params, client_mm, cdtype, dense_init, embed_init, rmsnorm
from repro_torch.tree import tree_leaves


def init(gen: torch.Generator | None, cfg, *, device="cpu") -> Params:
    """One model, fp32, drawn from ``gen`` on ``device``."""
    params: Params = {
        "embed": embed_init(gen, cfg.padded_vocab, cfg.d_model, device=device),
        "blocks": tfm.stack_init(gen, cfg, cfg.n_layers, device=device),
        "final_ln": torch.ones((cfg.d_model,), device=device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.padded_vocab, scale=0.02,
                                       device=device)
    return params


def embed_tokens(params: Params, cfg, batch: dict) -> torch.Tensor:
    """(C, B, S) tokens -> (C, B, S, D) in the compute dtype."""
    emb = params["embed"]
    rows = torch.arange(emb.shape[0], device=emb.device).reshape(-1, 1, 1)
    return emb[rows, batch["tokens"].long()].to(cdtype(cfg))


def _vocab_mask(cfg, logits: torch.Tensor) -> torch.Tensor:
    if cfg.padded_vocab == cfg.vocab:
        return logits
    # mask the padded vocab rows out of the softmax
    col = torch.arange(cfg.padded_vocab, device=logits.device)
    mask = torch.where(col < cfg.vocab, 0.0, -1e9)
    return logits + mask.to(logits.dtype)


def lm_logits(params: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    dt = cdtype(cfg)
    h = rmsnorm(x, params["final_ln"], cfg.norm_eps).to(dt)
    # tied configs fall back to embed^T; DTFL split training unties (the two
    # halves live on different hosts), so a split server tree has lm_head.
    w = params["lm_head"] if "lm_head" in params else params["embed"].transpose(1, 2)
    return _vocab_mask(cfg, client_mm(h, w.to(dt)))


def forward(params: Params, cfg, batch: dict) -> tuple[torch.Tensor, float]:
    """Returns (logits (C, B, S, V) compute-dtype, moe_aux_loss)."""
    x = embed_tokens(params, cfg, batch)
    x, aux = tfm.stack_apply(x, params["blocks"], cfg)
    return lm_logits(params, cfg, x), aux


def client_forward(client_params: Params, cfg, batch: dict) -> tuple[torch.Tensor, float]:
    """Embed + the client's blocks. Returns (z, moe_aux)."""
    x = embed_tokens(client_params, cfg, batch)
    return tfm.stack_apply(x, client_params["blocks"], cfg)


def server_forward(server_params: Params, cfg, z: torch.Tensor) -> tuple[torch.Tensor, float]:
    """The remaining blocks + head on the received activations."""
    x, aux = tfm.stack_apply(z, server_params["blocks"], cfg)
    return lm_logits(server_params, cfg, x), aux


def aux_head_init(gen: torch.Generator | None, cfg, *, device="cpu") -> Params:
    """DTFL auxiliary network: norm + linear local head (transformer port of
    the paper's avgpool+fc)."""
    return {
        "ln": torch.ones((cfg.d_model,), device=device),
        "proj": dense_init(gen, cfg.d_model, cfg.padded_vocab, scale=0.02, device=device),
    }


def aux_head_apply(aux_params: Params, cfg, z: torch.Tensor) -> torch.Tensor:
    dt = cdtype(cfg)
    h = rmsnorm(z, aux_params["ln"], cfg.norm_eps).to(dt)
    return _vocab_mask(cfg, client_mm(h, aux_params["proj"].to(dt)))


def count_params_analytic(cfg, active_only: bool = False) -> int:
    """Parameter count of ``init`` (shapes on the meta device). A dense
    model's active count is its total; the other families are not yet
    ported (``init`` raises for them)."""
    shapes = init(None, cfg, device="meta")
    return sum(int(math.prod(t.shape)) for t in tree_leaves(shapes))
