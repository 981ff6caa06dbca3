"""Public model API of the transformer (pair: ``repro/models/model.py:1``).

Dense, MoE, xLSTM, hybrid, encoder-decoder and VLM families. The
parameter tree keeps the JAX package's keys, with the blocks stacked on a
layer axis so a DTFL tier splits it by slicing (``core/tiering.py``)::

    params = {
      'embed':      (V, D),
      'blocks':     {... leading axis L ...},
      'final_ln':   (D,),
      'lm_head':    (D, V)          # absent when cfg.tie_embeddings
      'front_proj': (d_front, D)    # vlm / audio stub projector
      'enc_blocks': {... axis L_enc}  # encdec
      'enc_ln':     (D,),           # encdec
    }

``init`` returns one model (no client axis); every apply function takes a
leading client axis C on the parameters and on the batch: tokens (C, B, S)
int32, frontend (C, B, P, d_front) float for the vlm and audio archs (the
stubbed patch or frame embeddings), and the MoE load-balance loss they
return is (C,), one per client (0.0 for the families without one). The
VLM writes its projected patches over positions [0, P) of the embedded
tokens; the encoder-decoder encodes the frames (``encode``) and its
decoder blocks attend to the result, which ``client_forward`` hands to the
server beside z. ``count_params_analytic`` counts the shapes of ``init``
built on the meta device.

Decoding (``init_cache``, ``decode_step``) keeps the client axis: a served
model is C = 1. The cache is ``{"layers": [one dict a layer], "pos": ()
int64}``; a step writes its k and v into the cache in place and returns
the new states and position. The position lives on the device and an
xLSTM layer's cell is read from its cache, so a step reads nothing back
from the device. ``client_decode`` and ``server_decode`` are the two
halves of a step under a DTFL split, as ``client_forward`` and
``server_forward`` are of the forward. An encoder-decoder's cache also
holds each decoder layer's cross-attention keys and values, which
``fill_cross_cache`` computes once from ``encode``'s output before the
first step; a VLM decodes tokens only, as the JAX package's decode does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.models import transformer as tfm
from repro_torch.models.layers import Params, client_mm, cdtype, dense_init, embed_init, rmsnorm
from repro_torch.models.shardctx import constrain
from repro_torch.sharding import gather_fsdp
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
    if cfg.frontend != "none":
        params["front_proj"] = dense_init(gen, cfg.d_frontend or cfg.d_model, cfg.d_model,
                                          device=device)
    if cfg.family == "encdec":
        params["enc_blocks"] = tfm.stack_init(gen, cfg, cfg.n_enc_layers, kind="enc",
                                              device=device)
        params["enc_ln"] = torch.ones((cfg.d_model,), device=device)
    return params


def _project_frontend(params: Params, batch: dict) -> torch.Tensor:
    """The stubbed frontend's (C, B, P, d_front) embeddings through
    ``front_proj``, in fp32 (bf16 weights too, as the JAX package's type
    promotion gives it)."""
    return client_mm(batch["frontend"].float(), params["front_proj"].float())


def _gather(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """(C, B, S) tokens -> their (C, B, S, D) fp32 rows of each client's embed.
    A ``DTensor`` table takes ``F.embedding`` a client at a time, whose
    sharding rule reads a vocab-sharded table without gathering it: each
    card looks up its own rows, and the rows are summed over the cards."""
    emb = params["embed"]
    if isinstance(emb, DTensor):
        emb = gather_fsdp(emb, tokens, 2)
        return torch.stack([_summed(F.embedding(tokens[c].long(), emb[c]))
                            for c in range(emb.shape[0])])
    rows = torch.arange(emb.shape[0], device=emb.device).reshape(-1, 1, 1)
    return emb[rows, tokens.long()]


def _summed(x: DTensor) -> DTensor:
    """A lookup into a vocab-sharded table, its masked partial rows summed
    over the cards at once: DTensor keeps the lookup's mask for one
    reduction of the lookup's own output, not of a view or a second use."""
    return x.redistribute(x.device_mesh,
                          [Replicate() if p.is_partial() else p for p in x.placements])


def embed_tokens(params: Params, cfg, batch: dict) -> torch.Tensor:
    """(C, B, S) tokens -> (C, B, S, D) in the compute dtype; a VLM's
    projected patches replace positions [0, P) (``repro/models/model.py:60-67``)."""
    x = _gather(params, batch["tokens"])
    if cfg.family == "vlm":
        pe = _project_frontend(params, batch)
        if pe.shape[2] > x.shape[2]:
            raise ValueError(f"{pe.shape[2]} patches do not fit {x.shape[2]} positions")
        x = torch.cat([pe.to(x.dtype), x[:, :, pe.shape[2]:]], dim=2)
    return constrain(x.to(cdtype(cfg)), "act")


def encode(params: Params, cfg, batch: dict) -> torch.Tensor:
    """The encoder over the stubbed audio-frame embeddings
    (``repro/models/model.py:70-75``): (C, B, P, D) in the compute dtype."""
    xin = _project_frontend(params, batch).to(cdtype(cfg))
    enc, _ = tfm.stack_apply(xin, params["enc_blocks"], cfg, kind="enc")
    return rmsnorm(enc, params["enc_ln"], cfg.norm_eps)


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
    return constrain(_vocab_mask(cfg, client_mm(h, w.to(dt))), "logits")


def forward(params: Params, cfg, batch: dict) -> tuple[torch.Tensor, "torch.Tensor | float"]:
    """Returns (logits (C, B, S, V) compute-dtype, moe_aux_loss (C,))."""
    enc_out = encode(params, cfg, batch) if cfg.family == "encdec" else None
    x = embed_tokens(params, cfg, batch)
    x, aux = tfm.stack_apply(x, params["blocks"], cfg, enc_out=enc_out)
    return lm_logits(params, cfg, constrain(x, "act")), aux


def client_forward(client_params: Params, cfg, batch: dict):
    """Embed (and encode) + the client's blocks. Returns (z, moe_aux (C,));
    an encoder-decoder's z is (z, enc_out): the server's decoder blocks
    attend to the encoder's output too."""
    enc_out = encode(client_params, cfg, batch) if cfg.family == "encdec" else None
    x = embed_tokens(client_params, cfg, batch)
    x, aux = tfm.stack_apply(x, client_params["blocks"], cfg, enc_out=enc_out)
    x = constrain(x, "z")  # the DTFL client->server hand-off boundary
    return ((x, enc_out) if enc_out is not None else x), aux


def server_forward(server_params: Params, cfg, z) -> tuple[torch.Tensor, "torch.Tensor | float"]:
    """The remaining blocks + head on the received activations (an
    encoder-decoder's ``(z, enc_out)``). Returns (logits, moe_aux (C,))."""
    enc_out = None
    if cfg.family == "encdec":
        z, enc_out = z
    z = constrain(z, "z")
    first = cfg.n_layers - tree_leaves(server_params["blocks"])[0].shape[1]  # the tail
    x, aux = tfm.stack_apply(z, server_params["blocks"], cfg, enc_out=enc_out, first_layer=first)
    return lm_logits(server_params, cfg, x), aux


def aux_head_init(gen: torch.Generator | None, cfg, *, device="cpu") -> Params:
    """DTFL auxiliary network: norm + linear local head (transformer port of
    the paper's avgpool+fc)."""
    return {
        "ln": torch.ones((cfg.d_model,), device=device),
        "proj": dense_init(gen, cfg.d_model, cfg.padded_vocab, scale=0.02, device=device),
    }


def aux_head_apply(aux_params: Params, cfg, z) -> torch.Tensor:
    if cfg.family == "encdec":
        z, _ = z
    dt = cdtype(cfg)
    h = rmsnorm(z, aux_params["ln"], cfg.norm_eps).to(dt)
    return constrain(_vocab_mask(cfg, client_mm(h, aux_params["proj"].to(dt))), "logits")


def count_params_analytic(cfg, active_only: bool = False) -> int:
    """Parameter count of ``init`` (shapes on the meta device). Active
    parameters as ``repro/models/model.py:212-227``: a dense model's are
    its total; an MoE layer uses ``top_k`` of its routed experts, so the
    other experts' three matrices are taken off; an xLSTM stack holds both
    cells in every layer and uses one, so the unused cell of each layer is
    taken off; a hybrid, encoder-decoder or VLM model uses all of its
    parameters."""
    total = _tree_size(init(None, cfg, device="meta"))
    if active_only and cfg.family == "moe":
        per_expert = 3 * cfg.d_model * cfg.d_ff
        total -= (cfg.n_experts - cfg.top_k) * cfg.n_layers * per_expert
    if active_only and cfg.family == "ssm" and cfg.slstm_every:
        n_sl = sum(1 for i in range(cfg.n_layers) if tfm.is_slstm_layer(cfg, i))
        block = tfm.block_init(None, cfg, device="meta")
        m_sz, s_sz = _tree_size(block["mlstm"]), _tree_size(block["slstm"])
        total -= n_sl * m_sz + (cfg.n_layers - n_sl) * s_sz
    return total


def _tree_size(tree) -> int:
    return sum(int(math.prod(t.shape)) for t in tree_leaves(tree))


# ---------------------------------------------------------------------------
# decode (serving), pair: ``repro/models/model.py:159-201``
# ---------------------------------------------------------------------------

def cache_len_for(cfg, seq_len: int, *, long_context: bool) -> int:
    if long_context and cfg.serve_window:
        return min(seq_len, cfg.serve_window)
    if cfg.window:
        return min(seq_len, cfg.window)
    return seq_len


def init_cache(cfg, batch_size: int, seq_len: int, *, long_context: bool = False,
               device="cpu") -> Params:
    """Empty caches of ``cfg.n_layers`` layers for ``batch_size`` sequences
    of up to ``seq_len`` tokens; attention keeps ``cache_len_for`` slots
    (with ``long_context``, the ``serve_window`` ring of the long-context
    serve variant, as ``repro/models/model.py:167-172``), an xLSTM layer the
    state of its cell (``tfm.is_slstm_layer``)."""
    W = cache_len_for(cfg, seq_len, long_context=long_context)
    layers = [tfm.block_cache_init(cfg, batch_size, W, slstm=tfm.is_slstm_layer(cfg, i),
                                   device=device)
              for i in range(cfg.n_layers)]
    return {"layers": layers, "pos": torch.zeros((), dtype=torch.int64, device=device)}


def fill_cross_cache(blocks: Params, cfg, enc_out: torch.Tensor, cache: Params) -> Params:
    """Write each decoder layer's cross-attention keys and values over the
    encoder's output ``enc_out`` (C, B, P, D) into ``cache`` in place:
    ``enc @ xattn.wk[i]`` and ``enc @ xattn.wv[i]`` per layer, no RoPE, as
    the JAX CLI (``repro/launch/serve.py:46-58``) fills them. ``blocks`` are
    the stacked blocks whose layers the cache holds (a split half's, under
    ``--split-tier``). Returns the cache."""
    C, B, P, _ = enc_out.shape
    dt = cdtype(cfg)
    enc = enc_out.to(dt)
    for i, layer in enumerate(cache["layers"]):
        for name, w in (("xk", "wk"), ("xv", "wv")):
            proj = client_mm(enc, blocks["xattn"][w][:, i].to(dt))
            layer[name].copy_(proj.reshape(C, B, P, cfg.n_kv_heads, cfg.resolved_head_dim))
    return cache


def _decode_blocks(blocks: Params, cfg, x: torch.Tensor, cache: Params
                   ) -> tuple[torch.Tensor, Params]:
    pos = cache["pos"]
    ring = _is_ring(cfg, _attn_cache_len(cache))
    x, layers, _ = tfm.stack_decode(x, blocks, cache["layers"], cfg, pos, ring=ring)
    return x, {"layers": layers, "pos": pos + 1}


def _embed_token(params: Params, cfg, token: torch.Tensor) -> torch.Tensor:
    # no frontend fusion: the JAX package's decode embeds tokens only
    return _gather(params, token[..., None]).to(cdtype(cfg))          # (C, B, 1, D)


def decode_step(params: Params, cfg, token: torch.Tensor, cache: Params
                ) -> tuple[torch.Tensor, Params]:
    """``token`` (C, B) int, the tokens at position ``cache["pos"]``.
    Returns (logits (C, B, V), the cache with pos + 1)."""
    x = _embed_token(params, cfg, token)
    x, cache = _decode_blocks(params["blocks"], cfg, x, cache)
    return lm_logits(params, cfg, x)[:, :, 0], cache


def client_decode(client_params: Params, cfg, token: torch.Tensor, cache: Params
                  ) -> tuple[torch.Tensor, Params]:
    """Embed + the client's blocks for one token: (z (C, B, 1, D), cache)."""
    x = _embed_token(client_params, cfg, token)
    return _decode_blocks(client_params["blocks"], cfg, x, cache)


def server_decode(server_params: Params, cfg, z: torch.Tensor, cache: Params
                  ) -> tuple[torch.Tensor, Params]:
    """The remaining blocks + head on the client's z: (logits (C, B, V), cache)."""
    x, cache = _decode_blocks(server_params["blocks"], cfg, z, cache)
    return lm_logits(server_params, cfg, x)[:, :, 0], cache


def _attn_cache_len(cache: Params) -> int | None:
    layers = cache["layers"]
    if layers and "k" in layers[0]:
        return layers[0]["k"].shape[2]
    return None


def _is_ring(cfg, cache_len: int | None) -> bool:
    if cache_len is None:
        return False
    w = cfg.window or cfg.serve_window
    return bool(w) and cache_len <= w
