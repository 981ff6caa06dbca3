"""Core transformer layers: norms, RoPE, GQA attention, SwiGLU MLP.

Pair: ``repro/models/layers.py:1``. Parameters are plain dicts of tensors
with a leading client axis C; activations are (C, B, S, D). Dtype policy
as in the JAX package: parameters fp32, matmuls in ``cfg.dtype`` (bf16 by
default), norm and softmax statistics in fp32, RoPE in fp32 and cast back.

``attention`` runs on kernel K4 (``kernels/flash_attention.py``): the
hand-written CUDA kernels for a CUDA tensor, their plain version for a CPU
tensor. It takes k and v at KV heads, in the JAX package's grouped form
(``q.reshape(B, Sq, KV, G, hd)``, ``layers.py:136``): query head h reads
KV head h // G. One-token decoding (``decode_attention``,
``attn_decode_apply``, ``cross_attn_decode_apply``) is torch ops, as the
JAX package's is plain ``jnp``: the decode steps launch no kernel.
Cross-attention (``attn_apply(kv_source=)``, the encoder-decoder family)
runs on K4 with k and v at the source's length. ``constrain``
(``models/shardctx.py``) places ``DTensor`` activations at the JAX
package's seams and leaves plain tensors unchanged.
"""
from __future__ import annotations

import math

import torch

from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.shardctx import constrain, get_setting
from repro_torch.sharding import (even_split, flat_rows, gather_columns, gather_fsdp, pin_grad,
                                  placed_as)

Params = dict
_NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def cdtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def per_client(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """View a (C, *rest) parameter so it broadcasts against x (C, ..., *rest)."""
    return p.reshape(p.shape[:1] + (1,) * (x.ndim - p.ndim) + p.shape[1:])


# ---------------------------------------------------------------------------
# initializers (one model, no client axis; ``lead`` prepends a layer axis)
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator | None, d_in: int, d_out: int, *,
               scale: float | None = None, lead: tuple = (),
               device: "str | torch.device" = "cpu") -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return torch.randn(lead + (d_in, d_out), generator=gen, device=device) * scale


def embed_init(gen: torch.Generator | None, vocab: int, d: int, *,
               device: "str | torch.device" = "cpu") -> torch.Tensor:
    return torch.randn((vocab, d), generator=gen, device=device) * 0.02


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x (C, ..., D); gamma (C, D)."""
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (y * per_client(gamma, y)).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (S,)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                    # (hd/2,)
    ang = positions[:, None].float() * freqs                   # (S, hd/2)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attn_param_init(gen, cfg, *, lead: tuple = (), device="cpu") -> Params:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    kw = dict(lead=lead, device=device)
    return {
        "wq": dense_init(gen, d, h * hd, **kw),
        "wk": dense_init(gen, d, kv * hd, **kw),
        "wv": dense_init(gen, d, kv * hd, **kw),
        "wo": dense_init(gen, h * hd, d, scale=1.0 / math.sqrt(h * hd), **kw),
    }


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool, window: int = 0) -> torch.Tensor:
    """Softmax attention with causal and sliding-window masking.

    q: (N, Sq, H, hd); k, v: (N, Sk, KV, hd) with H a multiple of KV; Sk
    differs from Sq only without a mask (cross-attention).
    Returns (N, Sq, H, hd) in q's dtype. Scores, softmax statistics and the
    accumulator are fp32; the probabilities are cast to v's dtype before
    the product with v, as in ``repro/models/layers.py:150``.

    On a sharded trace (``DTensor`` inputs) under a ``heads`` spec, k and v
    are repeated to H heads and q, k and v are placed by it, as the JAX
    package's head-sharded layout (``repro/models/layers.py:126-131``): K4
    then takes local heads that pair up whether or not KV divides the model
    axis. Without a ``heads`` spec k and v are placed by ``kv``. Plain
    tensors keep the grouped form, unplaced."""
    if isinstance(q, DTensor):
        if get_setting("heads") is not None:
            q = constrain(q, "heads")
            k = constrain(repeat_kv(k, q.shape[2]), "heads")
            v = constrain(repeat_kv(v, q.shape[2]), "heads")
        else:
            k, v = constrain(k, "kv"), constrain(v, "kv")
    return flash_attention(q, k, v, causal=causal, window=window)


def repeat_kv(k: torch.Tensor, H: int) -> torch.Tensor:
    """(N, S, KV, hd) -> (N, S, H, hd), KV head j repeated as heads
    j * G ... j * G + G - 1 (``jnp.repeat(k, G, axis=2)``)."""
    N, S, KV, hd = k.shape
    if KV == H:
        return k
    return k[:, :, :, None].expand(N, S, KV, H // KV, hd).reshape(N, S, H, hd).contiguous()


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     pos: torch.Tensor, *, ring: bool) -> torch.Tensor:
    """One token's attention against a KV cache (``repro/models/layers.py:179``).

    q (N, 1, H, hd); caches (N, W, KV, hd); ``pos`` () int64 on the
    device, the absolute position of the current token, already written
    into the cache. Under ``ring`` the cache is a ring buffer of the last W
    positions (slot ``pos % W``), else slot i holds position i. Scores are
    fp32 products of the inputs, the probabilities cast to v's dtype
    before the product with v. The two products are batched over (N KV),
    with the window a dimension of its own.

    On ``DTensor``s (a sharded trace) q is first placed as the caches
    (:func:`_decode_layout`), and the output is split over heads rather
    than the head dim, so that (H, hd) merge into the output projection's
    rows without a strided split."""
    N, _, H, hd = q.shape
    W, KV = k_cache.shape[1], k_cache.shape[2]
    if isinstance(q, DTensor):
        q, k_cache, v_cache = _decode_layout(q, k_cache, v_cache)

    def lead(t):  # (N, KV, a, b) -> (N KV, a, b); one row selected, not merged
        # (DTensor's view of merged dimensions misplaces a split window)
        return t[0] if N == 1 else t.reshape((N * KV,) + t.shape[2:])

    qg = lead(q[:, 0].reshape(N, KV, H // KV, hd).float())
    kt = lead(k_cache.float().permute(0, 2, 3, 1))
    s = torch.bmm(qg, kt) * (1.0 / math.sqrt(hd))                        # (N KV, G, W)
    # the mask at the scores' shape: DTensor splits a broadcast operand of
    # ``where`` only at the output's own rank
    s = torch.where(_valid_slots(W, pos, ring, q.device).expand(s.shape), s, _NEG_INF)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype)
    vt = lead(v_cache.permute(0, 2, 1, 3))
    out = torch.bmm(p, vt).reshape(N, 1, H, hd)
    if isinstance(out, DTensor) and Shard(3) in out.placements:
        heads = Shard(2) if H % out.device_mesh.size() == 0 else Replicate()
        out = out.redistribute(out.device_mesh,
                               [heads if p == Shard(3) else p for p in out.placements])
    return out


def _valid_slots(W: int, pos: torch.Tensor, ring: bool, device) -> torch.Tensor:
    """(W,) bool: the cache slots that hold a position up to ``pos``."""
    slots = torch.arange(W, device=device)
    # a ring holds pos + 1 live slots before it wraps, and all W after
    return slots <= (torch.clamp_max(pos, W - 1) if ring else pos)


def _decode_layout(q, k_cache, v_cache):
    """q placed as the caches are, so that one token's scores are local
    to each card: split as their batch (dim 0) and head dim (dim 3; the
    scores then sum over the cards), and as their KV heads (dim 2) where
    each card's query heads read its own (KV dividing the mesh); a cache
    split over its window keeps q whole on that axis (the softmax gathers
    the scores). The caches' KV heads that do not pair up are gathered."""
    mesh, KV = k_cache.device_mesh, k_cache.shape[2]
    qp, kp = [], []
    for p in k_cache.placements:
        if p in (Shard(0), Shard(3)) or (p == Shard(2) and KV % mesh.size() == 0):
            qp.append(p)
            kp.append(p)
        else:
            qp.append(Replicate())
            kp.append(p if p == Shard(1) else Replicate())
    if tuple(kp) != tuple(k_cache.placements):
        k_cache, v_cache = (t.redistribute(mesh, kp) for t in (k_cache, v_cache))
    return q.redistribute(mesh, qp), k_cache, v_cache


def client_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(C, ..., d_in) @ (C, d_in, d_out) -> (C, ..., d_out), one batched product."""
    if isinstance(w, DTensor):
        w = gather_fsdp(w, x, 1)
        x = gather_columns(x, w)
    if isinstance(x, DTensor):
        x = flat_rows(x)
    C = x.shape[0]
    y = torch.bmm(x.reshape(C, -1, x.shape[-1]), w)
    return pin_grad(y.reshape(x.shape[:-1] + (w.shape[-1],)))


def attn_apply(x: torch.Tensor, p: Params, cfg, *, causal: bool = True,
               window: int | None = None, kv_source: torch.Tensor | None = None,
               use_rope: bool = True) -> torch.Tensor:
    """Full-sequence attention, x (C, B, S, D) (``repro/models/layers.py:213``).
    ``kv_source`` (C, B, Sk, D) makes it cross-attention: k and v are
    projected from the source at its own length, with no RoPE and no mask.
    Self-attention applies RoPE when ``use_rope``."""
    C, B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    dt = cdtype(cfg)
    xv = x.to(dt)
    src = xv if kv_source is None else kv_source.to(dt)
    Sk = src.shape[2]
    H, KV = cfg.n_heads, cfg.n_kv_heads
    # (a sharded trace's views are pinned: their gradients come back placed
    # as their values, which DTensor can view back)
    q = pin_grad(even_split(client_mm(xv, p["wq"].to(dt)), -1, H).reshape(C * B, S, H, hd))
    k = pin_grad(even_split(client_mm(src, p["wk"].to(dt)), -1, KV).reshape(C * B, Sk, KV, hd))
    v = pin_grad(even_split(client_mm(src, p["wv"].to(dt)), -1, KV).reshape(C * B, Sk, KV, hd))
    if use_rope and kv_source is None:
        pos = torch.arange(S, device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    w = cfg.window if window is None else window
    out = even_split(attention(q, k, v, causal=causal and kv_source is None, window=w or 0), 2, H)
    return client_mm(pin_grad(out.reshape(C, B, S, -1)), p["wo"].to(dt)).to(x.dtype)


def attn_decode_apply(x: torch.Tensor, p: Params, cfg, cache: Params, pos: torch.Tensor, *,
                      ring: bool) -> tuple[torch.Tensor, Params]:
    """One-token self-attention, x (C, B, 1, D) (``repro/models/layers.py:245``).
    Writes the token's k and v into slot ``pos`` of the cache's k and v
    (C, B, W, KV, hd) in place (``pos % W`` under ``ring``) and returns
    (y, the cache)."""
    C, B = x.shape[:2]
    hd = cfg.resolved_head_dim
    dt = cdtype(cfg)
    xv = x.to(dt)

    def proj(w):
        # serve presets: the projection stays sharded as the weights, then
        # the one-token q, k, v reshard (``repro/models/layers.py:260-268``)
        y = client_mm(xv, w.to(dt))
        y = even_split(y, -1, y.shape[-1] // hd).reshape(C * B, 1, -1, hd)
        return constrain(constrain(y, "dec_qkv_pre"), "dec_qkv")

    q = apply_rope(proj(p["wq"]), pos.view(1), cfg.rope_theta)
    k = apply_rope(proj(p["wk"]), pos.view(1), cfg.rope_theta)
    v = proj(p["wv"])
    W = cache["k"].shape[2]
    slot = (pos % W if ring else pos).view(1)
    for name, t in (("k", k), ("v", v)):
        cache[name] = write_cache_slot(cache[name], slot, t.reshape(C, B, 1, -1, hd))
    out = decode_attention(q, _client_rows(cache["k"]), _client_rows(cache["v"]), pos, ring=ring)
    return client_mm(out.reshape(C, B, 1, -1), p["wo"].to(dt)).to(x.dtype), cache


def write_cache_slot(cache: torch.Tensor, slot: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``t`` (C, B, 1, KV, hd) written into slot ``slot`` (1,) of ``cache``
    (C, B, W, KV, hd), in place; returns the cache. A ``DTensor`` cache
    split over its window is written by a masked ``where`` instead, each
    card writing the slot if it holds it (DTensor's in-place
    ``index_copy_`` into a split index dimension would relabel the cache's
    placements, not move it); into any other ``DTensor`` cache ``t`` is
    first placed as the cache, so that the write keeps the cache where it
    is (the op's sharding rule: ``launch/sharded.py``)."""
    t = t.to(cache.dtype)
    if isinstance(cache, DTensor):
        if Shard(2) in cache.placements:
            W = cache.shape[2]
            hit = (torch.arange(W, device=t.device) == slot).reshape(1, 1, W, 1, 1)
            return torch.where(hit.expand(cache.shape), t.expand(cache.shape), cache)
        t = placed_as(t, cache)
    return cache.index_copy_(2, slot, t)


def _client_rows(t: torch.Tensor) -> torch.Tensor:
    """(C, B, ...) -> (C * B, ...); one client's ``DTensor`` by selecting it
    (DTensor's view of two merged dimensions of length 1 misplaces a split
    of the next one)."""
    if isinstance(t, DTensor) and t.shape[0] == 1:
        return t[0]
    return t.reshape((-1,) + t.shape[2:])


def cross_attn_decode_apply(x: torch.Tensor, p: Params, cfg, xk: torch.Tensor,
                            xv: torch.Tensor) -> torch.Tensor:
    """One token's cross-attention, x (C, B, 1, D), over the keys and values
    precomputed from the encoder's output, xk and xv (C, B, P, KV, hd)
    (``repro/models/layers.py:285``): ``decode_attention`` with every slot
    valid (``pos = P - 1`` on the device), no RoPE."""
    C, B = x.shape[:2]
    hd = cfg.resolved_head_dim
    dt = cdtype(cfg)
    P = xk.shape[2]
    q = even_split(client_mm(x.to(dt), p["wq"].to(dt)), -1, cfg.n_heads).reshape(
        C * B, 1, cfg.n_heads, hd)
    pos = torch.full((), P - 1, dtype=torch.int64, device=x.device)
    out = decode_attention(q, xk.reshape((C * B,) + xk.shape[2:]).to(dt),
                           xv.reshape((C * B,) + xv.shape[2:]).to(dt), pos, ring=False)
    return client_mm(out.reshape(C, B, 1, -1), p["wo"].to(dt)).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU)
# ---------------------------------------------------------------------------

def mlp_param_init(gen, d: int, f: int, *, lead: tuple = (), device="cpu") -> Params:
    kw = dict(lead=lead, device=device)
    return {
        "w1": dense_init(gen, d, f, **kw),
        "w3": dense_init(gen, d, f, **kw),
        "w2": dense_init(gen, f, d, **kw),
    }


class _Silu(torch.autograd.Function):
    """``jax.nn.silu`` forward and backward in the JAX package's op order,
    each step rounded to x's dtype: s = 1 / (1 + exp(-x)), y = x * s, and
    the gradient g * s + (g * x) * (s * (1 - s)), the transpose of
    ``x * logistic(x)``. PyTorch's fused silu rounds once, and autograd of
    the forward's ops rounds a chain of its own: in bf16 both give other
    bits, the latter in most elements of the gradient."""

    @staticmethod
    def forward(ctx, x):
        s = 1.0 / (1.0 + torch.exp(-x))
        ctx.save_for_backward(x, s)
        return x * s

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        return g * s + (g * x) * (s * (1.0 - s))


def silu(x: torch.Tensor) -> torch.Tensor:
    return _Silu.apply(x)


def mlp_apply(x: torch.Tensor, p: Params, cfg) -> torch.Tensor:
    dt = cdtype(cfg)
    h = x.to(dt)
    up = silu(client_mm(h, p["w1"].to(dt))) * client_mm(h, p["w3"].to(dt))
    return client_mm(up, p["w2"].to(dt)).to(x.dtype)
