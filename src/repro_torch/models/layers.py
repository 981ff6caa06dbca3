"""Core transformer layers: norms, RoPE, GQA attention, SwiGLU MLP.

Pair: ``repro/models/layers.py:1``. Parameters are plain dicts of tensors
with a leading client axis C; activations are (C, B, S, D). Dtype policy
as in the JAX package: parameters fp32, matmuls in ``cfg.dtype`` (bf16 by
default), norm and softmax statistics in fp32, RoPE in fp32 and cast back.

``attention`` runs on kernel K4 (``kernels/flash_attention.py``): the
hand-written CUDA kernels for a CUDA tensor, their plain version for a CPU
tensor. It takes k and v at KV heads, in the JAX package's grouped form
(``q.reshape(B, Sq, KV, G, hd)``, ``layers.py:136``): query head h reads
KV head h // G. Decode, cross-attention and the sharding context come with
the serving path; one device needs no ``constrain``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention

Params = dict


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

    q: (N, S, H, hd); k, v: (N, S, KV, hd) with H a multiple of KV.
    Returns (N, S, H, hd) in q's dtype. Scores, softmax statistics and the
    accumulator are fp32; the probabilities are cast to v's dtype before
    the product with v, as in ``repro/models/layers.py:150``."""
    return flash_attention(q, k, v, causal=causal, window=window)


def client_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(C, ..., d_in) @ (C, d_in, d_out) -> (C, ..., d_out), one batched product."""
    C = x.shape[0]
    y = torch.bmm(x.reshape(C, -1, x.shape[-1]), w)
    return y.reshape(x.shape[:-1] + (w.shape[-1],))


def attn_apply(x: torch.Tensor, p: Params, cfg, *, causal: bool = True,
               window: int | None = None) -> torch.Tensor:
    """Full-sequence self-attention. x (C, B, S, D)."""
    C, B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    dt = cdtype(cfg)
    xv = x.to(dt)
    q = client_mm(xv, p["wq"].to(dt)).reshape(C * B, S, cfg.n_heads, hd)
    k = client_mm(xv, p["wk"].to(dt)).reshape(C * B, S, cfg.n_kv_heads, hd)
    v = client_mm(xv, p["wv"].to(dt)).reshape(C * B, S, cfg.n_kv_heads, hd)
    pos = torch.arange(S, device=x.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    w = cfg.window if window is None else window
    out = attention(q, k, v, causal=causal, window=w or 0)
    return client_mm(out.reshape(C, B, S, -1), p["wo"].to(dt)).to(x.dtype)


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


def mlp_apply(x: torch.Tensor, p: Params, cfg) -> torch.Tensor:
    dt = cdtype(cfg)
    h = x.to(dt)
    up = F.silu(client_mm(h, p["w1"].to(dt))) * client_mm(h, p["w3"].to(dt))
    return client_mm(up, p["w2"].to(dt)).to(x.dtype)
