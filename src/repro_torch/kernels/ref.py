"""Plain PyTorch versions of the port's kernels (pair: ``repro/kernels/ref.py``).

Each function repeats its kernel's arithmetic in torch ops. The kernel
wrappers use them for tensors on the CPU; on the card they are what a
kernel is held against.
"""
from __future__ import annotations

import math

import torch


def int8_roundtrip_ref(x: torch.Tensor) -> torch.Tensor:
    """Int8 quantize/dequantize of ``x`` (R, n) with one scale per row.

    Row-wise form of ``repro/kernels/ref.py:63`` (``int8_roundtrip_ref``,
    one scale per tensor) in the same op order:
    ``s = max(max|x|, 1e-12) / 127``, ``clip(round(x / s), -127, 127) * s``,
    computed in fp32 and returned in ``x``'s dtype. ``torch.round`` rounds
    half to even like ``jnp.round``."""
    xf = x.float()
    amax = torch.clamp_min(xf.abs().amax(dim=1, keepdim=True), 1e-12)
    # divide by a tensor: on CUDA, dividing by a Python scalar becomes a
    # multiply by its reciprocal, which is not the IEEE quotient
    s = amax / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(xf / s), -127.0, 127.0)
    return (q * s).to(x.dtype)


# the clamp of the squared distances, and the distance it leaves behind:
# sqrt(max(d2, D2_MIN)) equals D_MIN exactly where d2 <= D2_MIN
D2_MIN = 1e-12
D_MIN = float(torch.sqrt(torch.tensor(D2_MIN, dtype=torch.float32)))


def pairwise_dist_ref(x: torch.Tensor) -> torch.Tensor:
    """Euclidean distances within each client: (C, B, F) -> (C, B, B), fp32.

    ``repro/privacy/__init__.py:18`` (``_pairwise_dist``) and
    ``repro/kernels/ref.py:55`` over a leading client axis, in the same op
    order: ``sq = sum(x*x)``, ``d2 = sq_i + sq_j - 2 x x^T``,
    ``sqrt(max(d2, 1e-12))``."""
    x = x.float()
    sq = torch.sum(x * x, dim=-1)
    d2 = sq[:, :, None] + sq[:, None, :] - 2.0 * torch.bmm(x, x.transpose(1, 2))
    return torch.sqrt(torch.clamp_min(d2, D2_MIN))


def pairwise_dist_bwd_ref(x: torch.Tensor, dist: torch.Tensor,
                          g_dist: torch.Tensor) -> torch.Tensor:
    """Gradient of ``sum(g_dist * pairwise_dist(x))`` w.r.t. ``x`` (C, B, F).

    With ``H = 0.5 g / D`` where the clamp let ``d2`` through (``D > D_MIN``;
    0 elsewhere, so a tie at the clamp routes no gradient) and ``S = H +
    H^T``, the gradient is ``2 (diag(rowsum S) - S) x``. The diagonal of
    ``H`` is dropped: its ``sq`` and cross terms cancel exactly
    (``+4 H_ii x_i - 4 H_ii x_i``), where autodiff leaves their rounding."""
    x = x.float()
    eye = torch.eye(dist.shape[-1], dtype=torch.bool, device=dist.device)
    h = torch.where((dist > D_MIN) & ~eye, 0.5 * g_dist / dist, torch.zeros_like(dist))
    s = h + h.transpose(1, 2)
    w = torch.diag_embed(s.sum(dim=-1)) - s
    return 2.0 * torch.bmm(w, x)


def fused_xent_ref(logits: torch.Tensor, labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token cross-entropy: logits (T, V), labels (T,) -> (loss, lse),
    both (T,) fp32.

    ``repro/kernels/ref.py:72`` (``fused_xent_ref``) and
    ``repro/core/local_loss.py:27`` (``token_xent``'s per-token term) in the
    same op order: ``lse = logsumexp(x)`` in fp32, ``loss = lse - x[label]``;
    lse is kept for the backward."""
    x = logits.float()
    lse = torch.logsumexp(x, dim=-1)
    picked = torch.gather(x, -1, labels.long()[:, None])[:, 0]
    return lse - picked, lse


def fused_xent_bwd_ref(logits: torch.Tensor, labels: torch.Tensor, lse: torch.Tensor,
                       g: torch.Tensor) -> torch.Tensor:
    """Gradient of ``sum(g * loss)`` w.r.t. ``logits`` (T, V), in the logits'
    dtype: ``g_t (exp(x - lse_t) - [v == label_t])``, computed in fp32."""
    p = torch.exp(logits.float() - lse[:, None])
    hit = torch.zeros_like(p).scatter_(1, labels.long()[:, None], 1.0)
    return (g[:, None] * (p - hit)).to(logits.dtype)


def _visible(S: int, causal: bool, window: int, device) -> torch.Tensor:
    """(S, S) bool: query i may attend to key j."""
    qpos = torch.arange(S, device=device)[:, None]
    kpos = torch.arange(S, device=device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= qpos - kpos < window
    return mask


def _grouped(t: torch.Tensor, kv: int) -> torch.Tensor:
    """(N, S, H, hd) -> (N, S, KV, G, hd) fp32: query head h = kv * G + g."""
    N, S, H, hd = t.shape
    return t.float().reshape(N, S, kv, H // kv, hd)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                  window: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Flash attention's function, materialized: q (N, S, H, hd), k and v
    (N, S, KV, hd) -> (o (N, S, H, hd) in q's dtype, lse (N, H, S) fp32).

    The Pallas kernel's arithmetic (``repro/kernels/flash_attention.py:29``)
    without the blocking: fp32 scores ``q.k * (1 / sqrt(hd))``, masked;
    ``p = exp(s - rowmax)``, ``l = sum p``; ``o = (p cast to v's dtype) @ v
    / max(l, 1e-30)``; ``lse = rowmax + log(max(l, 1e-30))``. Heads are
    grouped as ``repro/models/layers.py:136``: query head h reads KV head
    h // (H / KV)."""
    N, S, H, hd = q.shape
    KV = k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("nqkgd,nskd->nkgqs", _grouped(q, KV), k.float()) * scale
    vis = _visible(S, causal, window, q.device)
    s = torch.where(vis, s, -torch.inf)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(vis, torch.exp(s - m), 0.0)
    l = torch.clamp_min(p.sum(dim=-1, keepdim=True), 1e-30)
    acc = torch.einsum("nkgqs,nskd->nkgqd", p.to(v.dtype).float(), v.float())
    o = (acc / l).permute(0, 3, 1, 2, 4).reshape(N, S, H, hd).to(q.dtype).contiguous()
    lse = (m + torch.log(l)).reshape(N, H, S)
    return o, lse


def attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool, window: int = 0):
    """FlashAttention-2's backward of :func:`attention_ref` on the same
    inputs, materialized: ``D = rowsum(dO * O)``, ``P = exp(s - lse)``,
    ``dV = (P cast to v's dtype)^T dO``, ``dS = P (dO V^T - D)``,
    ``dQ = scale dS K``, ``dK = scale dS^T Q``, dK and dV summed over the
    G query heads of each KV head. Returns (dq, dk, dv) in the inputs'
    dtypes."""
    N, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    qg, dog = _grouped(q, KV), _grouped(do, KV)
    kf, vf = k.float(), v.float()
    D = (do.float() * o.float()).sum(-1).reshape(N, S, KV, G).permute(0, 2, 3, 1)
    s = torch.einsum("nqkgd,nskd->nkgqs", qg, kf) * scale
    vis = _visible(S, causal, window, q.device)
    p = torch.where(vis, torch.exp(s - lse.reshape(N, KV, G, S)[..., None]), 0.0)
    dv = torch.einsum("nkgqs,nqkgd->nskd", p.to(v.dtype).float(), dog)
    dp = torch.einsum("nqkgd,nskd->nkgqs", dog, vf)
    ds = p * (dp - D[..., None])
    dq = torch.einsum("nkgqs,nskd->nqkgd", ds, kf) * scale
    dk = torch.einsum("nkgqs,nqkgd->nskd", ds, qg) * scale
    return dq.reshape(N, S, H, hd).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
