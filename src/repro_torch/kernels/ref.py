"""Plain PyTorch versions of the port's kernels (pair: ``repro/kernels/ref.py``).

Each function repeats its kernel's arithmetic in torch ops. The kernel
wrappers use them for tensors on the CPU; on the card they are what a
kernel is held against.
"""
from __future__ import annotations

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
