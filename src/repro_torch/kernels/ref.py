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
