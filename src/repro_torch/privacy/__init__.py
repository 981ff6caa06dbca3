"""Privacy add-ons (paper §4.4; pair: ``repro/privacy/__init__.py``).

* ``dcor(x, z)`` — the (biased) sample distance correlation between a
  client's raw inputs and its intermediate representation, for the
  regularizer ``(1-a)·task_loss + a·DCor(x, z)`` (Vepakomma et al. 2020).
  Over a leading client axis: one value per client, the JAX function under
  ``vmap``. The pairwise distances are kernel K2
  (``kernels/dcor.py::pairwise_dist``, forward and backward).
* ``patch_shuffle`` — permutes contiguous chunks of the activations along
  their token/spatial axis before upload (Yao et al. 2022).

Degenerate inputs: a constant input must give exactly 0.0 with a finite
gradient. Here that holds by construction, not by the sign of rounding
noise: the centering means are accumulated in float64, so a constant
distance matrix (every distance the clamp floor, as the kernel gives for
identical rows) centers to exactly zero, and the square roots of the ratio
sit behind double ``where``s, so no ``0 * inf`` reaches the gradient.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.dcor import pairwise_dist


def _rows(t: torch.Tensor) -> torch.Tensor:
    """(C, B, ...) -> (C, B, F) fp32, contiguous: each sample flattened."""
    return t.reshape(t.shape[0], t.shape[1], -1).float().contiguous()


def _center(d: torch.Tensor) -> torch.Tensor:
    """Double centering of (C, B, B) distances, in the JAX op order
    ``d - mean_rows - mean_cols + mean``; the means are exact for a
    constant matrix (float64 sums, rounded once to fp32)."""
    dd = d.double()
    m0 = dd.mean(dim=1, keepdim=True).float()
    m1 = dd.mean(dim=2, keepdim=True).float()
    m = dd.mean(dim=(1, 2), keepdim=True).float()
    return d - m0 - m1 + m


def _safe_dcor_ratio(dcov2: torch.Tensor, dvar_prod: torch.Tensor) -> torch.Tensor:
    """``sqrt(dcov2 / sqrt(dvar_x * dvar_z))``, 0 where independent
    (``dcov2 <= 0``) or a variance is zero; ``repro/privacy/__init__.py:38``
    with its ``sqrt(max(p, 0))`` behind a double ``where`` as well: torch's
    sqrt at 0 gives an infinite derivative, which a zero cotangent turns
    into NaN."""
    pos = dvar_prod > 0.0
    den = torch.where(pos, torch.sqrt(torch.where(pos, dvar_prod, 1.0)), 0.0)
    ratio = torch.where(den > 0.0,
                        torch.clamp_min(dcov2, 0.0) / torch.clamp_min(den, 1e-30), 0.0)
    safe = ratio > 0.0
    return torch.where(safe, torch.sqrt(torch.where(safe, ratio, 1.0)), 0.0)


def dcor(x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Distance correlation in [0, 1] per client: x (C, B, ...), z (C, B,
    ...) -> (C,). Axis 1 is the batch; the rest of each sample is flattened."""
    a = _center(pairwise_dist(_rows(x)))
    b = _center(pairwise_dist(_rows(z)))
    dcov2 = (a * b).mean(dim=(1, 2))
    dvar_x = (a * a).mean(dim=(1, 2))
    dvar_z = (b * b).mean(dim=(1, 2))
    return _safe_dcor_ratio(dcov2, dvar_x * dvar_z)


def _patch_count(s: int, n: int) -> int:
    """The largest patch count <= ``n`` that divides ``s``."""
    p = n
    while s % p:
        p -= 1
    return p


def patch_shuffle_perm(z: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Permute the chunks of axis 2 of ``z`` (C, B, S, ...) by ``perm`` (C,
    p): client c's chunk ``perm[c, k]`` lands at position k, as
    ``zs[:, perm]`` does in the JAX function."""
    C, B, S = z.shape[:3]
    p = perm.shape[1]
    zs = z.reshape(C, B, p, S // p, *z.shape[3:])
    idx = perm.to(z.device).reshape(C, 1, p, *([1] * (zs.ndim - 3)))
    return torch.gather(zs, 2, idx.expand(zs.shape)).reshape(z.shape)


def patch_shuffle(gen: torch.Generator, z: torch.Tensor, n_patches: int = 16) -> torch.Tensor:
    """Shuffle contiguous chunks of ``z`` (C, B, S, ...) along axis 2, with
    one permutation per client drawn from ``gen``."""
    p = _patch_count(z.shape[2], n_patches)
    perm = torch.stack([torch.randperm(p, generator=gen, device=gen.device)
                        for _ in range(z.shape[0])])
    return patch_shuffle_perm(z, perm)
