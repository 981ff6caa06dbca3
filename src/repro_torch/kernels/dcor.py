"""K2: pairwise Euclidean distances within each client, with a backward.

Pair: ``repro/kernels/dcor.py:28`` (``pairwise_dist``, a Pallas kernel on
one (B, F) matrix; body ``_dist_kernel`` at ``:17``). The JAX package
trains through the jnp ``privacy._pairwise_dist`` and autodiff, since the
Pallas kernel has no VJP; here the kernel is the only path on the card,
so ``PairwiseDist`` carries a backward kernel of its own.

``pairwise_dist(x)`` takes ``x`` of shape (C, B, F), fp32, contiguous, and
returns (C, B, B) fp32, differentiable w.r.t. ``x``. A CUDA tensor goes to
the hand-written kernels (``csrc/pairwise_dist.cu``, built by ``nvcc`` at
first use); a CPU tensor goes to the plain versions
``kernels/ref.py::pairwise_dist_ref`` and ``pairwise_dist_bwd_ref``.
Anything else raises. ``LAUNCHES`` counts kernel launches on the device:
two per forward (the split-K partial Grams, then their fixed-order sum
with the distance epilogue), one per backward.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import nvcc
from repro_torch.kernels.ref import pairwise_dist_bwd_ref, pairwise_dist_ref

LAUNCHES = {"forward": 0, "backward": 0}
_LIB: ctypes.CDLL | None = None

CHUNK_ALIGN = 64          # columns of x staged per step (kKT in the source)
TILE = 32                 # rows per Gram tile (kTile)
MAX_B = 255 * TILE        # tile pairs must fit the grid's y dimension
# about 5 blocks for each of the H100's 132 SMs: 3 to 5 blocks of 256
# threads fit on one at the 44-68 registers a thread ptxas reports
TARGET_BLOCKS = 5 * 132


def load_library() -> ctypes.CDLL:
    """Build (once) and load the kernels' shared library."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(nvcc.build("pairwise_dist")))
        ll, vp = ctypes.c_longlong, ctypes.c_void_p
        lib.pairwise_dist_forward.argtypes = [vp, vp, vp, ll, ll, ll, ll, vp]
        lib.pairwise_dist_forward.restype = ctypes.c_int
        lib.pairwise_dist_backward.argtypes = [vp, vp, vp, vp, ll, ll, ll, vp]
        lib.pairwise_dist_backward.restype = ctypes.c_int
        lib.pairwise_dist_error.argtypes = [ctypes.c_int]
        lib.pairwise_dist_error.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def split_chunk(C: int, B: int, F: int) -> int:
    """Columns of F per block of the forward's first kernel: a multiple of
    ``CHUNK_ALIGN``, small enough that about ``TARGET_BLOCKS`` blocks fill
    the card. The number of splits is ``ceil(F / chunk)``."""
    tiles = -(-B // TILE)
    splits = max(1, -(-TARGET_BLOCKS // (C * tiles * tiles)))
    per = -(-F // splits)
    return max(CHUNK_ALIGN, -(-per // CHUNK_ALIGN) * CHUNK_ALIGN)


def _check(x: torch.Tensor) -> None:
    if x.ndim != 3:
        raise ValueError(f"pairwise_dist takes (C, B, F), got shape {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"pairwise_dist takes float32 (cast in the caller), got {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"pairwise_dist: unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("pairwise_dist needs a contiguous tensor")
    C, B, F = x.shape
    if C and B and F == 0:
        raise ValueError("pairwise_dist needs F >= 1")
    if B > MAX_B:
        raise ValueError(f"pairwise_dist takes B <= {MAX_B}, got {B}")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = load_library().pairwise_dist_error(err).decode()
        raise RuntimeError(f"pairwise_dist {what} launch failed: {msg} (cudaError {err})")


def dist_forward(x: torch.Tensor) -> torch.Tensor:
    """The forward, without autograd: (C, B, F) -> (C, B, B)."""
    _check(x)
    if x.device.type == "cpu":
        return pairwise_dist_ref(x)
    C, B, F = x.shape
    if C == 0 or B == 0:
        return x.new_empty((C, B, B))
    lib = load_library()
    chunk = split_chunk(C, B, F)
    splits = -(-F // chunk)
    with torch.cuda.device(x.device):
        out = torch.empty((C, B, B), dtype=torch.float32, device=x.device)
        ws = torch.empty((C, B, B, splits), dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.pairwise_dist_forward(x.data_ptr(), out.data_ptr(), ws.data_ptr(),
                                        C, B, F, chunk, stream)
    _raise_on(err, "forward")
    LAUNCHES["forward"] += 2  # gram_partial, then gram_finish
    return out


def dist_backward(x: torch.Tensor, dist: torch.Tensor, g_dist: torch.Tensor) -> torch.Tensor:
    """The gradient w.r.t. ``x`` of ``sum(g_dist * D)``, ``D = dist_forward(x)``;
    all three contiguous fp32 on one device."""
    _check(x)
    for t in (dist, g_dist):
        if t.shape != (x.shape[0], x.shape[1], x.shape[1]) or t.dtype != torch.float32:
            raise ValueError(f"pairwise_dist backward takes (C, B, B) fp32 distances and "
                             f"cotangents, got {tuple(t.shape)} {t.dtype}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("pairwise_dist backward needs contiguous tensors on x's device")
    if x.device.type == "cpu":
        return pairwise_dist_bwd_ref(x, dist, g_dist)
    C, B, F = x.shape
    gx = torch.empty_like(x)
    if C == 0 or B == 0:
        return gx
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.pairwise_dist_backward(x.data_ptr(), dist.data_ptr(), g_dist.data_ptr(),
                                         gx.data_ptr(), C, B, F, stream)
    _raise_on(err, "backward")
    LAUNCHES["backward"] += 1  # the dist_backward kernel
    return gx


class PairwiseDist(torch.autograd.Function):
    """(C, B, F) -> (C, B, B) distances; the backward is K2's second kernel."""

    @staticmethod
    def forward(ctx, x):
        dist = dist_forward(x)
        ctx.save_for_backward(x, dist)
        return dist

    @staticmethod
    def backward(ctx, g_dist):
        x, dist = ctx.saved_tensors
        return dist_backward(x, dist, g_dist.contiguous())


def pairwise_dist(x: torch.Tensor) -> torch.Tensor:
    """Euclidean distances within each client: (C, B, F) fp32 -> (C, B, B),
    differentiable w.r.t. ``x``."""
    return PairwiseDist.apply(x)
