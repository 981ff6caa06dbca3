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
one per forward (the Gram of the upper triangle, split over F, with its
last block summing the splits and applying the distance epilogue), one per
backward, and one more forward launch whenever the forward's counter
buffer is allocated and zeroed (once per device, more only for a larger
grid). ``SHAPES`` counts the Gram launches by their (C, B, F),
``BACKWARD_SHAPES`` the backward's launches by the same key.

The forward's counters are shared by its launches on a device, and each
launch leaves them zero: the port runs K2 on one stream at a time.
"""
from __future__ import annotations

import ctypes
from collections import Counter
from typing import NamedTuple

import torch

from repro_torch.kernels import nvcc
from repro_torch.kernels.ref import pairwise_dist_bwd_ref, pairwise_dist_ref

LAUNCHES = {"forward": 0, "backward": 0}
SHAPES: Counter = Counter()
BACKWARD_SHAPES: Counter = Counter()
_LIB: ctypes.CDLL | None = None

MAX_B = 255 * 32          # kMaxB in the source
STAGE_FLOATS = 8192       # a ring stage of the source (kStageFloats): 32 KB of x
CROSS_TILE = 16           # forward rows per tile when B > 32 (kCrossTile)
WARPS = 8                 # warps a forward block (kFwdThreads / 32)
# forward blocks an SM on the H100 by staged rows (B > 32: CROSS_TILE * 2),
# as CUDA's occupancy calculator gives them for the build's registers and
# the 96 KB ring; the grid is planned from them on the card as on the CPU,
# and chip_smoke.py's build report fails if the card's differ
BLOCKS_PER_SM = {4: 2, 8: 2, 16: 1, 32: 1, 2 * CROSS_TILE: 1}
H100_SMS = 132


class ForwardPlan(NamedTuple):
    """The forward's grid for x (C, B, F); mirrors ``Fwd<kMode>`` in the source."""
    tile: int            # rows a tile: 4, 8, 16 or 32 (B <= tile), or CROSS_TILE
    pairs: int           # tile pairs ti <= tj a client (1 when B <= 32)
    kt: int              # columns of x a ring stage
    warps_per_task: int  # warps that split one register micro-tile's columns
    entries: int         # Gram entries a tile pair computes
    chunk: int           # columns a split: a multiple of kt
    splits: int          # ceil(F / chunk)

    @property
    def blocks(self) -> int:
        return self.pairs * self.splits

    @property
    def ws_row(self) -> int:
        """A block's partial Gram in the workspace: the entries, rounded up
        to 16 bytes (kWsRow)."""
        return -(-self.entries // 4) * 4


# mode (tile) -> (warp tasks, entries): B = 32 is six 8 x 8 blocks and two
# pairs of triangles, 16 one block and one pair, 8 and 4 one triangle;
# B > 32 four 8 x 8 blocks a 16-row tile pair
_TASKS = {4: (1, 10), 8: (1, 36), 16: (2, 64 + 72), 32: (8, 6 * 64 + 2 * 72)}
_CROSS_TASKS = (4, 4 * 64)


def forward_plan(C: int, B: int, F: int, sms: int = H100_SMS) -> ForwardPlan:
    """Tile by B, and split F so that the grid is at most one wave of
    ``sms * BLOCKS_PER_SM`` blocks (never fewer than one split a pair)."""
    tile = next((t for t in (4, 8, 16, 32) if B <= t), CROSS_TILE)
    rows = tile if B <= 32 else 2 * CROSS_TILE          # rows a stage
    tasks, entries = _TASKS[tile] if B <= 32 else _CROSS_TASKS
    kt = STAGE_FLOATS // rows
    T = -(-B // tile)
    pairs = T * (T + 1) // 2 if B > 32 else 1
    stages = -(-F // kt)                                # stages a pair
    # at most one wave when the pairs fit in one: splits rounded down
    splits = max(1, min(stages, sms * BLOCKS_PER_SM[rows] // (C * pairs)))
    chunk = -(-stages // splits) * kt
    return ForwardPlan(tile, pairs, kt, WARPS // tasks, entries, chunk, -(-F // chunk))


_COUNTERS: dict[int, torch.Tensor] = {}
_RETIRED: list[torch.Tensor] = []   # outgrown buffers a captured graph may still use


def _counters(device: torch.device, n: int) -> torch.Tensor:
    """The forward's zeroed int32 counters on ``device``, at least ``n``."""
    buf = _COUNTERS.get(device.index)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("pairwise_dist: call the forward once at this shape before "
                               "capturing it in a CUDA graph (its counters are allocated "
                               "outside the graph)")
        if buf is not None:
            _RETIRED.append(buf)
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        LAUNCHES["forward"] += 1   # the zero fill
        _COUNTERS[device.index] = buf
    return buf


def load_library() -> ctypes.CDLL:
    """Build (once) and load the kernels' shared library."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(nvcc.build("pairwise_dist")))
        ll, vp = ctypes.c_longlong, ctypes.c_void_p
        lib.pairwise_dist_forward.argtypes = [vp, vp, vp, ll, vp, ll, ll, ll, ll, ll, ll, vp]
        lib.pairwise_dist_forward.restype = ctypes.c_int
        lib.pairwise_dist_backward.argtypes = [vp, vp, vp, vp, ll, ll, ll, vp]
        lib.pairwise_dist_backward.restype = ctypes.c_int
        lib.pairwise_dist_blocks_per_sm.argtypes = [ctypes.c_int, ll, ctypes.POINTER(ctypes.c_int)]
        lib.pairwise_dist_blocks_per_sm.restype = ctypes.c_int
        lib.pairwise_dist_error.argtypes = [ctypes.c_int]
        lib.pairwise_dist_error.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def blocks_per_sm(device: torch.device, B: int, backward: bool = False) -> int:
    """Blocks of the kernel for this B that fit on one SM of ``device`` at
    once, by CUDA's occupancy calculator (``chip_smoke.py`` holds the
    forward's to ``BLOCKS_PER_SM``)."""
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        _raise_on(load_library().pairwise_dist_blocks_per_sm(int(backward), B, ctypes.byref(n)),
                  "occupancy")
    return n.value


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
    plan = forward_plan(C, B, F, torch.cuda.get_device_properties(x.device).multi_processor_count)
    with torch.cuda.device(x.device):
        out = torch.empty((C, B, B), dtype=torch.float32, device=x.device)
        ws = torch.empty(C * plan.blocks * plan.ws_row, dtype=torch.float32, device=x.device)
        cnt = _counters(x.device, C * (plan.pairs + (plan.pairs > 1)))
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.pairwise_dist_forward(x.data_ptr(), out.data_ptr(), ws.data_ptr(), ws.numel(),
                                        cnt.data_ptr(), cnt.numel(), C, B, F, plan.chunk,
                                        plan.splits, stream)
    _raise_on(err, "forward")
    LAUNCHES["forward"] += 1  # pdist_fwd
    SHAPES[(C, B, F)] += 1
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
    LAUNCHES["backward"] += 1  # pdist_bwd
    BACKWARD_SHAPES[(C, B, F)] += 1
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
