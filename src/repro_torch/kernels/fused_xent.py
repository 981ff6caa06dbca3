"""K3: fused per-token cross-entropy, with a backward.

Pair: ``repro/kernels/fused_xent.py:62`` (``fused_xent``, a Pallas kernel;
body ``_xent_kernel`` at ``:26``). The JAX package trains through the jnp
``core/local_loss.py::token_xent`` and autodiff; here every ``token_xent``
on the card goes through these kernels, so ``FusedXent`` carries a
backward kernel of its own.

``fused_xent(logits, labels)`` takes logits (T, V) fp32 or bf16 and labels
(T,) of any integer dtype, and returns the per-token loss (T,) fp32,
differentiable w.r.t. ``logits``. Any T and V, and any row alignment: each
row streams its 16-byte vectors between an element-wise head and tail. A
CUDA tensor goes to the hand-written kernels (``csrc/fused_xent.cu``, built
by ``nvcc`` at first use); a CPU tensor goes to the plain versions
``kernels/ref.py::fused_xent_ref`` and ``fused_xent_bwd_ref``. Anything
else raises. Both kernels run on the launch shape that :func:`geometry`
picks from (T, V), the element size and the card's SM count: threads a
row (split over up to 8 warps at small T, packed several rows a warp at
small V) and blocks. The backward writes dlogits at the logits' offset
from a 16-byte boundary, so both share the row's cut. ``LAUNCHES``
counts kernel launches on the device: one per forward, one per backward.
``SHAPES`` holds each forward launch's (T, V, dtype); a backward runs at
its forward's.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import nvcc
from repro_torch.kernels.ref import fused_xent_bwd_ref, fused_xent_ref

LAUNCHES = {"forward": 0, "backward": 0}
SHAPES: set[tuple] = set()
_LIB: ctypes.CDLL | None = None
DTYPES = (torch.float32, torch.bfloat16)
THREADS = 256          # a block of either kernel (kThreads in the source)
FILL = 1024            # threads an SM that keep its share of the memory rate fed
MIN_VECTORS = 8        # 16-byte vectors a thread keeps when its row is split further


class Geometry(NamedTuple):
    lanes: int         # threads a row: a power of two, 1 to THREADS
    rows: int          # rows a block, THREADS // lanes
    blocks: int


def geometry(T: int, V: int, itemsize: int, sms: int = 132) -> Geometry:
    """The kernels' launch shape for T rows of V elements of ``itemsize``
    bytes on a card of ``sms`` SMs. A row takes one lane per 16-byte vector
    it spans, up to a warp (small V: 32 / lanes rows share a warp); while
    T rows leave the card under FILL threads an SM, the row is split over
    twice the lanes, up to a whole block, as long as each thread keeps
    MIN_VECTORS vectors."""
    vectors = -(-V * itemsize // 16)
    lanes = 1
    while lanes < 32 and lanes < vectors:
        lanes *= 2
    while (lanes < THREADS and T * lanes < FILL * sms
           and vectors >= 2 * lanes * MIN_VECTORS):
        lanes *= 2
    rows = THREADS // lanes
    return Geometry(lanes, rows, -(-T // rows))


def _launch_shape(logits: torch.Tensor) -> Geometry:
    sms = torch.cuda.get_device_properties(logits.device).multi_processor_count
    return geometry(*logits.shape, logits.element_size(), sms)


def load_library() -> ctypes.CDLL:
    """Build (once) and load the kernels' shared library."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(nvcc.build("fused_xent")))
        ll, vp = ctypes.c_longlong, ctypes.c_void_p
        i = ctypes.c_int
        lib.fused_xent_forward.argtypes = [vp, vp, i, vp, vp, ll, ll, i, i, ll, vp]
        lib.fused_xent_forward.restype = ctypes.c_int
        lib.fused_xent_backward.argtypes = [vp, vp, i, vp, vp, vp, ll, ll, i, i, ll, vp]
        lib.fused_xent_backward.restype = ctypes.c_int
        lib.fused_xent_error.argtypes = [ctypes.c_int]
        lib.fused_xent_error.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(logits: torch.Tensor, labels: torch.Tensor) -> None:
    if logits.ndim != 2 or labels.shape != logits.shape[:1]:
        raise ValueError(f"fused_xent takes logits (T, V) and labels (T,), got "
                         f"{tuple(logits.shape)} and {tuple(labels.shape)}")
    if logits.dtype not in DTYPES:
        raise TypeError(f"fused_xent takes float32 or bfloat16 logits, got {logits.dtype}")
    if labels.dtype.is_floating_point or labels.dtype == torch.bool:
        raise TypeError(f"fused_xent takes integer labels, got {labels.dtype}")
    if logits.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_xent: unsupported device {logits.device}")
    if labels.device != logits.device:
        raise ValueError("fused_xent needs labels on the logits' device")
    if not logits.is_contiguous():
        raise ValueError("fused_xent needs contiguous logits")
    if logits.shape[1] == 0:
        raise ValueError("fused_xent needs V >= 1")


def _labels(labels: torch.Tensor) -> torch.Tensor:
    """int32 or int64 labels as the kernels read them; other integer
    dtypes as int32."""
    if labels.dtype not in (torch.int32, torch.int64):
        labels = labels.to(torch.int32)
    return labels.contiguous()


def _empty_at_offset(logits: torch.Tensor) -> torch.Tensor:
    """An uninitialised tensor like ``logits`` whose data starts at the
    same byte offset from a 16-byte boundary, so that the backward cuts
    both rows alike."""
    T, V = logits.shape
    size = logits.element_size()
    buf = torch.empty(T * V + 16 // size, dtype=logits.dtype, device=logits.device)
    shift = (logits.data_ptr() - buf.data_ptr()) % 16 // size
    return buf[shift:shift + T * V].view(T, V)


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = load_library().fused_xent_error(err).decode()
        raise RuntimeError(f"fused_xent {what} launch failed: {msg} (cudaError {err})")


def xent_forward(logits: torch.Tensor, labels: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward, without autograd: (loss, lse), both (T,) fp32."""
    _check(logits, labels)
    if logits.device.type == "cpu":
        return fused_xent_ref(logits, labels)
    T, V = logits.shape
    loss = torch.empty(T, dtype=torch.float32, device=logits.device)
    lse = torch.empty_like(loss)
    if T == 0:
        return loss, lse
    lab = _labels(labels)
    shape = _launch_shape(logits)
    lib = load_library()
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        err = lib.fused_xent_forward(logits.data_ptr(), lab.data_ptr(), lab.element_size(),
                                     loss.data_ptr(), lse.data_ptr(), T, V,
                                     int(logits.dtype == torch.bfloat16), shape.lanes,
                                     shape.blocks, stream)
    _raise_on(err, "forward")
    LAUNCHES["forward"] += 1  # xent_fwd
    SHAPES.add((T, V, logits.dtype))
    return loss, lse


def xent_backward(logits: torch.Tensor, labels: torch.Tensor, lse: torch.Tensor,
                  g: torch.Tensor) -> torch.Tensor:
    """The gradient w.r.t. ``logits`` of ``sum(g * loss)``, in the logits'
    dtype; ``lse`` from :func:`xent_forward`, ``g`` (T,) fp32."""
    _check(logits, labels)
    for t in (lse, g):
        if t.shape != labels.shape or t.dtype != torch.float32 or t.device != logits.device:
            raise ValueError("fused_xent backward takes (T,) fp32 lse and cotangent "
                             "on the logits' device")
    if logits.device.type == "cpu":
        return fused_xent_bwd_ref(logits, labels, lse, g)
    T, V = logits.shape
    if T == 0:
        return torch.empty_like(logits)
    out = _empty_at_offset(logits)
    lab = _labels(labels)
    lse, g = lse.contiguous(), g.contiguous()
    shape = _launch_shape(logits)
    lib = load_library()
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        err = lib.fused_xent_backward(logits.data_ptr(), lab.data_ptr(), lab.element_size(),
                                      lse.data_ptr(), g.data_ptr(), out.data_ptr(), T, V,
                                      int(logits.dtype == torch.bfloat16), shape.lanes,
                                      shape.blocks, stream)
    _raise_on(err, "backward")
    LAUNCHES["backward"] += 1  # xent_bwd
    return out


class FusedXent(torch.autograd.Function):
    """(T, V) logits -> (T,) fp32 loss; the backward is K3's second kernel."""

    @staticmethod
    def forward(ctx, logits, labels):
        loss, lse = xent_forward(logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        return xent_backward(logits, labels, lse, g.float()), None


def fused_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token cross-entropy: logits (T, V), labels (T,) -> (T,) fp32,
    differentiable w.r.t. ``logits``."""
    return FusedXent.apply(logits, labels)
