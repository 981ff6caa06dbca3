"""K3: fused per-token cross-entropy, with a backward.

Pair: ``repro/kernels/fused_xent.py:62`` (``fused_xent``, a Pallas kernel;
body ``_xent_kernel`` at ``:26``). The JAX package trains through the jnp
``core/local_loss.py::token_xent`` and autodiff; here every ``token_xent``
on the card goes through these kernels, so ``FusedXent`` carries a
backward kernel of its own.

``fused_xent(logits, labels)`` takes logits (T, V) fp32 or bf16 and labels
(T,) of any integer dtype, and returns the per-token loss (T,) fp32,
differentiable w.r.t. ``logits``. Any T and V (ragged tails are masked in
the kernel). A CUDA tensor goes to the hand-written kernels
(``csrc/fused_xent.cu``, built by ``nvcc`` at first use); a CPU tensor goes
to the plain versions ``kernels/ref.py::fused_xent_ref`` and
``fused_xent_bwd_ref``. Anything else raises. ``LAUNCHES`` counts kernel
launches on the device: one per forward, one per backward.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import nvcc
from repro_torch.kernels.ref import fused_xent_bwd_ref, fused_xent_ref

LAUNCHES = {"forward": 0, "backward": 0}
_LIB: ctypes.CDLL | None = None
DTYPES = (torch.float32, torch.bfloat16)


def load_library() -> ctypes.CDLL:
    """Build (once) and load the kernels' shared library."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(nvcc.build("fused_xent")))
        ll, vp = ctypes.c_longlong, ctypes.c_void_p
        lib.fused_xent_forward.argtypes = [vp, vp, vp, vp, ll, ll, ctypes.c_int, vp]
        lib.fused_xent_forward.restype = ctypes.c_int
        lib.fused_xent_backward.argtypes = [vp, vp, vp, vp, vp, ll, ll, ctypes.c_int, vp]
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
    lab = labels.to(torch.int32).contiguous()
    lib = load_library()
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        err = lib.fused_xent_forward(logits.data_ptr(), lab.data_ptr(), loss.data_ptr(),
                                     lse.data_ptr(), T, V, int(logits.dtype == torch.bfloat16),
                                     stream)
    _raise_on(err, "forward")
    LAUNCHES["forward"] += 1  # xent_fwd
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
    out = torch.empty_like(logits)
    if T == 0:
        return out
    lab = labels.to(torch.int32).contiguous()
    g = g.contiguous()
    lib = load_library()
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        err = lib.fused_xent_backward(logits.data_ptr(), lab.data_ptr(), lse.data_ptr(),
                                      g.data_ptr(), out.data_ptr(), T, V,
                                      int(logits.dtype == torch.bfloat16), stream)
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
