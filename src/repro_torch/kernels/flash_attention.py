"""K4: causal / sliding-window flash attention with grouped KV heads,
forward and backward.

Pair: ``repro/kernels/flash_attention.py:75`` (``flash_attention``, a
Pallas kernel on (BH, S, hd); body ``_flash_kernel`` at ``:29``). The JAX
model trains through the jnp chunked ``models/layers.py::attention`` and
autodiff; here every attention on the card goes through these kernels, so
``FlashAttention`` carries a backward of its own (FlashAttention-2's, from
the saved logsumexp).

``flash_attention(q, k, v, causal=, window=)`` takes the model's layout
after RoPE: q (N, S, H, hd), k and v (N, S, KV, hd), H a multiple of KV
(query head h reads KV head h // (H / KV)), one dtype (fp32 or bf16),
hd <= 128, any S. It returns (N, S, H, hd) in q's dtype, differentiable
w.r.t. q, k and v. A CUDA tensor goes to the hand-written kernels
(``csrc/flash_attention.cu``, built by ``nvcc`` at first use); a CPU tensor
goes to the plain versions ``kernels/ref.py::attention_ref`` and
``attention_bwd_ref``. Anything else raises. ``LAUNCHES`` counts kernel
launches on the device: one per forward; two per backward (dQ with the
row terms D, then dK and dV).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import nvcc
from repro_torch.kernels.ref import attention_bwd_ref, attention_ref

LAUNCHES = {"forward": 0, "backward": 0}
_LIB: ctypes.CDLL | None = None
DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 128
MAX_GRID_YZ = 65535       # N and H ride the grid's z and y dimensions


def load_library() -> ctypes.CDLL:
    """Build (once) and load the kernels' shared library."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(nvcc.build("flash_attention")))
        ll, vp, ci, cf = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_forward.argtypes = [vp, vp, vp, vp, vp, ll, ll, ll, ll, ll,
                                                ci, ll, cf, ci, vp]
        lib.flash_attention_forward.restype = ci
        lib.flash_attention_backward.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp, vp,
                                                 ll, ll, ll, ll, ll, ci, ll, cf, ci, vp]
        lib.flash_attention_backward.restype = ci
        lib.flash_attention_error.argtypes = [ci]
        lib.flash_attention_error.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention takes q (N, S, H, hd), k and v (N, S, KV, hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    N, S, H, hd = q.shape
    if k.shape[:2] != (N, S) or k.shape[3] != hd or k.shape[2] == 0 or H % k.shape[2]:
        raise ValueError(f"flash_attention: k, v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (H must be a multiple of KV)")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes one of float32 / bfloat16 for q, k and v, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention needs q, k and v on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention needs contiguous q, k and v")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention takes head_dim <= {MAX_HEAD_DIM}, got {hd}")
    if N > MAX_GRID_YZ or H > MAX_GRID_YZ:
        raise ValueError(f"flash_attention takes N, H <= {MAX_GRID_YZ}, got {N}, {H}")
    if window < 0:
        raise ValueError(f"flash_attention: window must be >= 0, got {window}")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = load_library().flash_attention_error(err).decode()
        raise RuntimeError(f"flash_attention {what} launch failed: {msg} (cudaError {err})")


def _scale(hd: int) -> float:
    # the fp32 of 1 / sqrt(hd), as repro/kernels/flash_attention.py:85 has it
    return 1.0 / math.sqrt(hd)


def attn_forward(q, k, v, *, causal: bool, window: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward, without autograd: (o like q, lse (N, H, S) fp32)."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    N, S, H, hd = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((N, H, S), dtype=torch.float32, device=q.device)
    if N == 0 or S == 0:
        return o, lse
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            N, S, H, k.shape[2], hd, int(causal), window, _scale(hd),
            int(q.dtype == torch.bfloat16), stream)
    _raise_on(err, "forward")
    LAUNCHES["forward"] += 1  # flash_fwd
    return o, lse


def attn_backward(q, k, v, o, lse, do, *, causal: bool, window: int = 0):
    """(dq, dk, dv) of ``sum(do * o)``, ``o, lse = attn_forward(q, k, v)``."""
    _check(q, k, v, window)
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError("flash_attention backward takes o and do like q")
    if lse.shape != (q.shape[0], q.shape[2], q.shape[1]) or lse.dtype != torch.float32:
        raise ValueError("flash_attention backward takes lse (N, H, S) fp32")
    for t in (o, do, lse):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("flash_attention backward needs contiguous tensors on q's device")
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, o, lse, do, causal=causal, window=window)
    N, S, H, hd = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if N == 0 or S == 0:
        return dq, dk, dv
    dbuf = torch.empty_like(lse)
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_backward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dbuf.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            N, S, H, k.shape[2], hd, int(causal), window, _scale(hd),
            int(q.dtype == torch.bfloat16), stream)
    _raise_on(err, "backward")
    LAUNCHES["backward"] += 2  # flash_bwd_dq, then flash_bwd_dkdv
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """q, k, v -> o; the backward is K4's dQ and dK/dV kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        o, lse = attn_forward(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = attn_backward(q, k, v, o, lse, do.contiguous(),
                                   causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Attention in the model's layout: q (N, S, H, hd), k and v
    (N, S, KV, hd) -> (N, S, H, hd), differentiable w.r.t. q, k and v."""
    return FlashAttention.apply(q, k, v, bool(causal), int(window))
