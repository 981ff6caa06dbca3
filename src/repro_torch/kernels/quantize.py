"""K1: int8 quantize/dequantize round trip with one scale per row.

Pair: ``repro/kernels/quantize.py:32`` (``int8_roundtrip``, a Pallas kernel
with one scale per tensor; body ``_qdq_kernel`` at ``:25``). The JAX codec
gets one scale per client by ``jax.vmap`` over it; here the client (or
leaf) axis is the row axis of the kernel's input.

``int8_roundtrip_rows(x)`` takes ``x`` of shape (R, n), contiguous, fp32 or
bf16. A CUDA tensor goes to the hand-written kernel
(``csrc/int8_roundtrip.cu``, built by ``nvcc`` at first use); a CPU tensor
goes to the plain version ``kernels/ref.py::int8_roundtrip_ref``. Anything
else raises. ``LAUNCHES`` counts kernel launches on the device: two per
call on a CUDA tensor (the row absmax, then the quantize/dequantize pass),
besides the zero fill of the absmax buffer.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import nvcc
from repro_torch.kernels.ref import int8_roundtrip_ref

LAUNCHES = 0
_LIB: ctypes.CDLL | None = None


def load_library() -> ctypes.CDLL:
    """Build (once) and load the kernel's shared library."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(nvcc.build("int8_roundtrip")))
        lib.int8_roundtrip_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.int8_roundtrip_rows.restype = ctypes.c_int
        lib.int8_roundtrip_error.argtypes = [ctypes.c_int]
        lib.int8_roundtrip_error.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def int8_roundtrip_rows(x: torch.Tensor) -> torch.Tensor:
    """Round-trip each row of ``x`` (R, n) through int8 with its own scale."""
    global LAUNCHES
    if x.ndim != 2:
        raise ValueError(f"int8_roundtrip_rows takes (R, n), got shape {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"int8_roundtrip_rows takes float32 or bfloat16, got {x.dtype}")
    if x.device.type == "cpu":
        return int8_roundtrip_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"int8_roundtrip_rows: unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("int8_roundtrip_rows needs a contiguous tensor")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = load_library()
    with torch.cuda.device(x.device):
        amax = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.int8_roundtrip_rows(
            x.data_ptr(), out.data_ptr(), amax.data_ptr(), x.shape[0], x.shape[1],
            int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        msg = lib.int8_roundtrip_error(err).decode()
        raise RuntimeError(f"int8_roundtrip_rows launch failed: {msg} (cudaError {err})")
    LAUNCHES += 2  # absmax_rows, then qdq_rows
    return out
