"""K5: the chunkwise-parallel mLSTM cell (xLSTM), forward and backward.

Pair: ``repro/kernels/mlstm_chunk.py:71`` (``mlstm_chunk``, a Pallas kernel
on (BH, S, dh); body ``_mlstm_kernel`` at ``:23``). The JAX model trains
through the jnp ``models/ssm.py::_mlstm_chunk_scan`` and autodiff; here
every mLSTM on the card goes through these kernels, so ``MlstmChunk``
carries a backward of its own.

``mlstm_chunk(q, k, v, log_f, i_gate)`` takes q, k, v (BH, S, dh) and the
gates (BH, S), all fp32 and contiguous, dh <= 512, any S; it returns h
(BH, S, dh) fp32, from zero state, differentiable w.r.t. all five inputs.
A CUDA tensor goes to the hand-written kernels (``csrc/mlstm_chunk.cu``,
built by ``nvcc`` at first use, chunks of 256 with a ragged last chunk); a
CPU tensor goes to the plain version ``kernels/ref.py::mlstm_chunk_ref``
(the JAX package's op order and chunk rule), whose backward is autograd's.
Anything else raises. Every product runs on the tensor cores in split
TF32 (three TF32 products per fp32 one), which keeps fp32 accuracy.
``LAUNCHES`` counts kernel launches on the device: four per forward (prep,
scores, state, out), seven per backward (bprep, bstate, bscores, dq, dv,
dk, gates). ``SHAPES`` counts the forward's launches by (BH, S, dh),
``BACKWARD_SHAPES`` the backward's.
"""
from __future__ import annotations

import ctypes
from collections import Counter

import torch

from repro_torch.kernels import nvcc
from repro_torch.kernels.ref import mlstm_chunk_ref

LAUNCHES = {"forward": 0, "backward": 0}
SHAPES: Counter = Counter()
BACKWARD_SHAPES: Counter = Counter()
_LIB: ctypes.CDLL | None = None
CHUNK = 256               # the kernels' chunk length (csrc/mlstm_chunk.cu kP)
TILE = 64                 # output tile of every product (kT)
MAX_HEAD_DIM = 512
MAX_GRID = 65535          # BH * chunks rides the grid's z dimension
FWD_SAVED = ("cum", "alpha", "u", "beta", "cst", "nst", "nq", "den")


def load_library() -> ctypes.CDLL:
    """Build (once) and load the kernels' shared library."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(nvcc.build("mlstm_chunk")))
        ll, vp, ci = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
        lib.mlstm_chunk_forward.argtypes = [vp] * 15 + [ll, ll, ll, vp]
        lib.mlstm_chunk_forward.restype = ci
        lib.mlstm_chunk_backward.argtypes = [vp] * 30 + [ll, ll, ll, vp]
        lib.mlstm_chunk_backward.restype = ci
        lib.mlstm_chunk_error.argtypes = [ci]
        lib.mlstm_chunk_error.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(q, k, v, log_f, i_gate) -> None:
    if q.ndim != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"mlstm_chunk takes q, k, v (BH, S, dh) of one shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if log_f.shape != q.shape[:2] or i_gate.shape != q.shape[:2]:
        raise ValueError(f"mlstm_chunk takes log_f and i_gate (BH, S) = {tuple(q.shape[:2])}; "
                         f"got {tuple(log_f.shape)}, {tuple(i_gate.shape)}")
    ts = (q, k, v, log_f, i_gate)
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError(f"mlstm_chunk takes float32 inputs, got {[t.dtype for t in ts]}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mlstm_chunk: unsupported device {q.device}")
    if any(t.device != q.device for t in ts):
        raise ValueError("mlstm_chunk needs all inputs on one device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("mlstm_chunk needs contiguous inputs")
    BH, S, dh = q.shape
    if not 1 <= dh <= MAX_HEAD_DIM:
        raise ValueError(f"mlstm_chunk takes 1 <= dh <= {MAX_HEAD_DIM}, got {dh}")
    if BH * -(-S // CHUNK) > MAX_GRID:
        raise ValueError(f"mlstm_chunk takes BH * ceil(S / {CHUNK}) <= {MAX_GRID}, got BH {BH}, "
                         f"S {S}")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = load_library().mlstm_chunk_error(err).decode()
        raise RuntimeError(f"mlstm_chunk {what} launch failed: {msg} (cudaError {err})")


def _ptrs(*ts: torch.Tensor) -> list[int]:
    return [t.data_ptr() for t in ts]


def mlstm_forward(q, k, v, log_f, i_gate) -> tuple[torch.Tensor, dict]:
    """The forward on the card, without autograd: (h, saved), ``saved``
    holding what :func:`mlstm_backward` needs besides the inputs and h."""
    _check(q, k, v, log_f, i_gate)
    if q.device.type != "cuda":
        raise ValueError("mlstm_forward runs the CUDA kernels; a CPU tensor goes to "
                         "kernels/ref.py::mlstm_chunk_ref")
    BH, S, dh = q.shape
    nch = -(-S // CHUNK)
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=q.device)  # noqa: E731
    h = torch.empty_like(q)
    # C and n at the start of every chunk after the first
    saved = {"cum": new(BH, S), "alpha": new(BH, S), "u": new(BH, S), "beta": new(BH, nch),
             "cst": new(BH, nch - 1, dh, dh), "nst": new(BH, nch - 1, dh), "nq": new(BH, S),
             "den": new(BH, S)}
    if BH == 0 or S == 0:
        return h, saved
    amat = new(BH, nch, CHUNK, CHUNK)
    lib = load_library()
    s = saved
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mlstm_chunk_forward(
            *_ptrs(q, k, v, log_f, i_gate, h, s["cum"], s["alpha"], s["u"], s["beta"], amat,
                   s["cst"], s["nst"], s["nq"], s["den"]), BH, S, dh, stream)
    _raise_on(err, "forward")
    LAUNCHES["forward"] += 4  # prep, scores, state, out
    SHAPES[(BH, S, dh)] += 4
    return h, saved


def mlstm_backward(q, k, v, log_f, i_gate, h, saved: dict, g):
    """(dq, dk, dv, d log_f, d i_gate) of ``sum(g * h)`` on the card, from
    ``h, saved = mlstm_forward(q, k, v, log_f, i_gate)``."""
    _check(q, k, v, log_f, i_gate)
    if q.device.type != "cuda":
        raise ValueError("mlstm_backward runs the CUDA kernels")
    for t in (h, g):
        if t.shape != q.shape or t.dtype != torch.float32 or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError("mlstm_backward takes h and g contiguous, fp32, like q")
    BH, S, dh = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dlf, dig = torch.empty_like(log_f), torch.empty_like(i_gate)
    if BH == 0 or S == 0:
        return dq, dk, dv, dlf, dig
    nch = -(-S // CHUNK)
    ndt = -(-dh // TILE)
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=q.device)  # noqa: E731
    r = new(BH, S)
    dcend, dnend = new(BH, nch - 1, dh, dh), new(BH, nch - 1, dh)   # dC, dn at chunk ends
    dbc, dbn = new(ndt * ndt, BH, nch), new(ndt, BH, nch)
    amat, dsm = new(BH, nch, CHUNK, CHUNK), new(BH, nch, CHUNK, CHUNK)
    hrow, hcol = new(CHUNK // TILE, BH, S), new(CHUNK // TILE, BH, S)
    dal, du = new(ndt, BH, S), new(ndt, BH, S)
    s = saved
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.mlstm_chunk_backward(
            *_ptrs(q, k, v, i_gate, h, g, s["cum"], s["alpha"], s["u"], s["beta"], s["cst"],
                   s["nst"], s["nq"], s["den"], r, dcend, dnend, dbc, dbn, amat, dsm, hrow, hcol,
                   dal, du, dq, dk, dv, dlf, dig), BH, S, dh, stream)
    _raise_on(err, "backward")
    LAUNCHES["backward"] += 7  # bprep, bstate, bscores, dq, dv, dk, gates
    BACKWARD_SHAPES[(BH, S, dh)] += 7
    return dq, dk, dv, dlf, dig


class MlstmChunk(torch.autograd.Function):
    """q, k, v, log_f, i_gate -> h on the card; the backward is K5's seven
    backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, log_f, i_gate):
        h, saved = mlstm_forward(q, k, v, log_f, i_gate)
        ctx.save_for_backward(q, k, v, log_f, i_gate, h, *(saved[n] for n in FWD_SAVED))
        return h

    @staticmethod
    def backward(ctx, g):
        q, k, v, log_f, i_gate, h, *rest = ctx.saved_tensors
        return mlstm_backward(q, k, v, log_f, i_gate, h, dict(zip(FWD_SAVED, rest)),
                              g.contiguous())


def mlstm_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_f: torch.Tensor,
                i_gate: torch.Tensor) -> torch.Tensor:
    """The mLSTM cell from zero state: (BH, S, dh) q, k, v and (BH, S) gates
    -> h (BH, S, dh), differentiable w.r.t. all five."""
    _check(q, k, v, log_f, i_gate)
    if q.device.type == "cpu":
        return mlstm_chunk_ref(q, k, v, log_f, i_gate)
    return MlstmChunk.apply(q, k, v, log_f, i_gate)
