"""K5: the chunkwise-parallel mLSTM cell (xLSTM), forward and backward.

Pair: ``repro/kernels/mlstm_chunk.py:71`` (``mlstm_chunk``, a Pallas kernel
on (BH, S, dh); body ``_mlstm_kernel`` at ``:23``). The JAX model trains
through the jnp ``models/ssm.py::_mlstm_chunk_scan`` and autodiff; here
every mLSTM on the card goes through these kernels, so the op carries a
backward of its own.

``mlstm_chunk(q, k, v, log_f, i_gate)`` takes q, k, v (BH, S, dh) and the
gates (BH, S), all fp32 and contiguous, dh <= 512, any S; it returns h (BH,
S, dh) fp32, from zero state, differentiable w.r.t. all five inputs. A CUDA
tensor goes to the hand-written kernels (``csrc/mlstm_chunk.cu``, built by
``nvcc`` at first use, chunks of 256 with a ragged last chunk); a CPU
tensor goes to the plain version ``kernels/ref.py::mlstm_chunk_ref`` (the
JAX package's op order and chunk rule), whose backward is autograd's. A
fake tensor (of the card, or of the meta device) goes to the ops' fake
bodies; anything else raises. Every product runs on the tensor cores in
split TF32 (three TF32 products per fp32 one), which keeps fp32 accuracy.
``LAUNCHES`` counts kernel launches on the device: four per forward (prep,
scores, state, out), seven per backward (bprep, bstate, bscores, dq, dv,
dk, gates). ``SHAPES`` counts the forward's launches by (BH, S, dh),
``BACKWARD_SHAPES`` the backward's.

The forward and the backward are registered torch ops for CUDA and fake
tensors (``torch.ops.repro_torch.mlstm_chunk_fwd`` and ``_bwd``, joined by
``register_autograd``), so a trace on fake tensors (``launch/dryrun.py``)
sees the kernels the card runs: each op has a fake body that allocates its
true outputs and builds nothing, a FLOP formula (:func:`mlstm_work`'s
operations) and its scratch in ``WORKSPACE``. A fake trace moves neither
``LAUNCHES`` nor ``SHAPES``.
"""
from __future__ import annotations

import ctypes
from collections import Counter

import torch
from torch import Tensor
from torch._subclasses.fake_tensor import is_fake
from torch.utils.flop_counter import register_flop_formula

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
    if q.device.type not in ("cpu", "cuda") and not is_fake(q):
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


def _forward_outputs(q: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """h like q, and what the backward needs besides the inputs and h."""
    BH, S, dh = q.shape
    nch = -(-S // CHUNK)
    new = lambda *shape: q.new_empty(shape, dtype=torch.float32)  # noqa: E731
    # C and n at the start of every chunk after the first
    return torch.empty_like(q), {
        "cum": new(BH, S), "alpha": new(BH, S), "u": new(BH, S), "beta": new(BH, nch),
        "cst": new(BH, nch - 1, dh, dh), "nst": new(BH, nch - 1, dh), "nq": new(BH, S),
        "den": new(BH, S)}


def _check_backward(q, k, v, log_f, i_gate, h, g) -> None:
    _check(q, k, v, log_f, i_gate)
    for t in (h, g):
        if t.shape != q.shape or t.dtype != torch.float32 or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError("mlstm_backward takes h and g contiguous, fp32, like q")


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
    h, saved = _forward_outputs(q)
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
    _check_backward(q, k, v, log_f, i_gate, h, g)
    if q.device.type != "cuda":
        raise ValueError("mlstm_backward runs the CUDA kernels")
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


@torch.library.custom_op("repro_torch::mlstm_chunk_fwd", mutates_args=(), device_types="cuda")
def _forward_op(q: Tensor, k: Tensor, v: Tensor, log_f: Tensor, i_gate: Tensor
                ) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    h, saved = mlstm_forward(q, k, v, log_f, i_gate)
    return (h, *(saved[n] for n in FWD_SAVED))


@_forward_op.register_fake
def _(q, k, v, log_f, i_gate):
    _check(q, k, v, log_f, i_gate)
    h, saved = _forward_outputs(q)
    return (h, *(saved[n] for n in FWD_SAVED))


@torch.library.custom_op("repro_torch::mlstm_chunk_bwd", mutates_args=(), device_types="cuda")
def _backward_op(q: Tensor, k: Tensor, v: Tensor, log_f: Tensor, i_gate: Tensor, h: Tensor,
                 cum: Tensor, alpha: Tensor, u: Tensor, beta: Tensor, cst: Tensor, nst: Tensor,
                 nq: Tensor, den: Tensor, g: Tensor
                 ) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    saved = dict(zip(FWD_SAVED, (cum, alpha, u, beta, cst, nst, nq, den)))
    return mlstm_backward(q, k, v, log_f, i_gate, h, saved, g)


@_backward_op.register_fake
def _(q, k, v, log_f, i_gate, h, *rest):
    _check_backward(q, k, v, log_f, i_gate, h, rest[-1])
    return (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v),
            torch.empty_like(log_f), torch.empty_like(i_gate))


def _setup_context(ctx, inputs, output):
    h, *saved = output
    ctx.mark_non_differentiable(*saved)
    ctx.set_materialize_grads(False)
    ctx.save_for_backward(*inputs, h, *saved)


def _backward(ctx, g, *_):
    return _backward_op(*ctx.saved_tensors, g.contiguous())


_forward_op.register_autograd(_backward, setup_context=_setup_context)


def mlstm_work(BH: int, S: int, dh: int) -> tuple[float, float, float, float]:
    """The fp32 operations and bytes K5's forward and backward need on these
    shapes, in chunks of 256: products only where s <= t, no product with the
    zero state of the first chunk, no state update after the last. Returns
    (forward ops, forward bytes, backward ops, backward bytes)."""
    lens = [min(CHUNK, S - c0) for c0 in range(0, S, CHUNK)]
    tri = sum(L * (L + 1) // 2 for L in lens) * dh          # one causal (P, P, dh) product
    mid = sum(L for L in lens[1:]) * dh * dh                # q C, or its transpose
    end = sum(L for L in lens[:-1]) * dh * dh               # the state update
    fwd_macs = 2 * tri + mid + end + 2 * S * dh             # scores, A v; n.q, n update
    # backward: dA = g v^T, dS k, dS^T q, A^T g; C g (dq), dC v and k dC (dk,
    # dv), the dC walk. The gate terms come from dA * A with A kept from the
    # forward; the kernel's recompute of the scores is its own choice, not
    # counted.
    bwd_macs = 4 * tri + 2 * mid + 2 * end + 3 * S * dh
    row = BH * S * dh * 4
    return (2.0 * BH * fwd_macs, 4.0 * row + 8 * BH * S,
            2.0 * BH * bwd_macs, 8.0 * row + 16 * BH * S)


@register_flop_formula(torch.ops.repro_torch.mlstm_chunk_fwd)
def _forward_flop_formula(q_shape, *args, **kwargs) -> int:
    return int(mlstm_work(*q_shape)[0])


@register_flop_formula(torch.ops.repro_torch.mlstm_chunk_bwd)
def _backward_flop_formula(q_shape, *args, **kwargs) -> int:
    return int(mlstm_work(*q_shape)[2])


def forward_workspace_bytes(q: torch.Tensor, *args) -> int:
    """The forward's scratch beside its outputs: the decay matrices
    (BH, chunks, 256, 256) fp32."""
    BH, S, _ = q.shape
    return 4 * BH * -(-S // CHUNK) * CHUNK * CHUNK


def backward_workspace_bytes(q: torch.Tensor, *args) -> int:
    """The backward's scratch (``mlstm_backward``'s buffers besides its
    outputs), fp32."""
    BH, S, dh = q.shape
    nch, ndt = -(-S // CHUNK), -(-dh // TILE)
    elems = (BH * S                                          # r
             + BH * (nch - 1) * (dh * dh + dh)               # dC, dn at chunk ends
             + (ndt * ndt + ndt) * BH * nch                  # dbc, dbn
             + 2 * BH * nch * CHUNK * CHUNK                  # amat, dsm
             + 2 * (CHUNK // TILE) * BH * S                  # hrow, hcol
             + 2 * ndt * BH * S)                             # dal, du
    return 4 * elems


# scratch a kernel allocates and frees inside its op, by op; a trace of
# live bytes adds it at the op (launch/dryrun.py)
WORKSPACE = {torch.ops.repro_torch.mlstm_chunk_fwd: forward_workspace_bytes,
             torch.ops.repro_torch.mlstm_chunk_bwd: backward_workspace_bytes}


def mlstm_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_f: torch.Tensor,
                i_gate: torch.Tensor) -> torch.Tensor:
    """The mLSTM cell from zero state: (BH, S, dh) q, k, v and (BH, S) gates
    -> h (BH, S, dh), differentiable w.r.t. all five."""
    _check(q, k, v, log_f, i_gate)
    if q.device.type == "cpu":
        return mlstm_chunk_ref(q, k, v, log_f, i_gate)
    return _forward_op(q, k, v, log_f, i_gate)[0]
