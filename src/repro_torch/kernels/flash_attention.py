"""K4: causal / sliding-window flash attention with grouped KV heads,
forward and backward, both also as cross-attention (Sq != Sk).

Pair: ``repro/kernels/flash_attention.py:75`` (``flash_attention``, a
Pallas kernel on (BH, S, hd); body ``_flash_kernel`` at ``:29``). The JAX
model trains through the jnp chunked ``models/layers.py::attention`` and
autodiff; here every attention on the card goes through these kernels, so
the op carries a backward of its own (FlashAttention-2's, from
the saved logsumexp).

``flash_attention(q, k, v, causal=, window=)`` takes the model's layout
after RoPE: q (N, Sq, H, hd), k and v (N, Sk, KV, hd), H a multiple of KV
(query head h reads KV head h // (H / KV)), one dtype (fp32 or bf16), hd <=
160, any S. Sk may differ from Sq only without a mask (``causal=False,
window=0``): the decoder's cross-attention over the encoder's output, the
one way the model calls it. It returns (N, Sq, H, hd) in q's dtype,
differentiable w.r.t. q, k and v. The backward takes every hd the forward
does (its dK/dV kernel splits the head dim over two warps in bf16 above
128, ``flash_mma_bwd_dkdv<HD, 2>``, and in fp32 above 64). bf16 runs on
the tensor cores in bf16 (``flash_mma_*``), fp32 in split TF32, three TF32
products per fp32 one (``flash_tf32_*``). Its kernels take Sq = Sk; across
lengths the wrapper runs them over chunks of the queries
(``_cross_backward``). A CUDA tensor goes to the hand-written
kernels (``csrc/flash_attention.cu``, built by ``nvcc`` at first use); a
CPU tensor goes to the plain versions ``kernels/ref.py::attention_ref`` and
``attention_bwd_ref``; a fake tensor (of the card, or of the meta device)
to the ops' fake bodies (below). Anything else raises. ``LAUNCHES`` counts
kernel launches on the device: one per forward; two per backward (dQ with
the row terms D, then dK and dV), two a chunk across lengths. ``SHAPES`` counts the forward's launches
by their (N, Sq, Sk, H, KV, hd, causal, window, dtype), ``BACKWARD_SHAPES``
the backward's by the same key.

The forward and the backward are registered torch ops
(``torch.ops.repro_torch.flash_attention_fwd`` and ``_bwd``, joined by
``register_autograd``), so a trace on fake tensors (``launch/dryrun.py``)
sees the kernels the card runs: each op has a fake body that allocates
its true outputs and builds nothing, and a FLOP formula
(:func:`forward_flops`, :func:`backward_flops`: two products of the
(query, key) pairs the mask keeps, five in the backward). A fake trace
moves neither ``LAUNCHES`` nor ``SHAPES``. On ``DTensor``s (the dry-run's
sharded trace, ``launch/sharded.py``) both ops take the sharding rules
below: the batch or the heads split, each card's kernel on its own.
"""
from __future__ import annotations

import ctypes
from collections import Counter
import math

import numpy as np
import torch
from torch._subclasses.fake_tensor import is_fake
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import nvcc
from repro_torch.kernels.ref import attention_bwd_ref, attention_ref
from repro_torch.sharding import placed_as

LAUNCHES = {"forward": 0, "backward": 0}
SHAPES: Counter = Counter()
BACKWARD_SHAPES: Counter = Counter()
_LIB: ctypes.CDLL | None = None
DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 160        # the forward's; pixtral-12b's heads
MAX_GRID_YZ = 65535       # the C interface's bounds on N and H


def load_library() -> ctypes.CDLL:
    """Build (once) and load the kernels' shared library."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(nvcc.build("flash_attention")))
        ll, vp, ci, cf = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_forward.argtypes = [vp, vp, vp, vp, vp, ll, ll, ll, ll, ll, ll,
                                                ci, ll, cf, ci, vp]
        lib.flash_attention_forward.restype = ci
        lib.flash_attention_backward.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp, vp,
                                                 ll, ll, ll, ll, ll, ci, ll, cf, ci, vp]
        lib.flash_attention_backward.restype = ci
        lib.flash_attention_error.argtypes = [ci]
        lib.flash_attention_error.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           window: int) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention takes q (N, Sq, H, hd), k and v (N, Sk, KV, hd); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    N, S, H, hd = q.shape
    if k.shape[0] != N or k.shape[3] != hd or k.shape[2] == 0 or H % k.shape[2]:
        raise ValueError(f"flash_attention: k, v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (H must be a multiple of KV)")
    if k.shape[1] != S and (causal or window or k.shape[1] == 0):
        raise ValueError(f"flash_attention: Sq {S} != Sk {k.shape[1]} takes causal=False, "
                         f"window=0 and Sk >= 1 (cross-attention); got causal={causal}, "
                         f"window={window}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes one of float32 / bfloat16 for q, k and v, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.device.type not in ("cpu", "cuda") and not is_fake(q):
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


def _check_backward(q, k, v, o, lse, do, causal: bool, window: int) -> None:
    _check(q, k, v, causal, window)
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError("flash_attention backward takes o and do like q")
    if lse.shape != (q.shape[0], q.shape[2], q.shape[1]) or lse.dtype != torch.float32:
        raise ValueError("flash_attention backward takes lse (N, H, S) fp32")
    for t in (o, do, lse):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError("flash_attention backward needs contiguous tensors on q's device")


def _on_card(q: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention launches its kernels on a CUDA tensor, got {q.device}")


def _scale(hd: int) -> float:
    # the fp32 of 1 / sqrt(hd), as repro/kernels/flash_attention.py:85 has it
    return 1.0 / math.sqrt(hd)


def attn_forward(q, k, v, *, causal: bool, window: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward, without autograd: (o like q, lse (N, H, Sq) fp32)."""
    _check(q, k, v, causal, window)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    _on_card(q)
    N, S, H, hd = q.shape
    Sk = k.shape[1]
    o = torch.empty_like(q)
    lse = torch.empty((N, H, S), dtype=torch.float32, device=q.device)
    if N == 0 or S == 0:
        return o, lse
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            N, S, Sk, H, k.shape[2], hd, int(causal), window, _scale(hd),
            int(q.dtype == torch.bfloat16), stream)
    _raise_on(err, "forward")
    LAUNCHES["forward"] += 1  # flash_mma_fwd (bf16) or flash_tf32_fwd (fp32)
    SHAPES[(N, S, Sk, H, k.shape[2], hd, causal, window, q.dtype)] += 1
    return o, lse


def attn_backward(q, k, v, o, lse, do, *, causal: bool, window: int = 0):
    """(dq, dk, dv) of ``sum(do * o)``, ``o, lse = attn_forward(q, k, v)``,
    at every hd the forward takes. On the card, Sq != Sk (cross-attention,
    no mask) runs the Sq = Sk kernels over chunks of the queries
    (:func:`_cross_backward`)."""
    _check_backward(q, k, v, o, lse, do, causal, window)
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, o, lse, do, causal=causal, window=window)
    _on_card(q)
    if k.shape[1] != q.shape[1]:
        return _cross_backward(q, k, v, o, lse, do)
    return _square_backward(q, k, v, o, lse, do, causal, window)


def _cross_backward(q, k, v, o, lse, do):
    """The backward without a mask at Sq != Sk: every query sees every key,
    so the queries split into independent chunks of Sk rows, each a square
    problem for :func:`_square_backward`. The last chunk is padded with
    queries that see no key (lse +inf: their probabilities are 0; o and dO
    0), which add nothing to dK and dV; dK and dV are summed over the
    chunks in fp32."""
    N, Sq, H, hd = q.shape
    Sk = k.shape[1]
    dq = torch.empty_like(q)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    for q0 in range(0, Sq, Sk):
        n = min(Sk, Sq - q0)
        qc, oc, doc = (t[:, q0:q0 + n] for t in (q, o, do))
        lc = lse[:, :, q0:q0 + n]
        if n < Sk:
            pad = q.new_zeros((N, Sk - n, H, hd))
            qc, oc, doc = (torch.cat([t, pad], dim=1) for t in (qc, oc, doc))
            lc = torch.cat([lc, lse.new_full((N, H, Sk - n), torch.inf)], dim=2)
        cq, ck, cv = _square_backward(qc.contiguous(), k, v, oc.contiguous(), lc.contiguous(),
                                      doc.contiguous(), False, 0)
        dq[:, q0:q0 + n] = cq[:, :n]
        dk += ck
        dv += cv
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def _square_backward(q, k, v, o, lse, do, causal: bool, window: int):
    """The backward kernels at Sq = Sk."""
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
    LAUNCHES["backward"] += 2  # the dQ kernel, then the dK/dV kernel
    BACKWARD_SHAPES[(N, S, S, H, k.shape[2], hd, causal, window, q.dtype)] += 2
    return dq, dk, dv


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=())
def _forward_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                window: int) -> tuple[torch.Tensor, torch.Tensor]:
    return attn_forward(q, k, v, causal=causal, window=window)


@_forward_op.register_fake
def _(q, k, v, causal, window):
    _check(q, k, v, causal, window)
    N, S, H, _ = q.shape
    return torch.empty_like(q), q.new_empty((N, H, S), dtype=torch.float32)


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def _backward_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                 lse: torch.Tensor, do: torch.Tensor, causal: bool, window: int
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return attn_backward(q, k, v, o, lse, do, causal=causal, window=window)


@_backward_op.register_fake
def _(q, k, v, o, lse, do, causal, window):
    _check_backward(q, k, v, o, lse, do, causal, window)
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _setup_context(ctx, inputs, output):
    q, k, v, causal, window = inputs
    o, lse = output
    ctx.mark_non_differentiable(lse)
    ctx.set_materialize_grads(False)
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.causal, ctx.window = causal, window


def _backward(ctx, do, _dlse):
    q, k, v, o, lse = ctx.saved_tensors
    do = placed_as(do, o, contiguous=True) if isinstance(do, DTensor) else do.contiguous()
    dq, dk, dv = _backward_op(q, k, v, o, lse, do, ctx.causal, ctx.window)
    return dq, dk, dv, None, None


_forward_op.register_autograd(_backward, setup_context=_setup_context)


def attention_pairs(N: int, Sq: int, Sk: int, H: int, causal: bool, window: int) -> int:
    """The (query, key) pairs that causality and the window keep, over the
    N x H heads: query i sees key j where j <= i (causal) and i - j <
    window (a window)."""
    i = np.arange(Sq, dtype=np.int64)
    lo = np.maximum(i - window + 1, 0) if window else np.zeros_like(i)
    hi = np.minimum(i + 1, Sk) if causal else np.full_like(i, Sk)
    return N * H * int(np.clip(hi - lo, 0, None).sum())


def forward_flops(N: int, Sq: int, Sk: int, H: int, hd: int, causal: bool,
                  window: int) -> int:
    """The forward's products, S = Q K^T and O = P V, over the kept pairs."""
    return 2 * 2 * attention_pairs(N, Sq, Sk, H, causal, window) * hd


def backward_flops(N: int, Sq: int, Sk: int, H: int, hd: int, causal: bool,
                   window: int) -> int:
    """The backward's five products over the kept pairs: S again, dV, dP, dQ
    and dK."""
    return 5 * 2 * attention_pairs(N, Sq, Sk, H, causal, window) * hd


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def _forward_flop_formula(q_shape, k_shape, v_shape, causal, window, *args, **kwargs) -> int:
    N, Sq, H, hd = q_shape
    return forward_flops(N, Sq, k_shape[1], H, hd, causal, window)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _backward_flop_formula(q_shape, k_shape, v_shape, o_shape, lse_shape, do_shape, causal,
                           window, *args, **kwargs) -> int:
    N, S, H, hd = q_shape
    return backward_flops(N, S, k_shape[1], H, hd, causal, window)


def backward_workspace_bytes(q: torch.Tensor, k: torch.Tensor, *args) -> int:
    """The backward's scratch beside its outputs: the row terms D, (N, H, S)
    fp32; across lengths also a chunk's padded q, o, dO and lse and the
    fp32 sums of dK and dV (a chunk's own dQ, dK and dV not counted)."""
    N, Sq, H, hd = q.shape
    Sk = k.shape[1]
    if Sq == Sk:
        return 4 * N * H * Sq
    chunk = N * Sk * H * (3 * hd * q.element_size() + 4) + 4 * N * H * Sk
    return chunk + 2 * 4 * k.numel()


def _heads_pair(q, k) -> bool:
    """Whether q's and k's heads may split over the same mesh axes: KV = H
    (k and v repeated to H heads), or KV dividing every split of the mesh,
    so that each card's query heads read its own KV heads. ``q`` is a
    ``DTensor`` or the spec DTensor's rules see."""
    H, KV = q.shape[2], k.shape[2]
    mesh = q.device_mesh if isinstance(q, DTensor) else q.mesh
    return KV == H or KV % mesh.size() == 0


@register_sharding(torch.ops.repro_torch.flash_attention_fwd.default)
def _forward_sharding(q, k, v, causal, window):
    """K4's forward on ``DTensor``s, one mesh axis at a time: replicated,
    split over the batch (N), or over the heads (q, k, v and o on dim 2,
    lse (N, H, S) on dim 1) where they pair up (:func:`_heads_pair`). A
    split over the sequence is not a rule (the mask reads absolute
    positions): DTensor gathers it first."""
    rules = [([Replicate(), Replicate()], [Replicate()] * 3 + [None, None]),
             ([Shard(0), Shard(0)], [Shard(0)] * 3 + [None, None])]
    if _heads_pair(q, k):
        rules.append(([Shard(2), Shard(1)], [Shard(2)] * 3 + [None, None]))
    return rules


@register_sharding(torch.ops.repro_torch.flash_attention_bwd.default)
def _backward_sharding(q, k, v, o, lse, do, causal, window):
    """K4's backward on ``DTensor``s: the forward's rules, dQ, dK and dV
    placed as q, k and v."""
    rules = [([Replicate()] * 3, [Replicate()] * 6 + [None, None]),
             ([Shard(0)] * 3, [Shard(0)] * 6 + [None, None])]
    if _heads_pair(q, k):
        rules.append(([Shard(2)] * 3, [Shard(2)] * 4 + [Shard(1), Shard(2), None, None]))
    return rules


# scratch a kernel allocates and frees inside its op, by op; a trace of
# live bytes adds it at the op (launch/dryrun.py)
WORKSPACE = {torch.ops.repro_torch.flash_attention_bwd: backward_workspace_bytes}


def _sharded_inputs(q: DTensor, k: DTensor, v: DTensor) -> tuple:
    """q, k and v placed by one of the forward's sharding rules, chosen from
    q's placements: each mesh axis keeps q's batch or head split (the
    heads where they pair up, and each split where its cards do not
    outnumber its length) and gathers anything else; their local shards
    contiguous."""
    mesh = q.device_mesh

    def cards(dim):  # DTensor drops a rule that splits a dimension over more cards than it has
        return math.prod(mesh.size(a) for a, p in enumerate(q.placements) if p == Shard(dim))

    keep = {Shard(0)} if q.shape[0] >= cards(0) else set()
    if _heads_pair(q, k) and q.shape[2] >= cards(2):
        keep.add(Shard(2))
    place = tuple(p if p in keep else Replicate() for p in q.placements)
    ref = q if tuple(q.placements) == place else q.redistribute(q.device_mesh, place)
    return tuple(placed_as(t, ref, contiguous=True) for t in (q, k, v))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Attention in the model's layout: q (N, Sq, H, hd), k and v
    (N, Sk, KV, hd) -> (N, Sq, H, hd), differentiable w.r.t. q, k and v.
    ``DTensor`` inputs are first placed by one of the ops' sharding rules
    (:func:`_sharded_inputs`)."""
    if isinstance(q, DTensor):
        q, k, v = _sharded_inputs(q, k, v)
    return _forward_op(q, k, v, bool(causal), int(window))[0]
