"""K3: fused per-token cross-entropy, with a backward.

Pair: ``repro/kernels/fused_xent.py:62`` (``fused_xent``, a Pallas kernel;
body ``_xent_kernel`` at ``:26``). The JAX package trains through the jnp
``core/local_loss.py::token_xent`` and autodiff; here every ``token_xent``
on the card goes through these kernels, so the op carries a backward
kernel of its own.

``fused_xent(logits, labels)`` takes logits (T, V) fp32 or bf16 and labels
(T,) of any integer dtype, and returns the per-token loss (T,) fp32,
differentiable w.r.t. ``logits``. Any T and V, and any row alignment: each
row streams its 16-byte vectors between an element-wise head and tail. A
CUDA tensor goes to the hand-written kernels (``csrc/fused_xent.cu``, built
by ``nvcc`` at first use); a CPU tensor goes to the plain versions
``kernels/ref.py::fused_xent_ref`` and ``fused_xent_bwd_ref``; a fake
tensor (of the card, or of the meta device) to the ops' fake bodies.
Anything else raises. Both kernels run on the launch shape that
:func:`geometry` picks from (T, V), the element size and the card's SM
count: threads a row (split over up to 8 warps at small T, packed several
rows a warp at small V) and blocks. The backward writes dlogits at the
logits' offset from a 16-byte boundary, so both share the row's cut.
``LAUNCHES`` counts kernel launches on the device: one per forward, one per
backward. ``SHAPES`` counts the forward's launches by their (T, V, dtype),
``BACKWARD_SHAPES`` the backward's by the same key.

The forward and the backward are registered torch ops
(``torch.ops.repro_torch.fused_xent_fwd`` and ``_bwd``, joined by
``register_autograd``), so a trace on fake tensors (``launch/dryrun.py``)
sees the kernels the card runs: each op has a fake body that allocates
its true outputs (the per-row loss and lse; dlogits like the logits) and
builds nothing, and a FLOP formula of 0: neither kernel has a product. A
fake trace moves neither ``LAUNCHES`` nor ``SHAPES``. On ``DTensor``s (the
dry-run's sharded trace, ``launch/sharded.py``) the ops take the sharding
rules below, rows split or replicated, and logits split over the vocab
(or over rows that do not merge into one) take :class:`_ShardedXent`.
"""
from __future__ import annotations

import ctypes
from collections import Counter
from typing import NamedTuple

import torch
import torch.distributed._functional_collectives as funcol
from torch._subclasses.fake_tensor import is_fake
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import nvcc
from repro_torch.kernels.ref import fused_xent_bwd_ref, fused_xent_ref
from repro_torch.sharding import merges_rows

LAUNCHES = {"forward": 0, "backward": 0}
SHAPES: Counter = Counter()
BACKWARD_SHAPES: Counter = Counter()
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
    if logits.device.type not in ("cpu", "cuda") and not is_fake(logits):
        raise ValueError(f"fused_xent: unsupported device {logits.device}")
    if labels.device != logits.device:
        raise ValueError("fused_xent needs labels on the logits' device")
    if not logits.is_contiguous():
        raise ValueError("fused_xent needs contiguous logits")
    if logits.shape[1] == 0:
        raise ValueError("fused_xent needs V >= 1")


def _check_backward(logits, labels, lse, g) -> None:
    _check(logits, labels)
    for t in (lse, g):
        if t.shape != labels.shape or t.dtype != torch.float32 or t.device != logits.device:
            raise ValueError("fused_xent backward takes (T,) fp32 lse and cotangent "
                             "on the logits' device")


def _on_card(logits: torch.Tensor) -> None:
    if logits.device.type != "cuda":
        raise ValueError(f"fused_xent launches its kernels on a CUDA tensor, got "
                         f"{logits.device}")


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
    _on_card(logits)
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
    SHAPES[(T, V, logits.dtype)] += 1
    return loss, lse


def xent_backward(logits: torch.Tensor, labels: torch.Tensor, lse: torch.Tensor,
                  g: torch.Tensor) -> torch.Tensor:
    """The gradient w.r.t. ``logits`` of ``sum(g * loss)``, in the logits'
    dtype; ``lse`` from :func:`xent_forward`, ``g`` (T,) fp32."""
    _check_backward(logits, labels, lse, g)
    if logits.device.type == "cpu":
        return fused_xent_bwd_ref(logits, labels, lse, g)
    _on_card(logits)
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
    BACKWARD_SHAPES[(T, V, logits.dtype)] += 1
    return out


@torch.library.custom_op("repro_torch::fused_xent_fwd", mutates_args=())
def _forward_op(logits: torch.Tensor, labels: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    return xent_forward(logits, labels)


@_forward_op.register_fake
def _(logits, labels):
    _check(logits, labels)
    loss = logits.new_empty(logits.shape[:1], dtype=torch.float32)
    return loss, torch.empty_like(loss)


@torch.library.custom_op("repro_torch::fused_xent_bwd", mutates_args=())
def _backward_op(logits: torch.Tensor, labels: torch.Tensor, lse: torch.Tensor,
                 g: torch.Tensor) -> torch.Tensor:
    return xent_backward(logits, labels, lse, g)


@_backward_op.register_fake
def _(logits, labels, lse, g):
    _check_backward(logits, labels, lse, g)
    return torch.empty_like(logits)


def _setup_context(ctx, inputs, output):
    logits, labels = inputs
    _, lse = output
    ctx.mark_non_differentiable(lse)
    ctx.set_materialize_grads(False)
    ctx.save_for_backward(logits, labels, lse)


def _backward(ctx, g, _dlse):
    logits, labels, lse = ctx.saved_tensors
    return _backward_op(logits, labels, lse, g.float()), None


_forward_op.register_autograd(_backward, setup_context=_setup_context)


@register_flop_formula([torch.ops.repro_torch.fused_xent_fwd,
                        torch.ops.repro_torch.fused_xent_bwd])
def _flop_formula(*args, **kwargs) -> int:
    return 0


@register_sharding(torch.ops.repro_torch.fused_xent_fwd.default)
def _forward_sharding(logits, labels):
    """K3's forward on ``DTensor``s, one mesh axis at a time: replicated or
    split over the rows. Logits split over the vocab take
    :class:`_ShardedXent` instead (:func:`fused_xent`)."""
    return [([Replicate(), Replicate()], [Replicate(), Replicate()]),
            ([Shard(0), Shard(0)], [Shard(0), Shard(0)])]


@register_sharding(torch.ops.repro_torch.fused_xent_bwd.default)
def _backward_sharding(logits, labels, lse, g):
    return [([Replicate()], [Replicate()] * 4), ([Shard(0)], [Shard(0)] * 4)]


def _vocab_offset(V: int, mesh, place, dim: int) -> int:
    """The first vocab column of this rank's shard of logits split over
    their vocab, dimension ``dim``."""
    offset, coord = 0, mesh.get_coordinate()
    for axis, p in enumerate(place):
        if p == Shard(dim):
            chunk = -(-V // mesh.size(axis))
            offset += coord[axis] * chunk
            V = max(0, min(chunk, V - coord[axis] * chunk))
    return offset


class _ShardedXent(torch.autograd.Function):
    """K3 over ``DTensor`` logits (..., V) and labels (...) placed any way:
    each card's kernel runs on its own rows and columns, as GSPMD runs the
    JAX package's jnp cross-entropy. Rows split over any dimensions stay
    split (the loss is placed as they are); where the vocab is split, three
    all-reduces of a row each (the lse's max and sum, the label's logit)
    over the vocab's axes make the rows whole. The logits are never
    gathered, and the backward needs no collective.

    Each card's labels are shifted by its columns' offset: a label outside
    them picks 0 and has no one-hot term, in the kernel and in its plain
    version alike."""

    @staticmethod
    def forward(ctx, logits, labels):
        mesh, place, last = logits.device_mesh, tuple(logits.placements), logits.ndim - 1
        vocab = [a for a, p in enumerate(place) if p == Shard(last)]
        rows = tuple(Replicate() if a in vocab else p for a, p in enumerate(place))
        x = logits.to_local()
        V = x.shape[-1]
        lab = labels.redistribute(mesh, rows).to_local()
        lab = lab.reshape(-1) - _vocab_offset(logits.shape[-1], mesh, place, last)
        x2 = x.reshape(-1, V).contiguous()
        _, lse = _forward_op(x2, lab)
        ok = (lab >= 0) & (lab < V)
        picked = torch.where(ok, x2.gather(1, lab.clamp(0, V - 1).long()[:, None])[:, 0].float(),
                             0.0)
        m = lse
        for a in vocab:
            m = funcol.all_reduce(m, "max", (mesh, a))
        total = torch.exp(lse - m)
        for a in vocab:
            total = funcol.all_reduce(total, "sum", (mesh, a))
            picked = funcol.all_reduce(picked, "sum", (mesh, a))
        lse = m + torch.log(total)
        ctx.save_for_backward(x2, lab, lse)
        ctx.meta = mesh, place, rows, x.shape, logits.shape, logits.stride()
        return DTensor.from_local((lse - picked).reshape(x.shape[:-1]), mesh, rows,
                                  run_check=False, shape=labels.shape,
                                  stride=torch.empty(labels.shape, device="meta").stride())

    @staticmethod
    def backward(ctx, g):
        x2, lab, lse = ctx.saved_tensors
        mesh, place, rows, local, shape, stride = ctx.meta
        g = g.redistribute(mesh, rows).to_local().reshape(-1).float()
        dx = _backward_op(x2, lab, lse, g).reshape(local)
        return DTensor.from_local(dx, mesh, place, run_check=False, shape=shape,
                                  stride=stride), None


def fused_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token cross-entropy: logits (T, V), labels (T,) -> (T,) fp32,
    differentiable w.r.t. ``logits``. ``DTensor`` logits may carry more row
    dimensions, (..., V) with labels (...), and give the loss placed as
    the rows: where the vocab is whole and the rows merge into one split
    dimension, the ops run under their sharding rules; else through
    :class:`_ShardedXent`."""
    if not isinstance(logits, DTensor):
        return _forward_op(logits, labels)[0]
    if not isinstance(labels, DTensor):
        raise TypeError("fused_xent over DTensor logits takes DTensor labels")
    if any(p.is_partial() for p in logits.placements):
        logits = logits.redistribute(logits.device_mesh, [
            Replicate() if p.is_partial() else p for p in logits.placements])
    if Shard(logits.ndim - 1) in logits.placements or not merges_rows(logits, logits.ndim - 1):
        return _ShardedXent.apply(logits, labels)
    V = logits.shape[-1]
    return _forward_op(logits.reshape(-1, V), labels.reshape(-1))[0].reshape(labels.shape)
