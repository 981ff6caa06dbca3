"""``DTensor`` layout helpers, shared by the models' seams
(``models/shardctx.py``, ``models/layers.py``), the kernels' sharding
paths (``kernels/flash_attention.py``, ``kernels/fused_xent.py``) and the
dry-run's sharded trace (``launch/sharded.py``). Only that trace hands
the port ``DTensor``s; every helper leaves a plain tensor as it is.

:func:`placements` maps a spec (a tuple of mesh axis names, one entry a
dimension, over a tensor's trailing dimensions) to placements. Between
the seams DTensor places each op by its own sharding rules and cost; the
other helpers steer it where GSPMD's choice differs or where DTensor
cannot view a split: an FSDP weight is gathered before its product
(:func:`gather_fsdp`), a column-parallel product takes whole input rows
(:func:`gather_columns`), the MoE's expert queues move onto the
experts' split (:func:`on_experts`), rows merge only where the split is the first of
them (:func:`merges_rows`, :func:`flat_rows`) and heads split or merge
only where the cards divide them (:func:`even_split`), and a view's
gradient comes back placed as its value (:func:`pin_grad`,
:func:`placed_as`).
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard


def placements(spec: tuple, ndim: int, mesh) -> tuple:
    """The ``DTensor`` placements, one a dimension of ``mesh``, of a tensor
    of ``ndim`` dimensions under ``spec`` (over its trailing dimensions):
    ``Shard(dim)`` on each mesh axis the spec names, ``Replicate()`` on the
    others."""
    if len(spec) > ndim:
        raise ValueError(f"a spec of {len(spec)} dimensions for a tensor of {ndim}: {spec}")
    out: list = [Replicate()] * mesh.ndim
    lead = ndim - len(spec)
    for i, ax in enumerate(spec):
        for name in (() if ax is None else ax if isinstance(ax, tuple) else (ax,)):
            dim = mesh.mesh_dim_names.index(name)
            if out[dim] != Replicate():
                raise ValueError(f"mesh axis {name!r} named twice in {spec}")
            out[dim] = Shard(lead + i)
    return tuple(out)


def gather_fsdp(w: DTensor, x, dim: int) -> DTensor:
    """The weight ``w`` gathered over each mesh axis that splits its
    dimension ``dim`` (the FSDP split) while it splits ``x``, the input it
    meets, on a leading dimension (the batch): FSDP's and GSPMD's gather
    before use. Left to itself DTensor would rather move ``x`` onto the
    weight's split and sum the product over the cards."""
    xp = x.placements if isinstance(x, DTensor) else (Replicate(),) * w.device_mesh.ndim
    place = tuple(Replicate() if p == Shard(dim) and isinstance(q, Shard) and q.dim < x.ndim - 1
                  else p for p, q in zip(w.placements, xp))
    return w if place == tuple(w.placements) else w.redistribute(w.device_mesh, place)


def gather_columns(x, w: DTensor):
    """``x`` gathered over each mesh axis that splits ``w``'s columns and
    either splits x's last dimension (the product's contraction) or holds
    x as partial sums (summed there): a column-parallel product takes
    whole input rows, as Megatron's and GSPMD's do. Left to itself DTensor
    would rather move the weight onto x's split, or gather it whole beside
    x's partial sums, and leave the product a partial sum, which the
    nonlinearity after it must then sum whole."""
    if not isinstance(x, DTensor):
        return x
    contraction, columns = Shard(x.ndim - 1), Shard(w.ndim - 1)
    place = tuple(Replicate() if (p == contraction or p.is_partial()) and q == columns else p
                  for p, q in zip(x.placements, w.placements))
    return x if place == tuple(x.placements) else x.redistribute(x.device_mesh, place)


def on_experts(xe, w: DTensor, dim: int):
    """The expert queues ``xe`` (..., E, cap, d) split on their expert
    dimension ``dim`` over each mesh axis that splits the expert weight
    ``w``'s experts (its dimension 1), as GSPMD moves them after the
    dispatch einsum: from a split of the model width (the ``act``
    layout's) that is one all-to-all a mesh axis, from a whole dimension
    a slice. Each card then runs the products of its own experts only;
    left to itself DTensor would rather gather the experts onto every
    card. Over an axis that splits the width but not the experts (experts
    that do not divide it), the queues are gathered whole, and every card
    of that axis runs every expert (DTensor would split the already split
    groups again, which it then cannot view)."""
    if not isinstance(xe, DTensor):
        return xe
    width = Shard(xe.ndim - 1)
    place = tuple(Shard(dim) if q == Shard(1) else Replicate() if p == width else p
                  for p, q in zip(xe.placements, w.placements))
    return xe if place == tuple(xe.placements) else xe.redistribute(xe.device_mesh, place)


def merges_rows(x, end: int) -> bool:
    """Whether a ``DTensor``'s dimensions [0, end) view as one without a
    strided split: DTensor merges a split dimension only as the first of
    the merged ones longer than 1."""
    first = next((d for d in range(end) if x.shape[d] > 1), end)
    return not any(isinstance(p, Shard) and first < p.dim < end for p in x.placements)


def flat_rows(x: DTensor) -> DTensor:
    """``x`` (C, ..., d_in) ready to flatten its rows (C, -1, d_in): a mesh
    axis that splits a row dimension after the first one longer than 1 is
    gathered (:func:`merges_rows`). Under a sequence-split preset this is
    the sequence all-gather before a column-parallel product, as
    Megatron's sequence parallelism does."""
    if merges_rows(x, x.ndim - 1):
        return x
    first = next(d for d in range(x.ndim - 1) if x.shape[d] > 1)
    return x.redistribute(x.device_mesh, [
        Replicate() if isinstance(p, Shard) and first < p.dim < x.ndim - 1 else p
        for p in x.placements])


def even_split(y, dim: int, n: int):
    """``y`` ready to view its dimension ``dim`` as n blocks (split or
    merged): a ``DTensor`` split over it by more cards than n divides into
    is gathered over those axes first (DTensor views a split dimension
    only where the cards divide it evenly; GSPMD pads instead). A plain
    tensor is returned as it is."""
    if not isinstance(y, DTensor):
        return y
    split = Shard(dim % y.ndim)
    cards = math.prod(y.device_mesh.size(a) for a, p in enumerate(y.placements) if p == split)
    if n % cards == 0:
        return y
    return y.redistribute(y.device_mesh, [Replicate() if p == split else p for p in y.placements])


def placed_as(x, like, *, contiguous: bool = False):
    """``x`` redistributed to ``like``'s placements (a partial sum's:
    whole) when both are ``DTensor``s; else ``x`` unchanged. With
    ``contiguous`` its local shard is made contiguous as well (a split of
    a middle dimension cut from a whole tensor is a strided view, which
    the kernels refuse)."""
    if not (isinstance(x, DTensor) and isinstance(like, DTensor)):
        return x
    want = tuple(Replicate() if p.is_partial() else p for p in like.placements)
    if tuple(x.placements) != want:
        x = x.redistribute(x.device_mesh, want)
    local = x.to_local()
    if not contiguous or local.is_contiguous():
        return x
    return DTensor.from_local(local.contiguous(), x.device_mesh, x.placements, run_check=False,
                              shape=x.shape, stride=x.stride())


class _PinGrad(torch.autograd.Function):
    """The identity, whose backward places the gradient as the forward's
    value was placed (a partial sum's gradient: whole), its local shard
    contiguous (a split cut from a whole gradient is a strided view, which
    the view's own backward cannot view)."""

    @staticmethod
    def forward(ctx, x):
        # a partial value's gradient is whole on every card
        ctx.place = x.device_mesh, tuple(Replicate() if p.is_partial() else p
                                         for p in x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, place = ctx.place
        if tuple(g.placements) != place:
            g = g.redistribute(mesh, place)
        local = g.to_local()
        if local.is_contiguous():
            return g
        return DTensor.from_local(local.contiguous(), mesh, place, run_check=False,
                                  shape=g.shape, stride=g.stride())


def pin_grad(x):
    """``x``, its gradient placed as ``x`` is (a ``DTensor``; else ``x``
    itself). A view's backward on a gradient placed otherwise than its
    forward may ask DTensor for a strided split it cannot make."""
    return _PinGrad.apply(x) if isinstance(x, DTensor) and x.requires_grad else x
