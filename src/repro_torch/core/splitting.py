"""Parameter-tree splitting at a block boundary (pair: ``repro/core/splitting.py:1``).

A :class:`SplitScheme` says how a full tree decomposes into a run of
blocks under ``blocks_key``, which a boundary slices into a near (client)
and a far (server) run, and fixed keys that always travel with one half.
The ResNet's blocks are a Python list of per-block trees; the
transformer's are stacked on a layer axis (``stacked=True``), which is axis
0 of one model's leaves and axis 1 behind a client axis: ``axis`` says which.
``merge_params`` inverts ``split_params`` exactly.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.tree import tree_map

Params = dict


@dataclass(frozen=True)
class SplitScheme:
    """How one architecture's parameter tree splits at a block boundary."""

    stacked: bool                 # blocks on a layer axis vs a list
    near_keys: tuple[str, ...]    # always input-side (client)
    far_keys: tuple[str, ...]     # always head-side (server)
    blocks_key: str = "blocks"


# The transformer stacks per-layer params; embed/projection and
# final-norm/head bookend the block run.
TRANSFORMER = SplitScheme(
    stacked=True,
    near_keys=("embed", "front_proj", "enc_blocks", "enc_ln"),
    far_keys=("final_ln", "lm_head"),
)

# The ResNet keeps a list of per-block trees; the stem is input-side, the
# classifier head is far-side.
RESNET = SplitScheme(stacked=False, near_keys=("stem",), far_keys=("fc",))


def split_params(params: Params, boundary: int, scheme: SplitScheme,
                 axis: int = 0) -> tuple[Params, Params]:
    """Split ``params`` so the near half keeps blocks ``[:boundary]``.

    ``axis`` is the layer axis of stacked blocks (1 behind a client axis).
    Returns ``(near, far)``; fixed keys are copied to their scheme-assigned
    half (skipped when absent)."""
    blocks = params[scheme.blocks_key]
    if scheme.stacked:
        near: Params = {scheme.blocks_key: tree_map(
            lambda a: a.narrow(axis, 0, boundary), blocks)}
        far: Params = {scheme.blocks_key: tree_map(
            lambda a: a.narrow(axis, boundary, a.shape[axis] - boundary), blocks)}
    else:
        near = {scheme.blocks_key: blocks[:boundary]}
        far = {scheme.blocks_key: blocks[boundary:]}
    for k in scheme.near_keys:
        if k in params:
            near[k] = params[k]
    for k in scheme.far_keys:
        if k in params:
            far[k] = params[k]
    return near, far


def merge_params(near: Params, far: Params, scheme: SplitScheme,
                 axis: int = 0) -> Params:
    """Inverse of :func:`split_params` — lossless for any boundary."""
    if scheme.stacked:
        blocks = tree_map(lambda a, b: torch.cat([a, b], dim=axis),
                          near[scheme.blocks_key], far[scheme.blocks_key])
    else:
        blocks = list(near[scheme.blocks_key]) + list(far[scheme.blocks_key])
    merged: Params = {scheme.blocks_key: blocks}
    for k in scheme.near_keys:
        if k in near:
            merged[k] = near[k]
    for k in scheme.far_keys:
        if k in far:
            merged[k] = far[k]
    return merged
