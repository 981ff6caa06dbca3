"""Parameter-tree splitting at a block boundary (pair: ``repro/core/splitting.py:1``).

A :class:`SplitScheme` says how a full tree decomposes into a run of
blocks under ``blocks_key``, which a boundary slices into a near (client)
and a far (server) run, and fixed keys that always travel with one half.
This slice ports the ResNet scheme, whose blocks are a Python list of
per-block trees; the transformer's stacked scheme comes with the
transformer path. ``merge_params`` inverts ``split_params`` exactly, with or
without a leading client axis on the leaves.
"""
from __future__ import annotations

from dataclasses import dataclass

Params = dict


@dataclass(frozen=True)
class SplitScheme:
    """How one architecture's parameter tree splits at a block boundary."""

    near_keys: tuple[str, ...]    # always input-side (client)
    far_keys: tuple[str, ...]     # always head-side (server)
    blocks_key: str = "blocks"


# The ResNet keeps a list of per-block trees; the stem is input-side, the
# classifier head is far-side.
RESNET = SplitScheme(near_keys=("stem",), far_keys=("fc",))


def split_params(params: Params, boundary: int,
                 scheme: SplitScheme) -> tuple[Params, Params]:
    """Split ``params`` so the near half keeps blocks ``[:boundary]``.

    Returns ``(near, far)``; fixed keys are copied to their scheme-assigned
    half (skipped when absent)."""
    blocks = params[scheme.blocks_key]
    near: Params = {scheme.blocks_key: blocks[:boundary]}
    far: Params = {scheme.blocks_key: blocks[boundary:]}
    for k in scheme.near_keys:
        if k in params:
            near[k] = params[k]
    for k in scheme.far_keys:
        if k in params:
            far[k] = params[k]
    return near, far


def merge_params(near: Params, far: Params, scheme: SplitScheme) -> Params:
    """Inverse of :func:`split_params` — lossless for any boundary."""
    merged: Params = {scheme.blocks_key: list(near[scheme.blocks_key])
                      + list(far[scheme.blocks_key])}
    for k in scheme.near_keys:
        if k in near:
            merged[k] = near[k]
    for k in scheme.far_keys:
        if k in far:
            merged[k] = far[k]
    return merged
