"""Activation-sharding context (pair: ``repro/models/shardctx.py:1``).

The JAX package's launcher constrains activation layouts through this
context (``constrain(x, "act")`` at the model's seams becomes a
``with_sharding_constraint``). The port's counterpart is a ``DTensor``
redistribute: inside a context, ``constrain(x, kind)`` moves a ``DTensor``
to the placements of the ``kind`` spec on its device mesh, and leaves a
plain tensor unchanged. Only the dry-run's sharded trace
(``launch/sharded.py``) hands the models ``DTensor``s; the trainers,
serving and a one-card trace see plain tensors, and no change.

A spec is a tuple of mesh axis names, one entry a dimension (``None``:
replicated; a tuple of names: split over all of them), over a tensor's
trailing dimensions: a leading client axis, which the JAX package's
tensors lack, is replicated (``repro_torch/sharding.py::placements``). The
context also carries the non-sharding settings that ride it
(``get_setting``).
"""
from __future__ import annotations

import contextlib

from torch.distributed.tensor import DTensor

from repro_torch.sharding import placements

_SPECS: dict[str, object] = {}


@contextlib.contextmanager
def activation_sharding(**specs):
    """e.g. ``activation_sharding(act=("data", None, "model"))``; the specs
    are visible to ``constrain`` and ``get_setting`` inside the block."""
    global _SPECS
    old = dict(_SPECS)
    _SPECS.update(specs)
    try:
        yield
    finally:
        _SPECS = old


def constrain(x, kind: str = "act"):
    """``x`` redistributed to the ``kind`` spec when ``x`` is a ``DTensor``
    and the context holds that spec; else ``x`` unchanged."""
    spec = _SPECS.get(kind)
    if spec is None or not isinstance(x, DTensor):
        return x
    want = placements(spec, x.ndim, x.device_mesh)
    return x if tuple(x.placements) == want else x.redistribute(x.device_mesh, want)


def get_setting(kind: str):
    """Non-sharding knobs riding the same context (e.g. ``"q_chunk"``)."""
    return _SPECS.get(kind)
