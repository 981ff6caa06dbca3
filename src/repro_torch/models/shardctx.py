"""Activation-sharding context (pair: ``repro/models/shardctx.py:1``).

The JAX package's launcher constrains activation layouts through this
context (``constrain(x, "act")`` at the model's seams becomes a
``with_sharding_constraint``). The port's models place nothing: a step
runs whole on one device, and a mesh is a description the dry-run reckons
bytes over (``launch/specs.py``). So here the context only records the
specs and the non-sharding settings that ride it (``get_setting``), and
``constrain`` returns its input unchanged, inside a context or not.
"""
from __future__ import annotations

import contextlib

_SPECS: dict[str, object] = {}


@contextlib.contextmanager
def activation_sharding(**specs):
    """e.g. ``activation_sharding(act=("data", None, "model"))``; the specs
    are visible to ``get_setting`` inside the block."""
    global _SPECS
    old = dict(_SPECS)
    _SPECS.update(specs)
    try:
        yield
    finally:
        _SPECS = old


def constrain(x, kind: str = "act"):
    """``x`` unchanged: the port's models place nothing."""
    return x


def get_setting(kind: str):
    """Non-sharding knobs riding the same context (e.g. ``"q_chunk"``)."""
    return _SPECS.get(kind)
