"""Leaf-wise copies between the JAX package's trees and the port's.

The port keeps the JAX package's tree layout (same keys, HWIO conv
weights), so a parameter tree or a per-tier aux head moves across as numpy
arrays, one leaf at a time. The JAX side converts with
``jax.tree.map(np.asarray, tree)``; nothing here imports JAX.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.tree import tree_map


def from_numpy_tree(tree: Any, device: "str | torch.device") -> Any:
    """numpy (or array-like) leaves -> torch tensors on ``device``, copied,
    dtype kept."""
    return tree_map(lambda a: torch.tensor(np.asarray(a), device=device), tree)


def to_numpy_tree(tree: Any) -> Any:
    """torch tensor leaves -> numpy arrays on the host."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
