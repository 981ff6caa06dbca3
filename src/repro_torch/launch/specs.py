"""Sharding specs of every (arch x input shape), reckoned and not run
(pair: ``repro/launch/specs.py:1``).

The JAX package hands these specs to ``jax.jit``. The port places nothing:
a spec here is a plain tuple of mesh axis names, one entry a dimension
(``None``: replicated; a tuple of names: split over all of them), and
:func:`bytes_per_device` reckons what a tree's leaves would take on each
card of a ``launch/mesh.py::Mesh`` under them. The rules are the JAX
package's:

  * batch            -> the data axes (when the global batch is >= 16)
  * Megatron axis    -> "model": attention heads / FFN width / vocab / experts
  * FSDP axis        -> "data" on the other weight dim
  * activations      -> (batch -> data axes, d_model -> "model")
  * KV caches        -> (batch -> data, head_dim -> "model")

The port's trees carry a leading client axis on every tensor (the step
functions run one client, C = 1): every spec is taken over a leaf's
shape after that axis, and so equals the JAX package's spec of the same
leaf. A cache leaf's client axis stands where the JAX package stacks its
layers, so a cache spec's first entry, the JAX package's layer axis, is
dropped.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.launch.mesh import Mesh, data_axes
from repro_torch.models import model as M
from repro_torch.tree import tree_leaves, tree_map_with_path

Spec = tuple

# weight-name classes for the sharding rules
_COL = {"wq", "wk", "wv", "w1", "w3", "w_up", "w_gate", "w_in", "w_dt", "w", "proj"}
_ROW = {"wo", "w2", "w_down", "w_out"}
_REPL = {"conv", "a_log", "d_skip", "b_dt", "b_if", "b", "r", "w_bc", "router"}


def _is_spec(x) -> bool:
    """A spec: a plain tuple of None, axis names or tuples of axis names."""
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        a is None or isinstance(a, str)
        or (isinstance(a, tuple) and all(isinstance(n, str) for n in a)) for a in x)


def _name(path: tuple) -> "str | None":
    """The last dict key on ``path`` (sequence indices are skipped)."""
    return next((p for p in reversed(path) if isinstance(p, str)), None)


# ===========================================================================
# parameter shardings
# ===========================================================================

def param_pspec(path: tuple, shape: tuple) -> Spec:
    """The spec of a parameter of ``shape`` (one model's, no client axis)
    named by the last key of ``path``."""
    name = _name(path)
    nd = len(shape)
    lead = (None,) * (nd - 2)

    if name == "embed":
        return ("model", "data")
    if name == "lm_head":
        return ("data", "model")
    if name == "front_proj":
        return (None, None)
    if name in ("we1", "we3"):          # (L, E, D, F): experts on model, FSDP on D
        return (None, "model", "data", None)
    if name == "we2":                    # (L, E, F, D)
        return (None, "model", None, "data")
    if name in _REPL or nd < 2:
        return (None,) * nd
    if name in _COL:
        return (*lead, "data", "model")
    if name in _ROW:
        return (*lead, "model", "data")
    return (None,) * nd


def _drop_indivisible(spec: Spec, shape: tuple, mesh: Mesh) -> Spec:
    """Drop mesh axes that don't divide their dimension (the JAX package's
    jit in_shardings need exact divisibility): vocab 51,865 / 32,001 /
    49,155 fall back to an unsharded vocab."""
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    fixed = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if ax is None:
            fixed.append(None)
            continue
        n = 1
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            n *= sizes[a]
        fixed.append(ax if dim % n == 0 else None)
    return tuple(fixed)


def _strip_fsdp(spec: Spec) -> Spec:
    """Serving params: drop the 'data' (FSDP) axis so weight shards stay
    resident — decode cannot afford per-token weight regathers."""
    return tuple(None if ax == "data" else ax for ax in spec)


def tree_pspecs(tree, mesh: "Mesh | None" = None, preset: str = "baseline") -> Any:
    """Specs of a parameter tree whose leaves carry the client axis."""
    def spec(path, leaf):
        s = param_pspec(path, tuple(leaf.shape[1:]))
        if preset in ("serve_dp", "serve_seq"):
            s = _strip_fsdp(s)
        return s if mesh is None else _drop_indivisible(s, tuple(leaf.shape[1:]), mesh)

    return tree_map_with_path(spec, tree)


def opt_state_pspecs(opt_state: dict, param_specs) -> dict:
    """Adam-like state: m/v mirror params; scalars replicated."""
    return {k: param_specs if k in ("m", "v", "mu") else () for k in opt_state}


# ===========================================================================
# activation / batch shardings
# ===========================================================================

def batch_axes(shape: InputShape, mesh: Mesh):
    """The mesh axes a batch dimension splits over: the data axes when the
    global batch is 16 or more, else none (None). One axis is named alone,
    as a ``PartitionSpec`` normalizes it."""
    if shape.global_batch < 16:
        return None
    axes = data_axes(mesh)
    return axes[0] if len(axes) == 1 else axes


def batch_pspecs(cfg: ArchConfig, shape: InputShape, mesh: Mesh) -> dict:
    bdim = batch_axes(shape, mesh)
    specs = {"tokens": (bdim, None), "labels": (bdim, None)}
    if cfg.frontend != "none":
        specs["frontend"] = (bdim, None, None)
    return specs


def activation_pspecs(cfg: ArchConfig, shape: InputShape, mesh: Mesh,
                      preset: str = "baseline") -> dict:
    """The JAX package's activation layouts per preset; the port records
    them (``models/shardctx.py``) and places nothing by them."""
    bdim = batch_axes(shape, mesh)
    if preset in ("serve_dp", "serve_seq"):
        return {
            "act": (bdim, None, None),
            "z": (bdim, None, None),
            "heads": None,
            "logits": (bdim, "model") if cfg.vocab % 16 == 0 else (bdim, None),
            "dec_qkv_pre": (bdim, None, "model", None),
            "dec_qkv": (bdim, None, None, None),
        }
    if preset == "megatron_sp":
        return {
            "act": (bdim, "model", None),
            "z": (bdim, "model", None),
            "heads": (bdim, None, "model", None),
            "logits": (bdim, None, "model"),
        }
    if preset == "seqpar":
        return {
            "act": (bdim, "model", None),
            "z": (bdim, "model", None),
            "heads": None,
            "kv": (bdim, "model", None, None),
            "logits": (bdim, "model", None),
            "q_chunk": shape.seq_len,
        }
    return {
        "act": (bdim, None, "model"),
        "z": (bdim, None, "model"),
        "heads": (bdim, None, "model", None),
        "logits": (bdim, None, "model"),
    }


def cache_pspec(path: tuple, leaf, *, bdim) -> Spec:
    """One cache leaf's spec over its shape after the client axis (the
    JAX package's rule on a layer-stacked leaf, its layer axis dropped)."""
    names = [p for p in path if isinstance(p, str)]
    name = names[-1] if names else ""
    nd = leaf.ndim
    if name == "pos":
        return ()
    if "mamba" in names and name == "h":      # (L, B, di, N)
        return (bdim, "model", None)
    if nd == 5:                                # (L, B, W, KV, hd)
        return (bdim, None, None, "model")
    if nd == 4:                                # states (L, B, H, dh) / conv hist
        return (bdim, None, "model")
    if nd == 3:
        return (bdim, None)
    return (None,) * (nd - 1)


def cache_pspecs(cache, shape: InputShape, mesh: Mesh, preset: str = "baseline") -> Any:
    bdim = batch_axes(shape, mesh)
    if preset in ("serve_dp", "serve_seq"):
        # serve_dp: the cache split on batch only; serve_seq: its window too,
        # over the model axis (flash-decoding)
        def spec(path, leaf):
            names = [p for p in path if isinstance(p, str)]
            name = names[-1] if names else ""
            nd = leaf.ndim
            if name == "pos":
                return ()
            if preset == "serve_seq" and nd == 5 and name in ("k", "v", "xk", "xv"):
                return (bdim, "model", None, None)
            return (bdim, *([None] * (nd - 2)))

        return tree_map_with_path(spec, cache)
    return tree_map_with_path(lambda p, l: cache_pspec(p, l, bdim=bdim), cache)


# ===========================================================================
# input stand-ins and bytes per device
# ===========================================================================

def input_specs(cfg: ArchConfig, shape: InputShape, *, device="meta") -> dict:
    """Every model input at the port's layout (a client axis of 1), on the
    meta device by default (no allocation): tokens and labels (1, B, S)
    int32 and a frontend's (1, B, P, d) bf16 embeddings; a decode step's
    token (1, B) and a cache of ``seq_len`` slots (the ``serve_window`` ring
    beyond 100,000 tokens, as the JAX package's long_500k)."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        specs = {"tokens": torch.zeros((1, B, S), dtype=torch.int32, device=device),
                 "labels": torch.zeros((1, B, S), dtype=torch.int32, device=device)}
        if cfg.frontend != "none":
            specs["frontend"] = torch.zeros(
                (1, B, cfg.n_frontend_tokens, cfg.d_frontend or cfg.d_model),
                dtype=torch.bfloat16, device=device)
        return specs
    return {"token": torch.zeros((1, B), dtype=torch.int32, device=device),
            "cache": M.init_cache(cfg, B, S, long_context=S > 100_000, device=device)}


def spec_divisor(spec: Spec, mesh: Mesh) -> int:
    """The number of cards a leaf under ``spec`` is split over."""
    n = 1
    for ax in spec:
        for a in (() if ax is None else ax if isinstance(ax, tuple) else (ax,)):
            n *= mesh.axis_size(a)
    return n


def leaves_with_specs(tree, specs) -> list[tuple]:
    """(leaf, spec) pairs of ``tree`` under ``specs`` (laid out as ``tree``;
    a spec stands for every leaf of the subtree at its place, as
    ``opt_state_pspecs``' ``()`` for a scalar)."""
    if _is_spec(specs):
        return [(leaf, specs) for leaf in tree_leaves(tree)]
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in leaves_with_specs(v, specs[k])]
    if isinstance(tree, (list, tuple)):
        return [p for v, sp in zip(tree, specs) for p in leaves_with_specs(v, sp)]
    raise ValueError(f"no spec for the leaf {tree!r}: got {specs!r}")


def bytes_per_device(tree, specs, mesh: Mesh) -> int:
    """A tree's bytes on each card: each tensor leaf's bytes over the
    product of the mesh axes of its spec (``_drop_indivisible`` keeps only
    axes that divide their dimension). Python-number leaves take none."""
    return sum(leaf.numel() * leaf.element_size() // spec_divisor(spec, mesh)
               for leaf, spec in leaves_with_specs(tree, specs) if torch.is_tensor(leaf))
