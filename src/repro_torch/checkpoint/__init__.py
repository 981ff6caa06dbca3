"""Pytree checkpointing via .npz (pair: ``repro/checkpoint/__init__.py``).

Flattens arbitrary dict/list/tuple/NamedTuple trees with '/'-joined key
paths; restores exact structure from a treedef-free path encoding. Scalars,
numpy arrays and torch tensors (``t.detach().cpu().numpy()``) are stored;
dtypes preserved. The file format, the key paths and the ``__empty__``
marker are the JAX package's, so either package loads the other's envelope.

NamedTuples are encoded with their import path (``n[module.QualName]:i``).
A port class ``repro_torch.<module>.<Cls>`` is written under the JAX
package's tag ``n[repro.<module>.<Cls>]``, and on load a ``repro.`` tag is
resolved by name to ``repro_torch.<module>.<Cls>``: the port never imports
the JAX package. A tag with no counterpart in the port raises.

numpy has no bfloat16 (``np.savez`` of an ``ml_dtypes.bfloat16`` array
loads back as raw ``|V2``), so a bf16 leaf is refused.

Also hosts :func:`pack_rng` / :func:`unpack_rng`: lossless (de)serialization
of ``np.random.Generator`` (PCG64) state as a uint64 vector, used by the
resumable-training envelope so a resumed run continues the exact participant
sampling stream of an uninterrupted one.
"""
from __future__ import annotations

import importlib
import os
import tempfile
from typing import Any

import numpy as np
import torch

_PORT, _REF = "repro_torch", "repro"


def _nt_tag(tree) -> str:
    cls = type(tree)
    mod = cls.__module__
    if mod == _PORT or mod.startswith(_PORT + "."):
        mod = _REF + mod[len(_PORT):]      # written as the JAX package names it
    return f"n[{mod}.{cls.__qualname__}]"


# marker child recording an EMPTY container — without it an empty dict/list/
# tuple field contributes no paths and silently vanishes (shifting NamedTuple
# fields) on load. Collides only with a literal dict key "__empty__".
_EMPTY = "__empty__"


def _leaf(x) -> np.ndarray:
    if torch.is_tensor(x):
        if x.dtype == torch.bfloat16:
            raise TypeError("checkpoint: a bfloat16 tensor cannot be stored "
                            "(numpy has no bfloat16); cast it to float32 first")
        x = x.detach().cpu().numpy()
    a = np.asarray(x)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        raise TypeError(f"checkpoint: leaf dtype {a.dtype} cannot be stored "
                        "(numpy has no bfloat16); cast it to float32 first")
    return a


def _flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    out: dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        if not tree:
            out[f"{prefix}d:{_EMPTY}"] = np.zeros(0, np.uint8)
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}d:{k}/"))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):  # NamedTuple
        tag = _nt_tag(tree)
        if not tree:
            out[f"{prefix}{tag}:{_EMPTY}"] = np.zeros(0, np.uint8)
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{tag}:{i}/"))
    elif isinstance(tree, (list, tuple)):
        tag = "l" if isinstance(tree, list) else "t"
        if not tree:
            out[f"{prefix}{tag}:{_EMPTY}"] = np.zeros(0, np.uint8)
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{tag}:{i}/"))
    else:
        out[prefix.rstrip("/")] = _leaf(tree)
    return out


def _resolve_namedtuple(path: str):
    """The port's class for tag ``path``: ``repro.<module>.<Cls>`` resolves
    to ``repro_torch.<module>.<Cls>``, by name."""
    if path == _REF or path.startswith(_REF + "."):
        path = _PORT + path[len(_REF):]
    mod, _, qual = path.rpartition(".")
    try:
        obj = importlib.import_module(mod)
        for part in qual.split("."):
            obj = getattr(obj, part)
    except (ImportError, AttributeError):
        raise ValueError(f"checkpoint: NamedTuple tag {path!r} has no class in "
                         "this package to load it into") from None
    return obj


def _unflatten(flat: dict[str, np.ndarray]) -> Any:
    if list(flat) == [""]:
        return flat[""]

    def insert(node: dict, parts: list[str], value):
        head, rest = parts[0], parts[1:]
        if rest:
            node = node.setdefault(head, {})
            insert(node, rest, value)
        else:
            node[head] = value

    root: dict = {}
    for k, v in flat.items():
        insert(root, k.split("/"), v)

    def build(node):
        if not isinstance(node, dict):
            return node
        kinds = {k.split(":", 1)[0] for k in node}
        assert len(kinds) == 1, f"mixed node kinds: {sorted(node)}"
        kind = kinds.pop()
        if set(node) == {f"{kind}:{_EMPTY}"}:
            seq = []                       # empty-container marker
        elif kind == "d":
            return {k.split(":", 1)[1]: build(v) for k, v in node.items()}
        else:
            items = sorted(node.items(), key=lambda kv: int(kv[0].split(":", 1)[1]))
            seq = [build(v) for _, v in items]
        if kind == "d":
            return {}
        if kind == "l":
            return seq
        if kind == "t":
            return tuple(seq)
        assert kind.startswith("n[") and kind.endswith("]"), f"bad node kind {kind!r}"
        cls = _resolve_namedtuple(kind[2:-1])
        return cls(*seq)

    return build(root)


def save(path: str, tree: Any) -> None:
    flat = _flatten(tree)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    # atomic write
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def load(path: str) -> Any:
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    return _unflatten(flat)


# ---------------------------------------------------------------------------
# numpy Generator state <-> uint64 vector (for resumable training envelopes)
# ---------------------------------------------------------------------------

_MASK64 = (1 << 64) - 1


def pack_rng(gen: np.random.Generator) -> np.ndarray:
    """Serialize a PCG64 Generator's full state as shape-(6,) uint64."""
    st = gen.bit_generator.state
    if st["bit_generator"] != "PCG64":
        raise ValueError(f"only PCG64 generators supported, got {st['bit_generator']}")
    s, inc = st["state"]["state"], st["state"]["inc"]
    return np.array(
        [s >> 64, s & _MASK64, inc >> 64, inc & _MASK64,
         st["has_uint32"], st["uinteger"]],
        dtype=np.uint64,
    )


def unpack_rng(arr) -> np.random.Generator:
    """Rebuild the Generator serialized by :func:`pack_rng` (exact stream)."""
    a = [int(x) for x in np.asarray(arr).reshape(-1)]
    gen = np.random.default_rng(0)
    gen.bit_generator.state = {
        "bit_generator": "PCG64",
        "state": {"state": (a[0] << 64) | a[1], "inc": (a[2] << 64) | a[3]},
        "has_uint32": a[4], "uinteger": a[5],
    }
    return gen
