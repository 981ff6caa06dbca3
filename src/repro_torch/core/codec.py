"""Communication codecs: what actually travels on DTFL's three wires.

Pair: ``repro/core/codec.py:1``. A :class:`Codec` round-trips (encode then
decode) the activation uplink ``z``, the client-model download and the
client-update upload, and :func:`wire_sizes` prices those wires for the
time model and the scheduler (numpy, verbatim).

Tensor convention: ``rt`` takes a tensor whose LEADING axis holds the wire
tensors, one per row — the cohort's client axis for ``z`` and for the
upload (``jax.vmap`` over ``codec.tree_rt`` at ``codec.py:227`` and inside
the vmapped step at ``fed/dtfl.py:136``). The download wire has no client
axis (``fed/dtfl.py:167``): ``tree_down_rt`` sends each leaf as one row.
The int8 codec sends a CUDA tensor through the K1 kernel and a CPU tensor
through its plain version; there is no switch between them.

``TopKCodec`` is stateful: the client keeps what its upload did not send
(error feedback) and adds it to the next upload. The trainer routes every
upload through :func:`uplink_rt` or :func:`uplink_rt_ef` over a chunk's
client axis, rows = clients; the loop plane's chunks have one client, so one
leaf is one wire tensor for every codec, as the JAX package's
``uplink_rt_one`` sends it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.tree import tree_map

FP32_BYTES = 4.0


def _is_float(x) -> bool:
    return torch.is_tensor(x) and x.is_floating_point()


class Codec:
    """Base codec: identity semantics, fp32 wire pricing."""

    name = "identity"
    is_identity = True
    stateful = False          # True => uploads carry client-held error feedback

    # ---- tensor path ----
    def rt(self, x):
        """Round-trip each row of ``x`` (leading axis) through the wire."""
        return x

    def tree_rt(self, tree):
        if self.is_identity:
            return tree
        return tree_map(self.rt, tree)

    def down_rt(self, x):
        """Round-trip for the server->client DOWNLOAD wire. Defaults to
        :meth:`rt`."""
        return self.rt(x)

    def tree_down_rt(self, tree):
        """Download wire over a tree WITHOUT a client axis: each leaf is one
        wire tensor."""
        if self.is_identity:
            return tree
        return tree_map(lambda x: self.down_rt(x[None])[0], tree)

    def rt_ef(self, x, e):
        """Error-feedback round trip of each row: compress ``x + e``; the
        unsent part is the next residual."""
        s = x + e
        d = self.rt(s)
        return d, s - d

    def tree_rt_ef(self, tree, ef):
        """:meth:`rt_ef` leaf-wise: ``(sent tree, new residual tree)``."""
        pairs = tree_map(self.rt_ef, tree, ef)
        return (tree_map(lambda _, p: p[0], tree, pairs),
                tree_map(lambda _, p: p[1], tree, pairs))

    # ---- wire pricing (numpy, analytic — never runs the codec) ----
    def nbytes(self, n_elems):
        """Wire bytes for a float tensor (or per-wire aggregate) of
        ``n_elems`` elements. Vectorized over numpy arrays of counts."""
        return FP32_BYTES * np.asarray(n_elems, float)

    def down_nbytes(self, n_elems):
        """Download-wire bytes (matches :meth:`down_rt`'s transform)."""
        return self.nbytes(n_elems)


class IdentityCodec(Codec):
    pass


class Bf16Codec(Codec):
    """Truncate float tensors to bfloat16 on the wire (2 bytes/element)."""

    name = "bf16"
    is_identity = False

    def rt(self, x):
        if not _is_float(x):
            return x
        return x.to(torch.bfloat16).to(x.dtype)

    def nbytes(self, n_elems):
        return 2.0 * np.asarray(n_elems, float)


class Int8Codec(Codec):
    """Int8 quantization with one scale per wire tensor (per row):
    s = max|x|/127, q = round(x/s), through ``kernels/quantize.py``."""

    name = "int8"
    is_identity = False

    def rt(self, x):
        if not _is_float(x):
            return x
        from repro_torch.kernels.quantize import int8_roundtrip_rows

        rows = x.reshape(x.shape[0], -1).contiguous()
        return int8_roundtrip_rows(rows).reshape(x.shape)

    def nbytes(self, n_elems):
        # 1 byte/element + one fp32 scale per wire
        return np.asarray(n_elems, float) + FP32_BYTES


class TopKCodec(Codec):
    """Magnitude top-k sparsification with client-held error feedback
    (pair: ``repro/core/codec.py:154``).

    Keeps the ``ceil(frac * n)`` largest-|x| entries of each row, n being
    one row's element count (value + index on the wire: 8 bytes each), and
    zeroes the rest; with rows = clients this is ``jax.vmap`` over the JAX
    package's per-tensor ``rt``. The download wire is not sparsified
    (``down_rt`` is the identity, priced dense): error feedback lives on the
    client and cannot make up for a truncated broadcast.

    Ties: ``torch.topk`` and ``jax.lax.top_k`` may keep different entries
    among equal |x| at the k-th magnitude. Ties at |x| = 0 change nothing:
    the kept value and the residual are zero either way.
    """

    is_identity = False
    stateful = True

    def __init__(self, frac: float):
        if not (0.0 < frac <= 1.0):
            raise ValueError(f"topk fraction must be in (0, 1], got {frac}")
        self.frac = float(frac)
        self.name = f"topk{self.frac:g}"

    def _k(self, n: int) -> int:
        return max(1, int(math.ceil(self.frac * n)))

    def rt(self, x):
        if not _is_float(x):
            return x
        rows = x.reshape(x.shape[0], -1)
        k = self._k(rows.shape[1])
        if k >= rows.shape[1]:
            return x
        _, idx = torch.topk(rows.float().abs(), k, dim=1)
        out = torch.zeros_like(rows).scatter_(1, idx, rows.gather(1, idx))
        return out.reshape(x.shape)

    def down_rt(self, x):
        return x          # dense broadcast (see class docstring)

    def nbytes(self, n_elems):
        n = np.asarray(n_elems, float)
        k = np.maximum(1.0, np.ceil(self.frac * n))
        return 8.0 * k   # fp32 value + int32 index per kept entry

    def down_nbytes(self, n_elems):
        return FP32_BYTES * np.asarray(n_elems, float)   # dense download


def _parse_topk(s: str) -> "float | None":
    """``topk<frac>`` / ``topk:<frac>`` with frac in (0, 1], as
    ``repro/registry.py:281-288`` parses it; None if ``s`` is not one."""
    try:
        frac = float(s[4:].lstrip(":"))
    except ValueError:
        return None
    return frac if 0.0 < frac <= 1.0 else None


def make_codec(spec: "Codec | str | None") -> Codec:
    """Resolve a codec spec: None | 'identity' | 'bf16' | 'int8' |
    'topk<frac>' (e.g. ``topk0.05``) | a Codec."""
    if spec is None:
        return IdentityCodec()
    if isinstance(spec, Codec):
        return spec
    s = str(spec).strip().lower()
    if s in ("identity", "none", ""):
        return IdentityCodec()
    if s == "bf16":
        return Bf16Codec()
    if s == "int8":
        return Int8Codec()
    if s.startswith("topk") and _parse_topk(s) is not None:
        return TopKCodec(_parse_topk(s))
    raise ValueError(f"unknown codec {spec!r}; choose identity | bf16 | int8 | "
                     "topk<frac> (e.g. topk0.05)")


# ---------------------------------------------------------------------------
# upload-wire helper
# ---------------------------------------------------------------------------

def uplink_rt(codec: Codec, trained, ref):
    """Client-update upload wire over a cohort: ``trained`` has a leading
    client axis, ``ref`` is the single downloaded reference every member
    started from. The update is sent as a delta, codec'd per client, and
    reconstructed server-side as ``ref + decode(encode(trained - ref))``."""
    if codec.is_identity:
        return trained
    delta = tree_map(lambda t, r: t - r[None], trained, ref)
    dec = codec.tree_rt(delta)
    return tree_map(lambda r, d: r[None] + d, ref, dec)


def uplink_rt_ef(codec: Codec, trained, ref, ef):
    """:func:`uplink_rt` with client-held error feedback: ``ef`` (leading
    client axis) is what each client failed to send last round; returns the
    reconstructed uploads and the new residuals."""
    delta = tree_map(lambda t, r: t - r[None], trained, ref)
    dec, ef2 = codec.tree_rt_ef(delta, ef)
    return tree_map(lambda r, d: r[None] + d, ref, dec), ef2


# ---------------------------------------------------------------------------
# analytic wire sizes (threaded through timemodel + scheduler profiling)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class WireSizes:
    """Codec-true bytes for every wire of a round, per tier.

    ``z_bytes[m]``    — per-batch activation(+label) uplink; labels ride raw.
    ``down_bytes[m]`` — per-round client-model (+aux head) download.
    ``up_bytes[m]``   — per-round client-update upload (delta coding).
    ``full_down`` / ``full_up`` — the full-model baselines' two wires.

    Identity reproduces the legacy analytic accounting bit-for-bit: split
    training prices z + amortized download (the paper's ``D_size``; upload
    unpriced, as in Eq. 5), full-model baselines price download + upload
    (the existing ``2 * full_param_bytes``).
    """

    z_bytes: np.ndarray
    down_bytes: np.ndarray
    up_bytes: np.ndarray
    full_down: float
    full_up: float

    @property
    def param_bytes(self) -> np.ndarray:
        """Per-round parameter-wire total (download + upload) per tier."""
        return self.down_bytes + self.up_bytes

    def comm_bytes(self, tiers, n_batches) -> np.ndarray:
        """Total per-round bytes on all wires for clients at ``tiers``."""
        return (self.z_bytes[np.asarray(tiers, int)] * np.asarray(n_batches, float)
                + self.param_bytes[np.asarray(tiers, int)])

    def uplink_bytes(self, tiers, n_batches) -> np.ndarray:
        """Client->server bytes only (z uplink + update upload)."""
        return (self.z_bytes[np.asarray(tiers, int)] * np.asarray(n_batches, float)
                + self.up_bytes[np.asarray(tiers, int)])


def wire_sizes(costs, codec: "Codec | str | None" = None) -> WireSizes:
    """Build :class:`WireSizes` from a ``TierCostTable``.

    Non-identity codecs price from the table's element counts (``z_elems``,
    ``param_elems``; falls back to bytes/4 for hand-built tables); the wire
    is approximated as one tensor per wire (per-tensor overheads like int8
    scales are O(bytes_per_tensor) and negligible against the payload).
    """
    codec = make_codec(codec)
    z_id = np.asarray(costs.z_bytes, float)
    p_id = np.asarray(costs.client_param_bytes, float)
    if codec.is_identity:
        return WireSizes(
            z_bytes=z_id.copy(), down_bytes=p_id.copy(),
            up_bytes=np.zeros_like(p_id),
            full_down=float(costs.full_param_bytes),
            full_up=float(costs.full_param_bytes),
        )
    have_elems = getattr(costs, "z_elems", None) is not None
    z_elems = (np.asarray(costs.z_elems, float) if have_elems
               else z_id / FP32_BYTES)
    label_b = float(costs.label_bytes) if have_elems else 0.0
    p_elems = (np.asarray(costs.param_elems, float)
               if getattr(costs, "param_elems", None) is not None
               else p_id / FP32_BYTES)
    f_elems = (float(costs.full_param_elems) if getattr(costs, "full_param_elems", 0)
               else float(costs.full_param_bytes) / FP32_BYTES)
    return WireSizes(
        z_bytes=codec.nbytes(z_elems) + label_b,
        down_bytes=codec.down_nbytes(p_elems),
        up_bytes=codec.nbytes(p_elems),
        full_down=float(codec.down_nbytes(f_elems)),
        full_up=float(codec.nbytes(f_elems)),
    )
