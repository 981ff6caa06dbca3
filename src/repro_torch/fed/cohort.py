"""Tier-cohort round engine (pair: ``repro/fed/cohort.py:1``).

Participants are grouped into *cohorts* by (tier, per-batch sample shape);
each client's local steps are materialized and stacked into
``(n_steps, n_clients, batch, ...)`` arrays; ragged cohorts are padded with
zero batches and a ``(n_steps, n_clients)`` mask gates the state update,
so padded steps leave that client untouched. ``build_cohorts``,
``chunk_slices`` and ``slice_clients`` are verbatim copies.

``run_cohort`` replaces the JAX package's ``vmap`` + ``scan``
(``cohort.py:151-169``): a Python loop over steps on an explicit client
axis, with ``torch.where`` on the (C,) step mask in place of
``tree_select``. The step function itself takes the client axis, so a
hand-written kernel inside it sees the whole cohort in one launch.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.data.pipeline import materialize_round
from repro_torch.tree import tree_map


@dataclass
class Cohort:
    """One (tier, batch-shape) group of a round's participants."""

    tier: int
    cids: list[int]                # participant ids, stacking order
    batches: dict                  # name -> (n_steps, n_clients + n_pad, batch, ...)
    mask: np.ndarray               # (n_steps, n_clients + n_pad) bool; False = padded
    n_pad: int = 0                 # trailing pad clients (sharded divisibility)

    @property
    def size(self) -> int:
        return len(self.cids)

    def client_weights(self, clients) -> np.ndarray:
        """(size + n_pad,) f32 aggregation weights: N_k for real members, 0
        for pad clients — so on-device weighted sums ignore padding exactly."""
        w = [float(len(clients[k].dataset)) for k in self.cids] + [0.0] * self.n_pad
        return np.asarray(w, np.float32)


def build_cohorts(
    clients, cids: list[int], tier_of: dict[int, int], r: int, local_epochs: int,
    *, pad_multiple: int = 1,
) -> list[Cohort]:
    """Group ``cids`` into cohorts and stack their round-``r`` batches.

    ``tier_of`` maps cid -> tier (use a constant for untired full-model
    training). Batches come from ``materialize_round`` so they are
    bit-identical to what the sequential loop would consume.

    ``pad_multiple > 1`` (the sharded plane's mesh axis size) pads each
    cohort's client axis with zero-batch / all-False-mask / weight-0 pad
    clients up to the next multiple, so ``shard_map`` can split the axis
    evenly; pad clients never touch state (mask) or aggregation (weight).
    """
    per_client = {k: materialize_round(clients[k].dataset, r, local_epochs) for k in cids}
    groups: dict[tuple, list[int]] = {}
    for k in cids:
        arrs = per_client[k]
        shape_key = tuple(sorted((name, a.shape[1:]) for name, a in arrs.items()))
        groups.setdefault((tier_of[k], shape_key), []).append(k)

    cohorts = []
    for (tier, _), members in groups.items():
        steps = np.array([len(next(iter(per_client[k].values()))) for k in members])
        s_max = int(steps.max())
        n_pad = (-len(members)) % max(1, int(pad_multiple))
        names = per_client[members[0]].keys()
        batches = {}
        for name in names:
            stacked = np.stack(
                [_pad_steps(per_client[k][name], s_max) for k in members], axis=1
            )  # (S, C, batch, ...)
            if n_pad:
                zeros = np.zeros(
                    (s_max, n_pad) + stacked.shape[2:], stacked.dtype
                )
                stacked = np.concatenate([stacked, zeros], axis=1)
            batches[name] = stacked
        steps_padded = np.concatenate([steps, np.zeros(n_pad, steps.dtype)])
        mask = np.arange(s_max)[:, None] < steps_padded[None, :]  # (S, C + pad)
        cohorts.append(Cohort(tier, members, batches, mask, n_pad))
    return cohorts


def chunk_slices(n_cols: int, chunk_size: int) -> list[slice]:
    """Client-axis slices cutting a padded cohort into fixed-size chunks.

    The chunked ExecPlan builds cohorts with ``pad_multiple=chunk_size``, so
    ``n_cols`` (real + pad clients) is always divisible and every chunk has
    the same static shape — one compiled per-chunk program serves them all.
    """
    if n_cols % chunk_size:
        raise ValueError(
            f"cohort client axis {n_cols} is not a multiple of chunk_size "
            f"{chunk_size}; build cohorts with pad_multiple=chunk_size")
    return [slice(i, i + chunk_size) for i in range(0, n_cols, chunk_size)]


def slice_clients(batches: dict, mask: np.ndarray, sl: slice) -> tuple[dict, np.ndarray]:
    """One client-chunk's view of a cohort's stacked batches + step mask."""
    return {k: v[:, sl] for k, v in batches.items()}, mask[:, sl]


def _pad_steps(a: np.ndarray, s_max: int) -> np.ndarray:
    if len(a) == s_max:
        return a
    pad = np.zeros((s_max - len(a),) + a.shape[1:], a.dtype)
    return np.concatenate([a, pad])


# ---------------------------------------------------------------------------
# the cohort program
# ---------------------------------------------------------------------------

def broadcast_state(state, n: int):
    """Replicate a single-client state tree along a new leading axis.
    Non-tensor leaves (a learning rate) are shared, not replicated."""
    def rep(x):
        if not torch.is_tensor(x):
            return x
        return x.unsqueeze(0).expand((n,) + tuple(x.shape)).contiguous()

    return tree_map(rep, state)


def tree_select(mask: torch.Tensor, new, old):
    """Per-client select: tensor leaves have a leading client axis; mask is
    (C,) bool. Non-tensor leaves are taken from ``new``."""
    def sel(n, o):
        if not torch.is_tensor(n):
            return n
        return torch.where(mask.reshape(mask.shape + (1,) * (n.ndim - 1)), n, o)

    return tree_map(sel, new, old)


def run_cohort(step_fn, state, batches: dict, mask: np.ndarray):
    """Broadcast a SINGLE client's initial ``state`` across the cohort and
    run ``step(state, batch) -> (state, out)`` over the stacked steps.

    ``batches``: name -> (S, C, ...) tensors on the state's device; ``mask``:
    (S, C) bool numpy. A step whose mask is all True takes the new state as
    it is (``torch.where`` would return it unchanged); otherwise masked
    (padded) steps leave that client's state untouched, and a step whose
    mask is all False (a chunk whose clients have all run out of batches)
    is not run. Returns the final state and the list of the run steps'
    outputs."""
    n_steps, n_clients = mask.shape
    state = broadcast_state(state, n_clients)
    device = next(iter(batches.values())).device
    outs = []
    for s in range(n_steps):
        if not mask[s].any():
            continue
        new_state, out = step_fn(state, {k: v[s] for k, v in batches.items()})
        if mask[s].all():
            state = new_state
        else:
            state = tree_select(torch.from_numpy(mask[s]).to(device), new_state, state)
        outs.append(out)
    return state, outs
