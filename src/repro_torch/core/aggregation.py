"""FedAvg aggregation (pair: ``repro/core/aggregation.py``).

Every plane aggregates a round as the JAX package's sharded plane does:
per cohort the fp32 ``weighted_sum`` of its clients' trees (their N_k
against the client axis), summed over the ranks on the sharded plane, and
one ``combine_weighted_sums`` (``:56-78``) over the cohorts. That is the
op order of the JAX package's ``weighted_average_cohorts`` (``:46``), so
the N_k/N average of Eq. 1 comes out bit for bit on every plane at one
rank. ``weighted_average`` (``:15``): the async engine's merge of whole
trees, one per speed group; ``uniform_average`` (``:27``) and
``aggregate_dtfl_round`` (``:81``) average whole trees and per-client
halves.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map

Params = dict


def weighted_average(trees: list[Params], weights: list[float]) -> Params:
    """``sum_i w_i tree_i`` with the weights normalised to sum 1, as
    ``repro/core/aggregation.py:15-25``: an fp32 ``tensordot`` of the
    weights over the stacked leaves, cast back to the first tree's dtype.
    The result is new tensors; no input is written."""
    device = tree_leaves(trees[0])[0].device
    w = torch.as_tensor(weights, dtype=torch.float32, device=device)
    w = w / w.sum()

    def avg(*leaves):
        stacked = torch.stack([x.float() for x in leaves])
        return torch.tensordot(w, stacked, dims=1).to(leaves[0].dtype)

    return tree_map(avg, *trees)


def uniform_average(trees: list[Params]) -> Params:
    """``weighted_average`` with every tree weighted 1."""
    return weighted_average(trees, [1.0] * len(trees))


def weighted_sum(tree, weights):
    """Contract a tree's leading client axis against ``weights`` in fp32:
    ``tensordot(w, x.float())`` (``repro/fed/execplan.py:191-200``), a
    cohort's partial of the weighted average."""
    device = tree_leaves(tree)[0].device
    w = torch.as_tensor(weights, dtype=torch.float32, device=device)
    return tree_map(lambda x: torch.tensordot(w, x.float(), dims=1), tree)


def combine_weighted_sums(sums: list[Params], totals: list, like: Params) -> Params:
    """The global weighted average from per-cohort weighted SUMS
    (``weighted_sum``, all-reduced on the sharded plane) and weight totals:
    totals added in cohort order, sums added in cohort order, one
    division, each leaf cast to ``like``'s dtype
    (``repro/core/aggregation.py:56-78``)."""
    device = tree_leaves(sums[0])[0].device
    totals = [torch.as_tensor(t, dtype=torch.float32, device=device) for t in totals]
    total = totals[0]
    for t in totals[1:]:
        total = total + t
    acc = sums[0]
    for s in sums[1:]:
        acc = tree_map(lambda a, x: a + x, acc, s)
    return tree_map(lambda a, p: (a / total).to(p.dtype), acc, like)


def aggregate_dtfl_round(cfg, tier_states: list[tuple[int, Params, Params]],
                         weights: list[float]) -> Params:
    """``tier_states``: [(tier, client_params, server_params)] per client,
    one model each (no client axis); each pair merged back into a full
    tree, then ``weighted_average`` (``repro/core/aggregation.py:81-87``)."""
    from repro_torch.core import tiering

    fulls = [tiering.merge_params(c, s) for _, c, s in tier_states]
    return weighted_average(fulls, weights)
