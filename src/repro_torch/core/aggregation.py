"""FedAvg aggregation (pair: ``repro/core/aggregation.py``).

``weighted_average_cohorts`` (``:46``): each cohort's merged trees carry a
leading client axis; the average weights client k by ``N_k / N`` over the
union of all cohorts (Eq. 1). ``weighted_average`` (``:15``): the async
engine's merge of whole trees, one per speed group.
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


def weighted_average_cohorts(stacked_trees: list[Params], weights: list) -> Params:
    """Weighted average across several stacked trees (one per cohort).

    Same order of operations as ``repro/core/aggregation.py:31-53``: per
    cohort ``tensordot(w, x)`` in fp32, partial sums added in cohort order,
    one division by the total weight at the end, cast back to the leaf's
    dtype."""
    like = stacked_trees[0]
    device = tree_leaves(like)[0].device
    ws = [torch.as_tensor(w, dtype=torch.float32, device=device) for w in weights]
    total = ws[0].sum()
    for w in ws[1:]:
        total = total + w.sum()

    def partial(w):
        return lambda x: torch.tensordot(w, x.float(), dims=1)

    acc = tree_map(partial(ws[0]), stacked_trees[0])
    for tree, w in zip(stacked_trees[1:], ws[1:]):
        acc = tree_map(lambda a, x, p=partial(w): a + p(x), acc, tree)
    return tree_map(lambda a, x: (a / total).to(x.dtype), acc, like)

