"""FedAvg aggregation across cohorts (pair: ``repro/core/aggregation.py:46``).

Each cohort's merged trees carry a leading client axis; the average weights
client k by ``N_k / N`` over the union of all cohorts (Eq. 1).
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map

Params = dict


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

