"""Federated data partitioning: IID and Dirichlet label-skew non-IID.

Verbatim copy of ``repro/data/partition.py:1``.

The paper (Appendix A.4) uses a Dirichlet distribution with concentration
0.5 and a fixed seed; Table 7 shows the resulting per-client label counts.
"""
from __future__ import annotations

import numpy as np


def iid_partition(labels: np.ndarray, n_clients: int, seed: int = 0) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(labels))
    return [np.sort(part) for part in np.array_split(idx, n_clients)]


def dirichlet_partition(
    labels: np.ndarray, n_clients: int, alpha: float = 0.5, seed: int = 0,
    min_size: int = 2, max_tries: int = 100,
) -> list[np.ndarray]:
    """Label-skew partition: for each class, split its samples across clients
    with Dirichlet(alpha) proportions (He et al. 2020b / paper A.4).

    The ``min_size`` rejection loop is bounded: each attempt reseeds
    deterministically (attempt 0 draws exactly what an unbounded loop's
    first pass drew, so existing partitions are unchanged), and after
    ``max_tries`` failures a clear error replaces the old infinite spin —
    with few samples or many clients the constraint can be unsatisfiable.
    """
    if n_clients * min_size > len(labels):
        raise ValueError(
            f"dirichlet_partition: {n_clients} clients x min_size {min_size} "
            f"needs >= {n_clients * min_size} samples, got {len(labels)}")
    n_classes = int(labels.max()) + 1
    for attempt in range(max_tries):
        rng = np.random.default_rng(seed + 1_000_003 * attempt)
        parts: list[list[int]] = [[] for _ in range(n_clients)]
        for c in range(n_classes):
            idx_c = np.flatnonzero(labels == c)
            rng.shuffle(idx_c)
            props = rng.dirichlet([alpha] * n_clients)
            cuts = (np.cumsum(props) * len(idx_c)).astype(int)[:-1]
            for k, chunk in enumerate(np.split(idx_c, cuts)):
                parts[k].extend(chunk.tolist())
        if min(len(p) for p in parts) >= min_size:
            return [np.sort(np.array(p)) for p in parts]
    raise ValueError(
        f"dirichlet_partition: no partition with min_size={min_size} after "
        f"{max_tries} attempts (n={len(labels)}, n_clients={n_clients}, "
        f"alpha={alpha}); lower min_size/n_clients or raise max_tries")


def label_histogram(labels: np.ndarray, parts: list[np.ndarray]) -> np.ndarray:
    n_classes = int(labels.max()) + 1
    return np.stack([np.bincount(labels[p], minlength=n_classes) for p in parts])
