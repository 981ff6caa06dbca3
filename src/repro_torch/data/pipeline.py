"""Client-local data pipeline: label pools -> shuffled minibatches.

Verbatim copy of ``repro/data/pipeline.py:1``.

A ``ClientDataset`` owns a client's partition indices, materializes samples
lazily per batch (templates + noise are regenerated deterministically from
the epoch seed, so no dataset-sized arrays are held), and yields dict batches
compatible with the training steps.
"""
from __future__ import annotations

import numpy as np

from repro_torch.data.synthetic import ClassImageTask

# Deterministic per-round epoch seeding shared by the sequential loop and the
# cohort engine: epoch e of round r draws from seed r * ROUND_SEED_STRIDE + e,
# so both execution paths consume bit-identical batches.
ROUND_SEED_STRIDE = 131


def materialize_round(dataset, r: int, local_epochs: int) -> dict:
    """All of a client's local steps for round ``r`` as stacked arrays.

    Works for any dataset exposing ``epoch(epoch_seed)``; returns a dict of
    (n_steps, batch, ...) arrays with n_steps = local_epochs * n_batches.
    """
    steps = [
        batch
        for e in range(local_epochs)
        for batch in dataset.epoch(r * ROUND_SEED_STRIDE + e)
    ]
    return {k: np.stack([s[k] for s in steps]) for k in steps[0]}


class ClientDataset:
    """Batches are FIXED-SHAPE: a client with fewer than ``batch_size``
    samples (common under Dirichlet non-IID) pads its one batch up to
    ``batch_size`` with zero samples and carries a per-sample ``mask``
    (1 real / 0 pad) that the losses honor (core/local_loss.py:
    ``token_xent(..., weight=)``). Without the padding, every odd partial
    shape became its own (tier, shape) cohort compile and defeated the
    sharded plane's padding."""

    def __init__(self, task: ClassImageTask, labels: np.ndarray, indices: np.ndarray,
                 batch_size: int, seed: int = 0):
        self.task = task
        self.labels = labels
        self.indices = indices
        self.batch_size = batch_size
        self.seed = seed

    def __len__(self) -> int:
        return len(self.indices)

    @property
    def n_batches(self) -> int:
        return max(1, len(self.indices) // self.batch_size)

    def epoch(self, epoch_seed: int):
        rng = np.random.default_rng(self.seed * 100_003 + epoch_seed)
        order = rng.permutation(self.indices)
        for i in range(self.n_batches):
            sel = order[i * self.batch_size : (i + 1) * self.batch_size]
            if len(sel) == 0:
                break
            y = self.labels[sel]
            x = self.task.sample(y, seed=int(rng.integers(1 << 31)))
            mask = np.ones(self.batch_size, np.float32)
            if len(sel) < self.batch_size:
                pad = self.batch_size - len(sel)
                x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
                y = np.concatenate([y, np.zeros(pad, y.dtype)])
                mask[len(sel):] = 0.0
            yield {"images": x, "labels": y.astype(np.int32), "mask": mask}


def make_eval_batch(task: ClassImageTask, n: int, seed: int = 1234) -> dict:
    rng = np.random.default_rng(seed)
    y = rng.integers(0, task.n_classes, n)
    x = task.sample(y, seed=seed + 1)
    return {"images": x, "labels": y.astype(np.int32)}


class SeqClientDataset:
    """Token-LM per-client dataset with the ClientDataset interface."""

    def __init__(self, task, n_batches: int, batch_size: int, seq: int, seed: int):
        self.task, self._n, self.batch_size, self.seq, self.seed = task, n_batches, batch_size, seq, seed

    def __len__(self):
        return self._n * self.batch_size

    @property
    def n_batches(self):
        return self._n

    def epoch(self, epoch_seed: int):
        yield from self.task.batches(self.batch_size, self.seq, self._n,
                                     seed=self.seed * 7919 + epoch_seed)
