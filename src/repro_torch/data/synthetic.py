"""Synthetic datasets (the container is offline — DESIGN.md §8).

Verbatim copy of ``repro/data/synthetic.py:1``.

Two task families:

* ``ClassImageTask`` — CIFAR-shaped classification: each class has a fixed
  random template image; samples are template + Gaussian noise. Learnable by
  the paper's ResNets; "accuracy" targets in the benchmarks are defined on
  this task. Mirrors CIFAR-10/100/CINIC-10/HAM10000 by (n_classes, size).

* ``SeqTask`` — token LM task for the transformer archs: a fixed random
  ngram-ish transition table generates token streams with learnable
  next-token structure.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class ClassImageTask:
    n_classes: int = 10
    image_size: int = 32
    noise: float = 0.35
    seed: int = 0

    def templates(self) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        return rng.normal(0, 1, (self.n_classes, self.image_size, self.image_size, 3)).astype(
            np.float32
        )

    def sample(self, labels: np.ndarray, seed: int) -> np.ndarray:
        rng = np.random.default_rng(seed)
        t = self.templates()[labels]
        return (t + rng.normal(0, self.noise, t.shape)).astype(np.float32)


# named dataset variants matching the paper's four benchmarks
DATASETS = {
    "cifar10": ClassImageTask(n_classes=10),
    "cifar100": ClassImageTask(n_classes=100),
    "cinic10": ClassImageTask(n_classes=10, noise=0.5, seed=1),     # harder/noisier
    "ham10000": ClassImageTask(n_classes=7, image_size=32, seed=2),
}


@dataclass(frozen=True)
class SeqTask:
    vocab: int
    order: int = 2
    seed: int = 0

    def stream(self, n_tokens: int, seed: int) -> np.ndarray:
        """Deterministic-ish Markov stream: next = f(prev tokens) + noise."""
        rng = np.random.default_rng(self.seed)
        a = rng.integers(1, self.vocab, self.order)
        b = rng.integers(0, self.vocab)
        out = np.zeros(n_tokens + self.order, np.int64)
        out[: self.order] = rng.integers(0, self.vocab, self.order)
        noise_rng = np.random.default_rng(seed)
        noise = noise_rng.random(n_tokens) < 0.1
        rand_tok = noise_rng.integers(0, self.vocab, n_tokens)
        for t in range(n_tokens):
            nxt = (int(np.dot(a, out[t : t + self.order])) + b) % self.vocab
            out[t + self.order] = rand_tok[t] if noise[t] else nxt
        return out[self.order :].astype(np.int32)

    def batches(self, batch: int, seq: int, n_batches: int, seed: int = 0):
        for i in range(n_batches):
            s = self.stream(batch * (seq + 1), seed * 10_000 + i)
            s = s.reshape(batch, seq + 1)
            yield {"tokens": s[:, :-1], "labels": s[:, 1:]}
