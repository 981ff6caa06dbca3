"""Million-client population plane: lazy client-state store + lazy env.

Verbatim copy of ``repro/fed/population.py:1`` (``cid_rng``,
``ClientStore``, ``LazyHeteroEnv``), its profiles the port's time model's.

The dense construction path materializes every registered client up front —
a ``SimClient`` list, a profile-assignment array, a scheduler state list —
which caps the registry at ~10^3 clients. TiFL (arXiv:2001.09249) and FedAT
(arXiv:2010.05958) frame tiered FL as sampling 10^2-10^4 participants per
round out of a far larger registry; this module makes that regime cheap:

* :class:`ClientStore` — a lazy, sequence-like registry of ``n`` clients.
  A ``SimClient`` is built by the ``factory`` on FIRST access and cached;
  a never-sampled client allocates nothing. ``compact(keep)`` drops cached
  entries of clients that permanently left the federation.
* :class:`LazyHeteroEnv` — the :class:`~repro_torch.fed.client.HeteroEnv`
  interface with O(1) memory and O(touched) state. Profiles are drawn
  deterministically from ``(seed, cid)``; ``maybe_switch`` records the
  switch ROUND instead of re-rolling an assignment array, and a client's
  profile is resolved lazily by replaying the switch draws for its id.

Everything is a pure function of ``(seed, cid)`` plus a small event log, so
checkpoints serialize only the touched state (the registry itself needs no
serialization beyond the spec's seed) and resume stays bit-deterministic.

Memory model: peak host memory is O(touched clients) = O(sampled
participants x rounds), never O(population). ``benchmarks/table4_scaling.py``
pins this with a 100k-registry / 512-sample regime.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.timemodel import PAPER_PROFILES, ResourceProfile


def cid_rng(seed: int, tag: int, *parts: int) -> np.random.Generator:
    """Deterministic per-(seed, cid, ...) stream, independent across tags."""
    return np.random.default_rng([int(seed), int(tag), *map(int, parts)])


class ClientStore:
    """Lazy sequence of ``SimClient``s: ``factory(cid)`` runs on first access.

    Quacks like the ``list[SimClient]`` the trainers were built on
    (``len``, ``[]``, iteration), so ``fed/base.py`` / ``fed/dtfl.py`` /
    ``fed/cohort.py`` consume it unchanged. Iterating materializes every
    client — fine for test-sized registries, never done by the engines.
    """

    def __init__(self, n: int, factory):
        if n < 1:
            raise ValueError(f"ClientStore needs n >= 1, got {n}")
        self._n = int(n)
        self._factory = factory
        self._cache: dict[int, object] = {}

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, cid: int):
        cid = int(cid)
        if not 0 <= cid < self._n:
            raise IndexError(f"client id {cid} out of range [0, {self._n})")
        cl = self._cache.get(cid)
        if cl is None:
            cl = self._cache[cid] = self._factory(cid)
        return cl

    def __iter__(self):
        for cid in range(self._n):
            yield self[cid]

    # ------------------------------------------------------------------
    @property
    def n_touched(self) -> int:
        return len(self._cache)

    def touched(self) -> list[int]:
        """Client ids materialized so far (sorted)."""
        return sorted(self._cache)

    def compact(self, keep) -> None:
        """Drop cached clients outside ``keep`` (permanent departures).

        Lazy reconstruction makes this lossless for the *data* plane — a
        compacted client that returns is rebuilt bit-identically from the
        factory. Trainer-held per-client state (EF residuals, scheduler
        history) is compacted by ``BaseTrainer.compact``, which owns the
        never-drop-a-live-client invariant.
        """
        keep = set(int(k) for k in keep)
        self._cache = {c: v for c, v in self._cache.items() if c in keep}


class LazyHeteroEnv:
    """``HeteroEnv`` semantics with O(1) construction and O(touched) state.

    The dense env materializes an ``assignment`` array (even profile split,
    shuffled) and re-rolls a random 30% of it every ``switch_every`` rounds.
    Here a client's base profile is an independent uniform draw from
    ``(seed, cid)`` — the even split holds in expectation — and each switch
    round ``rs`` re-rolls client ``cid`` iff its ``(seed, rs, cid)`` draw
    lands under ``switch_frac``; ``maybe_switch`` only APPENDS the round to
    the switch log, so it is O(1) regardless of population.

    ``set_profile`` (mid-round churn) pins an override; later switch rounds
    may re-roll it, matching the dense env's point-mutation semantics.
    Resolved profiles are cached per touched cid and invalidated when the
    switch log grows.
    """

    def __init__(
        self,
        n_clients: int,
        profiles: list[ResourceProfile] | None = None,
        *,
        switch_every: int = 50,
        switch_frac: float = 0.3,
        seed: int = 0,
    ):
        self.profiles = profiles or PAPER_PROFILES
        self.n_clients = int(n_clients)
        self.switch_every = switch_every
        self.switch_frac = switch_frac
        self.seed = int(seed)
        self._switch_rounds: list[int] = []       # applied switch rounds, ordered
        self._switched_rounds: set[int] = set()   # guard (async multi-group calls)
        # cid -> (switch-log position the override was set at, profile idx)
        self._overrides: dict[int, tuple[int, int]] = {}
        self._cache: dict[int, int] = {}          # cid -> resolved idx
        self._version = 0                         # invalidates _cache

    # -- HeteroEnv interface -------------------------------------------
    def maybe_switch(self, round_idx: int) -> None:
        if (self.switch_every and round_idx > 0
                and round_idx % self.switch_every == 0
                and round_idx not in self._switched_rounds):
            self._switched_rounds.add(round_idx)
            self._switch_rounds.append(round_idx)
            self._cache.clear()
            self._version += 1

    def set_profile(self, cid: int, profile_idx: int) -> None:
        self._overrides[int(cid)] = (len(self._switch_rounds), int(profile_idx))
        self._cache.pop(int(cid), None)

    def profile(self, cid: int) -> ResourceProfile:
        return self.profiles[self.profile_idx(cid)]

    def profile_idx(self, cid: int) -> int:
        cid = int(cid)
        idx = self._cache.get(cid)
        if idx is None:
            idx = self._cache[cid] = self._resolve(cid)
        return idx

    def _resolve(self, cid: int) -> int:
        ov = self._overrides.get(cid)
        if ov is not None:
            pos, idx = ov
        else:
            pos = 0
            idx = int(cid_rng(self.seed, 11, cid).integers(len(self.profiles)))
        for rs in self._switch_rounds[pos:]:
            r = cid_rng(self.seed, 13, rs, cid)
            if r.random() < self.switch_frac:
                idx = int(r.integers(len(self.profiles)))
        return idx

    @property
    def n_touched(self) -> int:
        """Clients with resolved-profile or override state (memory proxy)."""
        return len(self._cache) + len(self._overrides)

    # -- resumable state (sparse: the event log, never the population) --
    def save_state(self) -> dict:
        ov = sorted(self._overrides.items())
        return {
            "lazy": np.int64(1),
            "switch_rounds": np.array(self._switch_rounds, dtype=np.int64),
            "ov_cids": np.array([c for c, _ in ov], dtype=np.int64),
            "ov_pos": np.array([p for _, (p, _) in ov], dtype=np.int64),
            "ov_idx": np.array([i for _, (_, i) in ov], dtype=np.int64),
        }

    def load_state(self, state: dict) -> None:
        if "lazy" not in state:
            raise ValueError(
                "checkpoint env state is the dense HeteroEnv format; it "
                "cannot resume a population-mode (lazy env) run")
        self._switch_rounds = [int(r) for r in
                               np.asarray(state["switch_rounds"]).reshape(-1)]
        self._switched_rounds = set(self._switch_rounds)
        self._overrides = {
            int(c): (int(p), int(i))
            for c, p, i in zip(np.asarray(state["ov_cids"]).reshape(-1),
                               np.asarray(state["ov_pos"]).reshape(-1),
                               np.asarray(state["ov_idx"]).reshape(-1))
        }
        self._cache.clear()
        self._version += 1
