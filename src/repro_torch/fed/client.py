"""Simulated heterogeneous client population (paper Sec. 4.1).

Verbatim copy of ``repro/fed/client.py:1`` for ``SimClient`` and
``HeteroEnv`` without its checkpoint ``save_state``/``load_state``;
``ChurnModel`` comes with the event engine.

Each client owns a data partition and a resource profile; the environment
re-assigns profiles for a fraction of clients every ``switch_every`` rounds
("Every 50 rounds, the client profiles of 30% of the clients were randomly
changed"). Ground-truth profiles are visible only to the time simulator,
never to the scheduler.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.timemodel import PAPER_PROFILES, ResourceProfile
from repro_torch.data.pipeline import ClientDataset


@dataclass
class SimClient:
    cid: int
    dataset: ClientDataset
    profile: ResourceProfile

    @property
    def n_batches(self) -> int:
        return self.dataset.n_batches


class HeteroEnv:
    """Profile assignment + dynamics."""

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
        self.switch_every = switch_every
        self.switch_frac = switch_frac
        self.rng = np.random.default_rng(seed)
        # paper: 20% of clients per profile at the outset (even split)
        idx = np.resize(np.arange(len(self.profiles)), n_clients)
        self.rng.shuffle(idx)
        self.assignment = idx
        self._switched_rounds: set[int] = set()

    def maybe_switch(self, round_idx: int) -> None:
        # each round index switches at most once: the async engine plans every
        # GROUP's wave through plan_round, so without this guard a multiple of
        # switch_every would re-roll profiles once per group
        if (self.switch_every and round_idx > 0 and round_idx % self.switch_every == 0
                and round_idx not in self._switched_rounds):
            self._switched_rounds.add(round_idx)
            n = len(self.assignment)
            sel = self.rng.choice(n, size=max(1, int(self.switch_frac * n)), replace=False)
            self.assignment[sel] = self.rng.integers(0, len(self.profiles), len(sel))

    def set_profile(self, cid: int, profile_idx: int) -> None:
        """Point mutation used by mid-round churn events (fed/engine.py)."""
        self.assignment[cid] = profile_idx

    def profile(self, cid: int) -> ResourceProfile:
        return self.profiles[self.assignment[cid]]
