"""Simulated heterogeneous client population (paper Sec. 4.1).

Verbatim copy of ``repro/fed/client.py:1``: ``SimClient``, ``HeteroEnv``
without its checkpoint ``save_state``/``load_state``, and ``ChurnModel``
(``:89``), the event engine's dropout, arrival and mid-round switches.

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


class ChurnModel:
    """Client churn for the event engine: dropout, arrival, mid-round switches.

    Three dynamics, all sampled from the model's own rng (so enabling churn
    never perturbs participant sampling or training seeds):

    * **dropout** — with ``drop_prob`` per participant per round, the client
      goes offline at a uniform fraction of its planned completion time; its
      completion event is cancelled, it is excluded from aggregation and from
      scheduler observations, and it returns after ``rejoin_after`` rounds.
    * **arrival** — a ``start_offline_frac`` fraction of the roster begins
      outside the federation; each offline-from-start client joins with
      ``arrival_prob`` per round (new devices appearing mid-training).
    * **mid-round profile switch** — with ``switch_prob`` per participant per
      round, the client's ground-truth resource profile is re-rolled *while
      its round is in flight*; the engine reschedules its completion event
      via :func:`repro_torch.core.timemodel.rescale_remaining`, and the scheduler
      observes the event-derived time, not the planned one.

    The scheduler only ever sees event timestamps of clients that actually
    reported — dropped clients leave no observation, so its estimate matrix
    stays finite (tested in ``tests/test_events.py``).
    """

    def __init__(self, n_clients: int, *, drop_prob: float = 0.0,
                 rejoin_after: int = 2, switch_prob: float = 0.0,
                 start_offline_frac: float = 0.0, arrival_prob: float = 0.5,
                 seed: int = 0):
        self.n = n_clients
        self.drop_prob = drop_prob
        self.rejoin_after = max(1, int(rejoin_after))
        self.switch_prob = switch_prob
        self.arrival_prob = arrival_prob
        self.rng = np.random.default_rng(seed)
        # cid -> rounds until eligible again; None = offline-from-start,
        # waiting for an arrival draw
        self.offline: dict[int, int | None] = {}
        if start_offline_frac > 0.0:
            k = min(n_clients - 1, int(round(start_offline_frac * n_clients)))
            for cid in self.rng.choice(n_clients, size=k, replace=False):
                self.offline[int(cid)] = None

    # ------------------------------------------------------------------
    def begin_round(self, r: int) -> np.ndarray:
        """Advance offline countdowns / arrival draws; return active cids."""
        back = []
        for cid, left in list(self.offline.items()):
            if left is None:
                if self.rng.random() < self.arrival_prob:
                    back.append(cid)
            elif left <= 1:
                back.append(cid)
            else:
                self.offline[cid] = left - 1
        for cid in back:
            del self.offline[cid]
        active = np.array(
            [c for c in range(self.n) if c not in self.offline], dtype=int
        )
        if not len(active):
            # the federation never fully empties: if everyone is offline the
            # whole roster rejoins (and the bookkeeping agrees with active())
            self.offline.clear()
            return np.arange(self.n)
        return active

    def active(self) -> list[int]:
        return [c for c in range(self.n) if c not in self.offline]

    def mark_offline(self, cid: int) -> None:
        self.offline[cid] = self.rejoin_after

    # ------------------------------------------------------------------
    def sample_mid_round(self, trained: list[int], times) -> list[tuple]:
        """Per-round churn draws: ``(kind, idx, at_fraction)`` tuples where
        ``kind`` is "dropout" | "switch" and ``at_fraction`` in (0, 1) is the
        fraction of the client's planned completion time at which it fires."""
        out = []
        for i, _ in enumerate(trained):
            u = self.rng.random()
            if u < self.drop_prob:
                out.append(("dropout", i, float(self.rng.uniform(0.05, 0.95))))
            elif u < self.drop_prob + self.switch_prob:
                out.append(("switch", i, float(self.rng.uniform(0.05, 0.95))))
        return out

    def resample_profile(self, env: HeteroEnv, cid: int) -> None:
        env.set_profile(cid, int(self.rng.integers(0, len(env.profiles))))
