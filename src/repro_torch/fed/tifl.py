"""TiFL-style tier-based client selection (Chai et al. 2020; pair:
``repro/fed/tifl.py``): clients are profiled into speed tiers and each
round trains the clients of ONE tier, in round-robin order; every client
still trains the full model.

Speed profiles come from the event-derived completion times
(``observe_round``): under churn only the clients that reported refresh
their profile.
"""
from __future__ import annotations

import numpy as np

from repro_torch.fed.base import BaseTrainer
from repro_torch.fed.engine import RoundPlan

N_TIERS = 3


class TiFLTrainer(BaseTrainer):
    name = "tifl"
    supports_async = False  # the algorithm lives outside train_group

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._speed_obs: dict[int, float] = {}   # cid -> last observed full-model time
        self._round_robin = 0

    def _tiers(self, participants):
        # profile clients by observed (or estimated) full-model time
        times = {k: self._speed_obs.get(k, self.client_time(k)) for k in participants}
        order = sorted(participants, key=lambda k: times[k])
        cut = max(1, len(order) // N_TIERS)
        return [order[i * cut: (i + 1) * cut] or order[-1:] for i in range(N_TIERS)]

    def select_clients(self, r: int, participants: list[int]) -> list[int]:
        tiers = self._tiers(participants)
        chosen = tiers[self._round_robin % len(tiers)]
        self._round_robin += 1
        return chosen

    def observe_round(self, plan: RoundPlan, idx: list[int], obs_times, totals) -> None:
        for j, i in enumerate(idx):
            self._speed_obs[plan.trained[i]] = float(totals[j])

    # the speed profile and the rotation ride the resume envelope, or a
    # resumed run re-profiles from scratch and selects other tiers
    def save_state(self) -> dict:
        state = super().save_state()
        cids = np.array(sorted(self._speed_obs), dtype=np.int64)
        state["tifl"] = {
            "obs_cids": cids,
            "obs_times": np.array([self._speed_obs[int(c)] for c in cids]),
            "round_robin": np.int64(self._round_robin),
        }
        return state

    def load_state(self, state: dict) -> None:
        super().load_state(state)
        if "tifl" in state:
            t = state["tifl"]
            self._speed_obs = {
                int(c): float(v)
                for c, v in zip(np.asarray(t["obs_cids"]).reshape(-1),
                                np.asarray(t["obs_times"]).reshape(-1))
            }
            self._round_robin = int(t["round_robin"])
