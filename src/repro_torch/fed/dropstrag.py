"""Straggler-dropping FedAvg (Bonawitz et al. 2019; pair:
``repro/fed/dropstrag.py``): each round waits only for the fastest
``1 - drop_frac`` of the participants and discards the rest, so the slowest
clients' data never contributes.
"""
from __future__ import annotations

import numpy as np

from repro_torch.fed.base import BaseTrainer


class DropStragglerTrainer(BaseTrainer):
    name = "drop30"
    supports_async = False  # the algorithm lives outside train_group

    def __init__(self, *args, drop_frac: float = 0.3, **kw):
        super().__init__(*args, **kw)
        self.drop_frac = drop_frac

    def select_clients(self, r: int, participants: list[int]) -> list[int]:
        times = {k: self.client_time(k) for k in participants}
        keep_n = max(1, int(np.ceil(len(participants) * (1 - self.drop_frac))))
        return sorted(participants, key=lambda k: times[k])[:keep_n]
