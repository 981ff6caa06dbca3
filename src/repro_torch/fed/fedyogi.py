"""FedYogi (Reddi et al. 2020; pair: ``repro/fed/fedyogi.py``): FedAvg
client updates and a Yogi server optimizer.

The server takes ``params - avg`` (the negative average client delta) as a
pseudo-gradient and applies the Yogi update to the global tree, which has
no client axis (Adam's step count is 0-d there). The client time profile is
FedAvg's, so only ``execute_round`` differs from the defaults.
"""
from __future__ import annotations

import torch

from repro_torch import optim
from repro_torch.fed.base import BaseTrainer
from repro_torch.fed.dtfl import _fresh
from repro_torch.fed.engine import RoundPlan
from repro_torch.tree import tree_map


class FedYogiTrainer(BaseTrainer):
    name = "fedyogi"
    supports_async = False  # the algorithm lives outside train_group

    def __init__(self, *args, server_lr: float = 0.05, **kw):
        super().__init__(*args, **kw)
        self.server_opt = optim.yogi(lr=server_lr)
        self.server_opt_state = self.server_opt.init(self.params)

    def execute_round(self, r: int, plan: RoundPlan, trained: list[int]) -> float:
        if not trained:
            return 0.0
        with torch.no_grad():
            avg = self._train_round_full(r, trained)
            pseudo_grad = tree_map(lambda g, l: g - l, self.params, avg)
            self.params, self.server_opt_state = self.server_opt.update(
                self.params, pseudo_grad, self.server_opt_state)
        return 0.0

    # the server optimizer's state rides the resume envelope
    def save_state(self) -> dict:
        state = super().save_state()
        state["server_opt"] = self.server_opt_state
        return state

    def load_state(self, state: dict) -> None:
        super().load_state(state)
        if "server_opt" in state:
            self.server_opt_state = _fresh(self.server_opt_state, state["server_opt"],
                                           self.device)
