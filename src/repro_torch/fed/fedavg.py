"""FedAvg (McMahan et al. 2017; pair: ``repro/fed/fedavg.py``): full-model
local training and the N_k/N weighted average.

Every client trains the whole global model, so the slowest full-model
client bounds the round, which DTFL avoids. FedAvg is exactly the
``BaseTrainer`` hook defaults.
"""
from __future__ import annotations

from repro_torch.fed.base import BaseTrainer


class FedAvgTrainer(BaseTrainer):
    name = "fedavg"
