"""FedAT-style asynchronous tier federation (Chai et al. 2021,
arXiv:2010.05958; pair: ``repro/fed/fedat.py``).

Clients are profiled into speed tiers; each tier aggregates its members'
full-model updates as soon as its own straggler finishes, and the server
folds the tier model into the global one with a staleness-weighted merge,
``w / (1 + staleness_lambda * staleness)``. The async engine
(``fed/engine.py::run_async``) drives the ``BaseTrainer`` hook defaults:
``async_groups``, ``train_group`` and the merge. ``n_rounds`` is a
per-tier wave budget; the merge budget is ``n_rounds * n_groups``.
"""
from __future__ import annotations

from repro_torch.fed import engine as round_engine
from repro_torch.fed.base import BaseTrainer


class FedATTrainer(BaseTrainer):
    name = "fedat"

    def __init__(self, *args, n_groups: int = 3, staleness_lambda: float = 1.0, **kw):
        super().__init__(*args, **kw)
        self.n_groups = n_groups
        self.staleness_lambda = staleness_lambda

    def run(self, n_rounds, eval_batch, *, engine: str = "async", n_groups=None, **kw):
        """FedAT is async by construction; another ``engine`` runs FedAvg
        with FedAT's time profile (for debugging)."""
        if engine == "async":
            return round_engine.run_async(
                self, n_rounds, eval_batch, n_groups=n_groups or self.n_groups,
                staleness_lambda=self.staleness_lambda, **kw)
        return super().run(n_rounds, eval_batch, engine=engine, **kw)
