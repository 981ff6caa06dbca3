"""FedGKT (He et al. 2020a; pair: ``repro/fed/fedgkt.py``): group knowledge
transfer.

Clients train only a small model (the client half up to md2 and an aux
head) on CE + KD against the server's logits; the server trains the large
server half on the uploaded features with CE + KD against the clients'
logits.

  phase 1: each client runs one step per batch, sequentially, at a client
           axis of 1, on ``ce + 0.5 * kd`` (``kd`` only once a teacher is
           cached for that (client, batch));
  phase 2: the server trains over the last local epoch's uploads
           ``(z, batch, client logits)`` in client order and refreshes the
           ``(cid, batch)`` teacher cache with its logits.

The edge model and the aux head are averaged with ``weighted_average``;
``params`` is ``merge(client, server)`` after every round. The round time
is the slowest client phase plus the serial server phase, which is
``execute_round``'s extra time. On the card both cross-entropies run on K3.
"""
from __future__ import annotations

import torch

from repro_torch.core import aggregation
from repro_torch.core.local_loss import token_xent
from repro_torch.data.pipeline import ROUND_SEED_STRIDE
from repro_torch.fed.base import BaseTrainer, kd_loss
from repro_torch.fed.dtfl import _fresh, _host, _value_and_grad
from repro_torch.fed.engine import RoundPlan
from repro_torch.tree import tree_map

SPLIT_TIER = 1
KD_WEIGHT = 0.5


def lift(tree):
    """One model as a cohort of one: a leading client axis of 1 (views)."""
    return tree_map(lambda t: t[None], tree)


def drop(tree):
    """The one client of a cohort of one, without its axis (views)."""
    return tree_map(lambda t: t[0], tree)


def _lift_opt(state):
    """An optimizer state of one model as a cohort of one: its moment trees
    get the client axis; ``lr`` and the 0-d step count stay shared."""
    return {k: v if k in ("lr", "t") else lift(v) for k, v in state.items()}


def _drop_opt(state):
    return {k: v if k in ("lr", "t") else drop(v) for k, v in state.items()}


class FedGKTTrainer(BaseTrainer):
    name = "fedgkt"
    supports_async = False  # the algorithm lives outside train_group
    supports_codec = False  # its (z, y, logits) protocol is not the codec's wires

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        cp, sp = self.adapter.split(self.params, SPLIT_TIER)
        self.client_params = cp            # the shared (averaged) edge model
        self.server_params = sp            # the one large server model
        self.aux = self._to_device(self.adapter.aux_init(self.gen, SPLIT_TIER))
        self.server_opt_state = self.opt.init(sp)
        # (cid, batch) -> the server's logits, (1, batch, ..., classes)
        self._teacher: dict[tuple[int, int], torch.Tensor] = {}
        cfg = self.adapter.cfg
        self._n_out = cfg.n_classes if hasattr(cfg, "n_classes") else cfg.vocab

    # ------------------------------------------------------------------
    def _client_step(self, cp, ap, co, ao, batch, teacher, use_kd: bool):
        ad, opt = self.adapter, self.opt

        def loss_fn(tree):
            z = ad.client_features(tree[0], batch)
            logits = ad.aux_logits(tree[1], z)
            loss = token_xent(logits, batch["labels"], batch.get("mask"))
            if use_kd:
                loss = loss + KD_WEIGHT * kd_loss(logits, teacher, weight=batch.get("mask"))
            return loss, (z.detach(), logits.detach())

        _, (z, logits), (cg, ag) = _value_and_grad(loss_fn, (cp, ap))
        cp, co = opt.update(cp, cg, co)
        ap, ao = opt.update(ap, ag, ao)
        return cp, ap, co, ao, z, logits

    def _server_step(self, sp, so, z, batch, client_logits):
        ad = self.adapter

        def loss_fn(sp):
            logits = ad.server_logits(sp, z, SPLIT_TIER)
            ce = token_xent(logits, batch["labels"], batch.get("mask"))
            kd = kd_loss(logits, client_logits, weight=batch.get("mask"))
            return ce + KD_WEIGHT * kd, logits.detach()

        _, logits, g = _value_and_grad(loss_fn, sp)
        sp, so = self.opt.update(sp, g, so)
        return sp, so, logits

    # ------------------------------------------------------------------
    def client_time(self, k: int) -> float:
        """Small edge model + feature/logit upload (phase 1 only)."""
        prof = self.env.profile(k)
        nb = self.clients[k].n_batches
        m = SPLIT_TIER
        return (
            self.costs.client_flops[m] * nb * self.local_epochs / prof.flops
            + (self.costs.z_bytes[m] * nb + self.costs.client_param_bytes[m])
            / prof.bytes_per_s
        )

    def execute_round(self, r: int, plan: RoundPlan, trained: list[int]) -> float:
        """The two-phase KD protocol over the survivors; returns the serial
        server phase as the round's extra time."""
        if not trained:
            return 0.0
        with torch.no_grad():
            return self._two_phases(r, trained)

    def _two_phases(self, r: int, trained: list[int]) -> float:
        client_updates, weights, uploads = [], [], []
        for k in trained:
            cp, ap = lift(self.client_params), lift(self.aux)
            co, ao = self.opt.init(cp), self.opt.init(ap)
            for e in range(self.local_epochs):
                for bi, batch in enumerate(self.clients[k].dataset.epoch(
                        r * ROUND_SEED_STRIDE + e)):
                    batch = self._batches({n: v[None] for n, v in batch.items()})
                    teacher = self._teacher.get((k, bi))
                    use_kd = teacher is not None
                    if teacher is None:
                        teacher = torch.zeros(batch["labels"].shape + (self._n_out,),
                                              device=self.device)
                    cp, ap, co, ao, z, logits = self._client_step(
                        cp, ap, co, ao, batch, teacher, use_kd)
                    if e == self.local_epochs - 1:
                        uploads.append((k, bi, z, batch, logits))
            client_updates.append((drop(cp), drop(ap)))
            weights.append(len(self.clients[k].dataset))
        # phase 2: the server trains the large model on every uploaded batch
        sp, so = lift(self.server_params), _lift_opt(self.server_opt_state)
        for k, bi, z, batch, logits in uploads:
            sp, so, s_logits = self._server_step(sp, so, z, batch, logits)
            self._teacher[(k, bi)] = s_logits
        self.server_params, self.server_opt_state = drop(sp), _drop_opt(so)
        server_time = self.costs.server_flops[SPLIT_TIER] * len(uploads) / self.server_flops
        self.client_params = aggregation.weighted_average(
            [c for c, _ in client_updates], weights)
        self.aux = aggregation.weighted_average([a for _, a in client_updates], weights)
        self.params = drop(self.adapter.merge(lift(self.client_params),
                                              lift(self.server_params)))
        return server_time

    # ------------------------------------------------------------------
    # the model lives outside ``params`` (edge model, server model, aux
    # head, server optimizer, teacher cache): all of it rides the envelope
    # ------------------------------------------------------------------
    def save_state(self) -> dict:
        state = super().save_state()
        state["fedgkt"] = {
            "client": self.client_params,
            "server": self.server_params,
            "aux": self.aux,
            "server_opt": self.server_opt_state,
            "teacher": {f"{c}:{b}": v[0] for (c, b), v in self._teacher.items()},
        }
        return state

    def load_state(self, state: dict) -> None:
        super().load_state(state)
        if "fedgkt" in state:
            g = state["fedgkt"]
            self.client_params = _fresh(self.client_params, g["client"], self.device)
            self.server_params = _fresh(self.server_params, g["server"], self.device)
            self.aux = _fresh(self.aux, g["aux"], self.device)
            self.server_opt_state = _fresh(self.server_opt_state, g["server_opt"], self.device)
            self._teacher = {}
            for key, v in g["teacher"].items():
                c, b = key.split(":")
                self._teacher[(int(c), int(b))] = torch.tensor(_host(v), device=self.device)[None]
