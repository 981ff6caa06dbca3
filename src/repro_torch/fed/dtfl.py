"""The DTFL training loop (pair: ``repro/fed/dtfl.py:47``, ``DTFLTrainer``).

Per round, as in the JAX package's cohort plane:
  1. the scheduler assigns every participant a tier (dynamic, from observed
     times, or static);
  2. each tier's participants train as ONE cohort: the client half + aux
     head on the local loss and the server half on the uploaded ``z``, on
     an explicit client axis (``fed/cohort.py::run_cohort``);
  3. simulated times per client come from the analytic time model and the
     client's ground-truth profile; the scheduler observes only those;
  4. halves are merged and FedAvg'd with weights N_k/N; per-tier aux heads
     are averaged within their tier;
  5. the wire codec round-trips the activation uplink ``z``, the
     client-model download and the client-update upload (delta-coded), and
     its true byte counts drive the simulated times and the scheduler.

This slice ports the cohort plane with the classic all-server topology.
The loop, sharded and chunked planes, pairing, checkpoints and the
events/async engines come later.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import aggregation, timemodel
from repro_torch.core import codec as codec_lib
from repro_torch.core.scheduler import DynamicTierScheduler, StaticScheduler, TierProfile
from repro_torch.fed import cohort as cohort_engine
from repro_torch.fed import engine as round_engine
from repro_torch.fed.adapter import DTFLStepState
from repro_torch.fed.client import HeteroEnv, SimClient
from repro_torch.fed.engine import RoundLog, RoundPlan
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def make_scheduler(spec: "str | int", profile: TierProfile, n_clients: int):
    """``"dynamic"`` -> Algorithm 1; an integer (or its string) -> that
    fixed 0-based tier for every client."""
    s = str(spec).strip().lower()
    if s == "dynamic":
        return DynamicTierScheduler(profile, n_clients)
    try:
        tier = int(s)
    except ValueError:
        raise NotImplementedError(f"scheduler {spec!r} is not yet ported") from None
    if tier < 0:
        raise ValueError(f"static tier must be >= 0, got {tier}")
    return StaticScheduler(tier, n_clients)


def _value_and_grad(loss_fn, tree):
    """(C,) per-client losses and the gradient of their sum w.r.t. ``tree``.
    The clients' slices share nothing, so each gets exactly its own
    gradient. A leaf the loss does not use (an xLSTM layer's idle cell, the
    ``is_slstm`` flags) gets exact zeros, as the JAX package's select gives
    it, so the optimizer, FedAvg and the codecs see the whole tree."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in tree_leaves(tree)]
        loss, aux = loss_fn(tree_unflatten(tree, leaves))
        grads = torch.autograd.grad(loss.sum(), leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
    return loss.detach(), aux, tree_unflatten(tree, grads)


class DTFLTrainer:
    name = "dtfl"

    def __init__(
        self,
        adapter,
        clients: list[SimClient],
        env: HeteroEnv,
        optimizer,
        *,
        scheduler: "str | int" = "dynamic",
        seed: int = 0,
        local_epochs: int = 1,
        server_flops: float = timemodel.SERVER_FLOPS,
        codec: "codec_lib.Codec | str | None" = None,
        device: "str | torch.device | None" = None,
    ):
        self.device = resolve_device(device)
        self.adapter = adapter
        self.clients = clients
        self.env = env
        self.opt = optimizer
        self.local_epochs = local_epochs
        self.server_flops = server_flops
        # the port's own init stream; tests bridge in the JAX package's init
        self.gen = torch.Generator().manual_seed(seed)
        self.params = self._to_device(adapter.init_global(self.gen))
        self.costs = adapter.tier_costs(clients[0].dataset.batch_size)
        self.codec = codec_lib.make_codec(codec)
        self.wires = codec_lib.wire_sizes(self.costs, self.codec)
        self.last_uplink_bytes = 0.0
        profile = TierProfile.from_cost_table(
            self.costs,
            ref_flops=timemodel.UNIT_FLOPS,
            server_flops=server_flops,
            wires=self.wires,
        )
        self.sched = make_scheduler(scheduler, profile, len(clients))
        # per-tier aux heads, persistent and aggregated within tier cohorts
        self.aux = {
            m: self._to_device(adapter.aux_init(self.gen, m))
            for m in range(adapter.n_tiers)
        }

    def _to_device(self, tree):
        return tree_map(lambda t: t.to(self.device), tree)

    # ------------------------------------------------------------------
    def _raw_step(self, tier: int):
        """The DTFL step for ``tier`` over a cohort's client axis. The client
        loss and the server loss keep separate gradients
        (``repro/fed/dtfl.py:131-143``); the activation uplink ``z`` is
        detached and round-tripped through the codec before the server loss
        (the client's own aux loss sees the uncompressed activations)."""
        ad, opt, codec = self.adapter, self.opt, self.codec

        def step(state: DTFLStepState, batch: dict):
            closs, z, grads = _value_and_grad(
                lambda ca: ad.client_loss(ca[0], ca[1], batch),
                (state.client, state.aux))
            cg, ag = grads
            z = codec.rt(z.detach())
            sloss, _, sg = _value_and_grad(
                lambda sp: (ad.server_loss(sp, z, batch, tier), None), state.server)
            c, co = opt.update(state.client, cg, state.c_opt)
            a, ao = opt.update(state.aux, ag, state.a_opt)
            s, so = opt.update(state.server, sg, state.s_opt)
            return DTFLStepState(c, a, s, co, ao, so), (closs, sloss)

        return step

    def _cohort_program(self, tier: int):
        """One tier's cohort: split, download wire, optimizer init, the steps
        over the client axis, upload wire, merge. Returns the merged trees
        and the uploaded aux heads, both with the client axis."""
        ad, opt, codec = self.adapter, self.opt, self.codec
        step = self._raw_step(tier)

        def run(params, aux, batches, mask):
            cp, sp = ad.split(params, tier)
            cp, auxd = codec.tree_down_rt(cp), codec.tree_down_rt(aux)
            # passed without a name here, so the single-client optimizer
            # state is freed once run_cohort has broadcast it
            final, _ = cohort_engine.run_cohort(
                step, DTFLStepState(cp, auxd, sp, opt.init(cp), opt.init(auxd), opt.init(sp)),
                batches, mask)
            upc = codec_lib.uplink_rt(codec, final.client, cp)
            upa = codec_lib.uplink_rt(codec, final.aux, auxd)
            return ad.merge(upc, final.server), upa

        return run

    # ------------------------------------------------------------------
    # engine hooks: plan -> execute -> observe
    # ------------------------------------------------------------------
    def plan_round(self, r: int, participants: list[int]) -> RoundPlan:
        """Profile switching + Algorithm-1 scheduling + analytic Eq.-5 times.
        Pure planning: no parameter updates, no scheduler observations."""
        self.env.maybe_switch(r)
        assign = self.sched.schedule(participants)
        tiers = np.array([assign[k] for k in participants])
        profs = [self.env.profile(k) for k in participants]
        bps = np.array([p.bytes_per_s for p in profs])
        nb = np.array([self.clients[k].n_batches for k in participants])
        t = timemodel.simulate_client_times_batch(
            self.costs, tiers, np.array([p.flops for p in profs]), bps, nb,
            server_flops=self.server_flops, n_sharing=len(participants),
            wires=self.wires,
        )
        # codec-true client->server bytes of this round (z uplink + update
        # upload), surfaced per round through RoundLog.uplink_bytes
        self.last_uplink_bytes = float(self.wires.uplink_bytes(tiers, nb).sum())
        return RoundPlan(
            participants=list(participants), trained=list(participants),
            assign=assign, times=t["total"],
            obs={"t": t["client"] + t["comm"], "nu": bps, "nb": nb},
        )

    def execute_round(self, r: int, plan: RoundPlan, trained: list[int]) -> float:
        if not trained:
            return 0.0
        with torch.no_grad():
            self.params = self._train_cohorts(r, trained, plan.assign)
        return 0.0

    def observe_round(self, plan: RoundPlan, idx: list[int], obs_times, totals) -> None:
        if not len(idx):
            return
        sel = np.asarray(idx, int)
        ks = [plan.trained[i] for i in idx]
        tiers = [plan.assign[k] for k in ks]
        self.sched.observe_cohort(
            ks, tiers, obs_times, plan.obs["nu"][sel], plan.obs["nb"][sel]
        )

    def train_round(self, r: int, participants: list[int]) -> tuple[float, dict[int, int]]:
        """Scalar-clock round: plan -> execute(all) -> observe(all)."""
        plan = self.plan_round(r, participants)
        self.execute_round(r, plan, plan.trained)
        self.observe_round(plan, list(range(len(plan.trained))), plan.obs["t"], plan.times)
        return float(plan.times.max()), plan.assign

    def _train_cohorts(self, r, participants, assign):
        """One cohort program per (tier, shape) cohort. Returns the N_k/N
        aggregated global tree; updates per-tier aux heads."""
        merged_trees, merged_ws = [], []
        aux_by_tier: dict[int, list] = {}
        cohorts = cohort_engine.build_cohorts(
            self.clients, participants, assign, r, self.local_epochs
        )
        for co in cohorts:
            batches = {k: torch.from_numpy(v).to(self.device) for k, v in co.batches.items()}
            merged, aux = self._cohort_program(co.tier)(
                self.params, self.aux[co.tier], batches, co.mask
            )
            w = [len(self.clients[k].dataset) for k in co.cids]
            merged_trees.append(merged)
            merged_ws.append(w)
            aux_by_tier.setdefault(co.tier, []).append((aux, w))
        for tier, parts in aux_by_tier.items():
            self.aux[tier] = aggregation.weighted_average_cohorts(
                [a for a, _ in parts], [w for _, w in parts]
            )
        return aggregation.weighted_average_cohorts(merged_trees, merged_ws)

    # ------------------------------------------------------------------
    def run(
        self,
        n_rounds: int,
        eval_batch: dict,
        *,
        target_acc: float | None = None,
        participation: float = 1.0,
        sample_size: int | None = None,
        eval_every: int = 1,
        verbose: bool = False,
        engine: str = "rounds",
        on_round=None,
    ) -> list[RoundLog]:
        if engine != "rounds":
            raise NotImplementedError(f"engine {engine!r} is not yet ported")
        return round_engine.run_rounds(
            self, n_rounds, eval_batch, target_acc=target_acc,
            participation=participation, sample_size=sample_size,
            eval_every=eval_every, verbose=verbose, on_round=on_round)
