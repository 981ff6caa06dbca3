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
     client-model download and the client-update upload (delta-coded, with
     client-held error feedback for top-k), and its true byte counts drive
     the simulated times and the scheduler.

The :class:`~repro_torch.fed.execplan.ExecPlan` picks the plane, that is
which clients one cohort program takes: ``cohort`` (the whole cohort),
``chunked`` (``chunk_size`` clients at a time), ``loop`` (one client at a
time) or ``sharded`` (this rank's slice of every cohort, its weighted sums
all-reduced over the process group), all four through
``DTFLTrainer._train_chunked``. ``topology="pairing"``
lets fast clients host slow clients' far halves in the time model
(``core/topology.py``); training is the same. The rounds, events and
async engines run it (``fed/engine.py``); ``save_state``/``load_state``
carry the run through a checkpoint envelope (``checkpoint/``). The
scheduler and codec names resolve through ``repro_torch.registry``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch import registry, resolve_device
from repro_torch.core import aggregation, timemodel
from repro_torch.core import codec as codec_lib
from repro_torch.core import topology as topology_lib
from repro_torch.core.scheduler import EMA, DynamicTierScheduler, StaticScheduler, TierProfile
from repro_torch.fed import cohort as cohort_engine
from repro_torch.fed import engine as round_engine
from repro_torch.fed.adapter import DTFLStepState
from repro_torch.fed.client import HeteroEnv, SimClient
from repro_torch.fed.engine import RoundLog, RoundPlan
from repro_torch.fed.execplan import ExecPlan
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

def _host(a) -> np.ndarray:
    """A leaf of a loaded state as a host array: numpy as is, a tensor
    copied off its device."""
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _fresh(like, tree, device):
    """``tree`` (numpy or tensor leaves, from either package's envelope) laid
    out as the live tree ``like``: tensor leaves become new tensors on
    ``device``, Python-number leaves (an optimizer's ``"lr"``) numbers."""
    return tree_map(
        lambda l, a: (torch.tensor(_host(a), device=device) if torch.is_tensor(l)
                      else type(l)(np.asarray(a))), like, tree)


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


def tier_step(adapter, opt, codec, tier: "int | None"):
    """The DTFL step ``step(state, batch) -> (state, (client_loss,
    server_loss))`` over a cohort's client axis, every loss (C,). The
    client loss and the server loss keep separate gradients
    (``repro/fed/dtfl.py:131-143``); the activation uplink ``z`` is
    detached and round-tripped through ``codec`` before the server loss
    (the client's own aux loss sees the uncompressed activations); an
    encoder-decoder's uplink ``(z, enc_out)`` each. A transformer's server
    half needs no ``tier``: its blocks say where it starts."""

    def step(state: DTFLStepState, batch: dict):
        closs, z, grads = _value_and_grad(
            lambda ca: adapter.client_loss(ca[0], ca[1], batch),
            (state.client, state.aux))
        cg, ag = grads
        # an encoder-decoder's uplink is (z, enc_out): each goes over the wire
        z = tree_map(lambda t: codec.rt(t.detach()), z)
        sloss, _, sg = _value_and_grad(
            lambda sp: (adapter.server_loss(sp, z, batch, tier), None), state.server)
        c, co = opt.update(state.client, cg, state.c_opt)
        a, ao = opt.update(state.aux, ag, state.a_opt)
        s, so = opt.update(state.server, sg, state.s_opt)
        return DTFLStepState(c, a, s, co, ao, so), (closs, sloss)

    return step


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
        topology: str = "server",
        seed: int = 0,
        local_epochs: int = 1,
        server_flops: float = timemodel.SERVER_FLOPS,
        exec_plan: "ExecPlan | str | None" = None,
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
        # cid -> error-feedback residuals, CPU tensors (stateful codecs)
        self._ef: dict[int, dict] = {}
        # host seconds spent gathering and scattering residuals (see below)
        self.ef_copy_s = 0.0
        self.last_uplink_bytes = 0.0
        profile = TierProfile.from_cost_table(
            self.costs,
            ref_flops=timemodel.UNIT_FLOPS,
            server_flops=server_flops,
            wires=self.wires,
        )
        # scheduler specs resolve through the component registry, as
        # repro/fed/dtfl.py:86-106 resolves them
        if topology not in registry.topologies:
            registry.topologies.validate(topology)   # raises with choices
        if topology == "pairing" and scheduler == "dynamic":
            scheduler = "pairing"
        self.sched = registry.schedulers.build(
            scheduler, profile=profile, n_clients=len(clients),
            n_tiers=adapter.n_tiers)
        provides_hosts = getattr(self.sched, "provides_hosts", False)
        if topology == "pairing" and not provides_hosts:
            raise ValueError(
                "topology='pairing' requires a host-providing scheduler "
                "(scheduler='pairing' or 'pairing:greedy'), got "
                f"{scheduler!r}")
        self.topology = "pairing" if provides_hosts else "server"
        self.last_hosts: dict[int, int] | None = None
        # per-tier aux heads, persistent and aggregated within tier cohorts
        self.aux = {
            m: self._to_device(adapter.aux_init(self.gen, m))
            for m in range(adapter.n_tiers)
        }
        self.exec_plan = ExecPlan.resolve(exec_plan)

    def _to_device(self, tree):
        return tree_map(lambda t: t.to(self.device), tree)

    def _batches(self, batches: dict) -> dict:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batches.items()}

    # ------------------------------------------------------------------
    def _raw_step(self, tier: int):
        """The DTFL step for ``tier`` over a cohort's client axis
        (:func:`tier_step`)."""
        return tier_step(self.adapter, self.opt, self.codec, tier)

    def _cohort_program(self, tier: int):
        """One tier's cohort: split, download wire, optimizer init, the steps
        over the client axis, upload wire, merge. Returns the merged trees
        and the uploaded aux heads, both with the client axis; a stateful
        codec takes the cohort's residuals ``efc``, ``efa`` (client axis) and
        also returns the new ones (``repro/fed/dtfl.py:174-189``). Eager
        PyTorch compiles nothing, so the closure is built per call."""
        ad, opt, codec = self.adapter, self.opt, self.codec
        step = self._raw_step(tier)

        def run(params, aux, batches, mask, efc=None, efa=None):
            cp, sp = ad.split(params, tier)
            cp, auxd = codec.tree_down_rt(cp), codec.tree_down_rt(aux)
            # passed without a name here, so the single-client optimizer
            # state is freed once run_cohort has broadcast it
            final, _ = cohort_engine.run_cohort(
                step, DTFLStepState(cp, auxd, sp, opt.init(cp), opt.init(auxd), opt.init(sp)),
                batches, mask)
            if codec.stateful:
                upc, efc2 = codec_lib.uplink_rt_ef(codec, final.client, cp, efc)
                upa, efa2 = codec_lib.uplink_rt_ef(codec, final.aux, auxd, efa)
                return ad.merge(upc, final.server), upa, efc2, efa2
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
        # narrow cid->tier schedules and pairing's cid->(tier, host) both
        # become an OffloadTopology; plan.assign stays the narrow tier view
        topo = topology_lib.OffloadTopology.from_schedule(
            self.sched.schedule(participants))
        assign = topo.tiers()
        tiers = np.array([assign[k] for k in participants])
        profs = [self.env.profile(k) for k in participants]
        bps = np.array([p.bytes_per_s for p in profs])
        nb = np.array([self.clients[k].n_batches for k in participants])
        if topo.is_server_only:
            t = timemodel.simulate_client_times_batch(
                self.costs, tiers, np.array([p.flops for p in profs]), bps, nb,
                server_flops=self.server_flops, n_sharing=len(participants),
                wires=self.wires,
            )
            obs_nu = bps
        else:
            t = topology_lib.simulate_times(
                self.costs, topo, participants, profs, nb,
                server_flops=self.server_flops, wires=self.wires)
            obs_nu = t["link"]   # guests report the pair link, not their uplink
        # codec-true client->host bytes of this round (z uplink + update
        # upload), surfaced per round through RoundLog.uplink_bytes
        self.last_uplink_bytes = float(self.wires.uplink_bytes(tiers, nb).sum())
        self.last_hosts = (None if topo.is_server_only else
                           {k: h for k, h in topo.hosts().items()
                            if h != topology_lib.SERVER})
        return RoundPlan(
            participants=list(participants), trained=list(participants),
            assign=assign, times=t["total"],
            obs={"t": t["client"] + t["comm"], "nu": obs_nu, "nb": nb},
            topology=topo,
        )

    def execute_round(self, r: int, plan: RoundPlan, trained: list[int]) -> float:
        if not trained:
            return 0.0
        with torch.no_grad():
            self.params = self._train_chunked(r, trained, plan.assign)
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

    def train_group(self, r: int, plan: RoundPlan, trained: list[int]):
        """Async hook (``repro/fed/dtfl.py:307-312``): train ``trained`` as
        ``execute_round`` does but return the aggregated tree and the
        group's sample count instead of committing the tree, so the async
        merger can staleness-weight it. The per-tier aux heads and the EF
        residuals are updated as in a round."""
        with torch.no_grad():
            tree = self._train_chunked(r, trained, plan.assign)
        return tree, float(sum(len(self.clients[k].dataset) for k in trained))

    def async_groups(self, cids: list[int], n_groups: int) -> list[list[int]]:
        """Speed groups from the scheduler's estimates, never ground truth
        (``repro/fed/dtfl.py:325-335``): the min-over-allowed-tiers T_hat,
        ascending, fast group first. A static scheduler has no estimates;
        its groups are contiguous slices."""
        if isinstance(self.sched, StaticScheduler):
            order = list(cids)
        else:
            sel = np.array(self.sched.allowed)
            est = self.sched.estimate_matrix(list(cids))[:, sel].min(axis=1)
            order = [cids[i] for i in np.argsort(est, kind="stable")]
        return round_engine.split_speed_groups(order, n_groups)

    def train_round(self, r: int, participants: list[int]) -> tuple[float, dict[int, int]]:
        """Scalar-clock round: plan -> execute(all) -> observe(all)."""
        plan = self.plan_round(r, participants)
        self.execute_round(r, plan, plan.trained)
        self.observe_round(plan, list(range(len(plan.trained))), plan.obs["t"], plan.times)
        return float(plan.times.max()), plan.assign

    def _train_chunked(self, r, participants, assign):
        """Every plane (``repro/fed/dtfl.py:375-457``): each (tier, shape)
        cohort's client axis is cut into the plan's slices
        (``ExecPlan.slices``): chunks of the whole cohort, the chunk size or
        1 client, or on the sharded plane this rank's columns of a cohort
        padded to a multiple of the ranks (pad clients: zero batches, no
        step, weight 0). Each slice runs the same cohort program, so the
        training working set on the device (stacked batches, per-client
        optimizer states, activations) is O(slice). The slices' outputs
        stay on the device; each cohort's stack, pad columns dropped, is
        contracted against its clients' N_k (``weighted_sum``) and summed
        over the ranks with its weight total (``all_reduce_tree``, the
        identity off the sharded plane); one ``combine_weighted_sums`` gives
        the N_k/N average and each tier's aux head. So every plane at one
        rank is the cohort plane's math in its order, bit for bit, and n
        ranks differ from it only in the order of the cross-rank sum. With
        more than one rank the new residuals of a slice go to every rank
        (``gather_clients``), so every rank holds the same residual store,
        as the JAX package's single controller does. At width 1 every leaf
        of an upload is one row, so a per-row codec (int8) sends one scale
        per tensor, as the JAX package's loop plane does."""
        plan = self.exec_plan
        sums, totals = [], []
        aux_by_tier: dict[int, list] = {}
        cohorts = cohort_engine.build_cohorts(
            self.clients, participants, assign, r, self.local_epochs,
            pad_multiple=plan.pad_multiple,
        )
        for co in cohorts:
            prog = self._cohort_program(co.tier)
            n_cols = co.mask.shape[1]
            slices = plan.slices(n_cols)
            mchunks, achunks = [], []
            for sl in slices:
                b, m = cohort_engine.slice_clients(co.batches, co.mask, sl)
                b = self._batches(b)
                if self.codec.stateful:
                    cids_c = co.cids[sl.start:sl.stop]
                    efc, efa = self._gather_ef_cids(cids_c, co.tier, sl.stop - sl.start)
                    merged, upa, efc2, efa2 = prog(
                        self.params, self.aux[co.tier], b, m, efc, efa)
                    if plan.n_shards > 1:
                        cids_c = co.cids
                        efc2 = plan.gather_clients(efc2, n_cols)
                        efa2 = plan.gather_clients(efa2, n_cols)
                    self._scatter_ef_cids(cids_c, co.tier, efc2, efa2)
                else:
                    merged, upa = prog(self.params, self.aux[co.tier], b, m)
                mchunks.append(merged)
                achunks.append(upa)
            real = co.cids[slices[0].start:slices[-1].stop]  # pad columns dropped
            cat = lambda *xs: torch.cat(xs)[:len(real)]
            w = [len(self.clients[k].dataset) for k in real]
            total = plan.all_reduce_scalar(
                torch.as_tensor(w, dtype=torch.float32, device=self.device).sum())
            sums.append(plan.all_reduce_tree(tree_map(cat, *mchunks), scaled_by=w))
            totals.append(total)
            aux_by_tier.setdefault(co.tier, []).append(
                (plan.all_reduce_tree(tree_map(cat, *achunks), scaled_by=w), total))
        for tier, parts in aux_by_tier.items():
            self.aux[tier] = aggregation.combine_weighted_sums(
                [a for a, _ in parts], [t for _, t in parts], like=self.aux[tier])
        return aggregation.combine_weighted_sums(sums, totals, like=self.params)

    # ------------------------------------------------------------------
    # error-feedback state (stateful codecs), repro/fed/dtfl.py:506-551:
    # residuals live in host memory per client, shaped like the client's
    # CURRENT tier halves; a re-tiered client's residual is reset to zeros.
    # They cross to the device per chunk and back; ``ef_copy_s`` adds up
    # the host seconds of the whole gather (zeros for new clients, the
    # stack, the copy to the device) and the whole scatter (the copy to the
    # host, the per-client clones).
    # ------------------------------------------------------------------
    def _zero_ef(self, tier: int):
        cp, _ = self.adapter.split(self.params, tier)
        zero = lambda t: tree_map(lambda x: torch.zeros(x.shape, dtype=x.dtype), t)
        return zero(cp), zero(self.aux[tier])

    def _client_ef(self, cid: int, tier: int):
        """This client's (client-half, aux) residuals for ``tier``, on the
        host: zeros if it has none yet or was re-tiered since."""
        st = self._ef.get(cid)
        if st is not None and st["tier"] == tier:
            return st["c"], st["a"]
        return self._zero_ef(tier)

    def _gather_ef_cids(self, cids, tier: int, width: int):
        """Stack ``cids``'s residuals along the client axis, zero-padded up
        to ``width`` clients (a chunk's pad columns), and copy them to the
        device."""
        t0 = time.perf_counter()
        pairs = [self._client_ef(k, tier) for k in cids]
        pairs += [self._zero_ef(tier)] * (width - len(pairs))
        to_dev = lambda trees: tree_map(lambda *xs: torch.stack(xs).to(self.device), *trees)
        out = to_dev([c for c, _ in pairs]), to_dev([a for _, a in pairs])
        self.ef_copy_s += time.perf_counter() - t0
        return out

    def _scatter_ef_cids(self, cids, tier: int, efc, efa) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # the chunk's training is not the copy's
        t0 = time.perf_counter()
        efc, efa = tree_map(torch.Tensor.cpu, efc), tree_map(torch.Tensor.cpu, efa)
        for i, cid in enumerate(cids):
            self._ef[cid] = {
                "tier": tier,
                "c": tree_map(lambda x: x[i].clone(), efc),
                "a": tree_map(lambda x: x[i].clone(), efa),
            }
        self.ef_copy_s += time.perf_counter() - t0

    # ------------------------------------------------------------------
    def compact(self, keep) -> None:
        """Drop per-client state (cached data clients, scheduler history, EF
        residuals) of clients outside ``keep``, the permanent departures
        (``repro/fed/dtfl.py:553-566``). The engines never call this."""
        keep = set(int(k) for k in keep)
        if hasattr(self.clients, "compact"):
            self.clients.compact(keep)
        if hasattr(self.sched, "compact"):
            self.sched.compact(keep)
        self._ef = {c: st for c, st in self._ef.items() if c in keep}

    # ------------------------------------------------------------------
    # checkpointing (repro/fed/dtfl.py:572-670): global params, per-tier aux
    # heads, the scheduler's touched clients (and pairing's hosts), the env
    # profile state and the EF residuals. No "key": the JAX package draws
    # from its key only at init (repro/fed/dtfl.py:71-72, :110), as the
    # port draws from its torch generator, so nothing after init depends on
    # it; an envelope's "key" is ignored on load, and the JAX package loads
    # an envelope without one (:623-624).
    # ------------------------------------------------------------------
    def save_state(self) -> dict:
        state = {"params": self.params,
                 "aux": {str(k): v for k, v in self.aux.items()},
                 "env": self.env.save_state()}
        if isinstance(self.sched, DynamicTierScheduler):
            # sparse: only touched clients ride the envelope
            items = self.sched.clients.touched_items()
            ema_t, ema_v = [], []
            for cid, cl in items:
                for tier, ema in cl.ema.items():
                    ema_t.append([cid, tier])
                    ema_v.append(ema.value)
            state["sched"] = {
                "cids": np.array([c for c, _ in items], dtype=np.int64),
                "tiers": np.array([cl.tier for _, cl in items], dtype=np.int64),
                "nu": np.array([cl.nu for _, cl in items], dtype=np.float64),
                "nb": np.array([cl.n_batches for _, cl in items], dtype=np.int64),
                "obs": np.array(
                    [-1 if cl.last_obs_tier is None else cl.last_obs_tier
                     for _, cl in items], dtype=np.int64),
                "ema_keys": np.array(ema_t or [[0, 0]][:0]).reshape(-1, 2),
                "ema_vals": np.array(ema_v),
            }
            if getattr(self.sched, "provides_hosts", False):
                hosts = self.sched.last_hosts
                state["sched"]["host_cids"] = np.array(sorted(hosts), dtype=np.int64)
                state["sched"]["host_of"] = np.array(
                    [hosts[c] for c in sorted(hosts)], dtype=np.int64)
        if self.codec.stateful:
            state["ef"] = {
                str(cid): {"tier": np.int64(st["tier"]), "c": st["c"], "a": st["a"]}
                for cid, st in self._ef.items()
            }
        return state

    def load_state(self, state: dict) -> None:
        """Restore ``save_state``'s dict (numpy or tensor leaves, from either
        package). Parameters and aux heads become new tensors on the
        trainer's device, residuals new host tensors, each laid out as the
        live tree; no live tensor is written."""
        self.params = _fresh(self.params, state["params"], self.device)
        self.aux = {int(k): _fresh(self.aux[int(k)], v, self.device)
                    for k, v in state["aux"].items()}
        if "env" in state:
            self.env.load_state(state["env"])
        if "sched" in state and isinstance(self.sched, DynamicTierScheduler):
            sc = state["sched"]
            if "cids" in sc:
                # sparse envelope: reset to all-default, then replay the
                # touched clients
                self.sched.clients.compact([])
                cids = [int(c) for c in np.asarray(sc["cids"]).reshape(-1)]
            else:
                # dense envelope (one entry per registered client)
                cids = list(range(len(np.asarray(sc["tiers"]).reshape(-1))))
            self.sched._rows.clear()
            for i, cid in enumerate(cids):
                cl = self.sched.clients[cid]
                cl.tier = int(sc["tiers"][i])
                cl.nu = float(sc["nu"][i])
                cl.n_batches = int(sc["nb"][i])
                obs = int(sc["obs"][i])
                cl.last_obs_tier = None if obs < 0 else obs
            for (cid, tier), v in zip(sc["ema_keys"], sc["ema_vals"]):
                e = EMA()
                e.value = float(v)
                self.sched.clients[int(cid)].ema[int(tier)] = e
            if "host_cids" in sc and getattr(self.sched, "provides_hosts", False):
                self.sched.last_hosts = {
                    int(c): int(h)
                    for c, h in zip(np.asarray(sc["host_cids"]).reshape(-1),
                                    np.asarray(sc["host_of"]).reshape(-1))}
        if "ef" in state:
            self._ef = {}
            for cid, st in state["ef"].items():
                tier = int(st["tier"])
                zc, za = self._zero_ef(tier)
                self._ef[int(cid)] = {"tier": tier, "c": _fresh(zc, st["c"], "cpu"),
                                      "a": _fresh(za, st["a"], "cpu")}

    def save(self, path: str) -> None:
        ckpt.save(path, self.save_state())

    def restore(self, path: str) -> None:
        """Load trainer state from ``path``: a bare ``save()`` state or a
        ``fed.engine.save_train_state`` resume envelope (unwrapped)."""
        round_engine.restore_trainer(self, path)

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
        checkpoint_path: str | None = None,
        checkpoint_every: int = 10,
        engine: str = "rounds",
        churn=None,
        n_groups: int = 3,
        resume: dict | None = None,
        on_round=None,
    ) -> list[RoundLog]:
        """``engine="rounds"`` (the scalar-clock loop), ``"events"`` (the
        event-driven sync engine, with an optional ``ChurnModel``) or
        ``"async"`` (``n_groups`` speed groups, staleness-weighted merges).
        ``checkpoint_path`` gets a resume envelope every
        ``checkpoint_every`` rounds and at the end; ``resume`` is a loaded
        envelope to continue. ``on_round(trainer, log)`` is called after
        each round. On the sharded plane only rank 0 prints."""
        common = dict(target_acc=target_acc, participation=participation,
                      eval_every=eval_every, verbose=verbose and self.exec_plan.lead,
                      checkpoint_path=checkpoint_path,
                      checkpoint_every=checkpoint_every, resume=resume,
                      on_round=on_round)
        if engine == "events":
            return round_engine.run_events(self, n_rounds, eval_batch, churn=churn,
                                           sample_size=sample_size, **common)
        if engine == "async":
            if sample_size is not None:
                raise ValueError("sample_size is a rounds/events knob; the "
                                 "async engine groups the full population")
            return round_engine.run_async(self, n_rounds, eval_batch, churn=churn,
                                          n_groups=n_groups, **common)
        if engine != "rounds":
            raise ValueError(f"unknown engine {engine!r}")
        if churn is not None:
            raise ValueError("churn requires the event-driven engine (engine='events'); "
                             "the scalar-clock 'rounds' loop cannot express it")
        return round_engine.run_rounds(self, n_rounds, eval_batch,
                                       sample_size=sample_size, **common)
