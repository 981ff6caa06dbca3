"""Shared machinery of the full-model baseline trainers (pair:
``repro/fed/base.py``): ``kd_loss`` (``:23``) and ``BaseTrainer`` (``:39``).

Every baseline consumes the same adapter, clients, env and analytic clock
as ``DTFLTrainer``, so Table-3 comparisons differ only in the algorithm and
its time profile. The hooks ``select_clients``, ``client_time``,
``plan_round``, ``execute_round``, ``observe_round``, ``train_group`` and
``async_groups`` default to FedAvg; the rounds, events and async engines
drive them (``fed/engine.py``).

``_train_round_full`` is one path for the loop, cohort and chunked planes,
as ``DTFLTrainer._train_chunked`` is: every batch-shape cohort's client
axis is cut into chunks of ``ExecPlan.width`` clients, and each chunk runs
the download wire, the optimizer init, ``cohort.run_cohort`` of the
full-model step and the upload wire (with client-held error feedback for
a stateful codec); the N_k/N average is ``weighted_average_cohorts``. At
width 1 each int8 leaf is one row, the JAX package's per-tensor int8 of
its loop plane (``uplink_rt_one``). The sharded plane is not yet ported.
On the card the int8 wires run on K1 and every ``full_loss`` on K3.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch import resolve_device
from repro_torch.core import aggregation, timemodel
from repro_torch.core import codec as codec_lib
from repro_torch.fed import cohort as cohort_engine
from repro_torch.fed import engine as round_engine
from repro_torch.fed.client import HeteroEnv, SimClient
from repro_torch.fed.dtfl import _fresh, _value_and_grad
from repro_torch.fed.engine import RoundLog, RoundPlan
from repro_torch.fed.execplan import ExecPlan
from repro_torch.tree import tree_map


def kd_loss(student_logits: torch.Tensor, teacher_logits: torch.Tensor,
            temp: float = 1.0, weight: torch.Tensor | None = None) -> torch.Tensor:
    """KL(teacher || student) with temperature, per client: logits (C, ...,
    V) give a (C,) loss, the JAX function's scalar for each client.
    ``weight`` (leading-axes broadcastable, e.g. the (C, B) pad mask of
    ``data/pipeline.py``) turns the mean over rows into a weighted mean so
    padded samples contribute nothing."""
    t = torch.softmax(teacher_logits.float() / temp, -1)
    ls = torch.log_softmax(student_logits.float() / temp, -1)
    lt = torch.log_softmax(teacher_logits.float() / temp, -1)
    per = (t * (lt - ls)).sum(-1)
    dims = tuple(range(1, per.ndim))
    if weight is None:
        return per.mean(dim=dims) * temp * temp
    w = weight.float()
    w = w.reshape(w.shape + (1,) * (per.ndim - w.ndim)).expand(per.shape)
    return (per * w).sum(dim=dims) / torch.clamp_min(w.sum(dim=dims), 1.0) * temp * temp


class BaseTrainer:
    """Round scaffolding of the full-model baselines; the hook defaults are
    FedAvg. ``device=None`` runs on the card."""

    name = "base"
    # whether the async engine's default train_group (FedAvg-style group
    # aggregation) represents the algorithm; trainers whose algorithm lives
    # in execute_round or select_clients refuse engine="async"
    supports_async = True
    # whether the codec plane's download/update-upload wires are this
    # algorithm's round structure; SplitFed and FedGKT refuse other codecs
    supports_codec = True

    def __init__(self, adapter, clients: list[SimClient], env: HeteroEnv, optimizer,
                 *, seed: int = 0, local_epochs: int = 1,
                 server_flops: float = timemodel.SERVER_FLOPS,
                 exec_plan: "ExecPlan | str | None" = None,
                 codec: "codec_lib.Codec | str | None" = None,
                 device: "str | torch.device | None" = None):
        self.device = resolve_device(device)
        self.adapter = adapter
        self.clients = clients
        self.env = env
        self.opt = optimizer
        self.local_epochs = local_epochs
        self.server_flops = server_flops
        self.exec_plan = ExecPlan.resolve(exec_plan)
        # the port's own init stream; tests bridge in the JAX package's init
        self.gen = torch.Generator().manual_seed(seed)
        self.params = self._to_device(adapter.init_global(self.gen))
        self.costs = adapter.tier_costs(clients[0].dataset.batch_size)
        self.codec = codec_lib.make_codec(codec)
        if not self.supports_codec and not self.codec.is_identity:
            raise ValueError(
                f"{self.name} does not support wire compression (codec="
                f"{self.codec.name!r}); its round structure is not the "
                "download/update-upload contract the codec plane compresses")
        self.wires = codec_lib.wire_sizes(self.costs, self.codec)
        # cid -> full-model-shaped error-feedback residual, CPU tensors
        self._ef: dict[int, dict] = {}
        # host seconds of the residuals' gathers and scatters
        self.ef_copy_s = 0.0
        self.last_uplink_bytes = 0.0
        self.last_hosts = None     # no peer offload: every RoundLog.hosts is None

    def _to_device(self, tree):
        return tree_map(lambda t: t.to(self.device), tree)

    def _batches(self, batches: dict) -> dict:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batches.items()}

    # ------------------------------------------------------------------
    # engine hooks (repro/fed/base.py:84-135)
    # ------------------------------------------------------------------
    def select_clients(self, r: int, participants: list[int]) -> list[int]:
        """Which participants train (TiFL picks a tier, drop30 the fastest)."""
        return list(participants)

    def client_time(self, k: int) -> float:
        """Planned Eq.-5 completion offset of client ``k`` under this
        algorithm's time profile."""
        return self._full_model_time(k, self.clients[k].n_batches)

    def plan_round(self, r: int, participants: list[int]) -> RoundPlan:
        self.env.maybe_switch(r)
        trained = list(self.select_clients(r, participants))
        times = np.array([self.client_time(k) for k in trained], float)
        # full-model uplink: one codec'd update upload per trained client
        self.last_uplink_bytes = float(self.wires.full_up * len(trained))
        return RoundPlan(participants=list(participants), trained=trained,
                         assign={k: 0 for k in trained}, times=times)

    def execute_round(self, r: int, plan: RoundPlan, trained: list[int]) -> float:
        """Train the survivors; returns extra serial time appended after the
        last completion (FedGKT's server phase)."""
        if trained:
            with torch.no_grad():
                self.params = self._train_round_full(r, trained)
        return 0.0

    def observe_round(self, plan: RoundPlan, idx: list[int], obs_times, totals) -> None:
        """Event-derived timestamps fed back (TiFL's speed profiling)."""

    def train_group(self, r: int, plan: RoundPlan, trained: list[int]):
        """Async hook: the group's aggregate, not committed to ``params``,
        and the group's sample count."""
        with torch.no_grad():
            tree = self._train_round_full(r, trained)
        return tree, float(sum(len(self.clients[k].dataset) for k in trained))

    def async_groups(self, cids: list[int], n_groups: int) -> list[list[int]]:
        """Speed groups, fast to slow, by this algorithm's own time profile."""
        return round_engine.split_speed_groups(sorted(cids, key=self.client_time), n_groups)

    def train_round(self, r: int, participants: list[int]) -> tuple[float, dict]:
        """Scalar-clock round: plan -> execute(all) -> observe(all). Returns
        the straggler and an empty assignment: the rounds engine logs a
        baseline's round with no tiers, as the JAX package's does."""
        plan = self.plan_round(r, participants)
        extra = self.execute_round(r, plan, plan.trained)
        self.observe_round(plan, list(range(len(plan.trained))), plan.times, plan.times)
        return float(plan.times.max()) + extra, {}

    # ------------------------------------------------------------------
    # the full-model planes
    # ------------------------------------------------------------------
    def _full_step(self):
        """The full-model step over a cohort's client axis."""
        ad, opt = self.adapter, self.opt

        def step(state, batch):
            loss, _, g = _value_and_grad(lambda p: (ad.full_loss(p, batch), None), state["p"])
            p, o = opt.update(state["p"], g, state["o"])
            return {"p": p, "o": o}, loss

        return step

    def _cohort_program(self):
        """Download wire, optimizer init, the steps over the client axis,
        upload wire; returns the uploads (client axis) and, for a stateful
        codec, the new residuals (``repro/fed/base.py:346-362``)."""
        step, opt, codec = self._full_step(), self.opt, self.codec

        def run(params, batches, mask, ef=None):
            ref = codec.tree_down_rt(params)
            final, _ = cohort_engine.run_cohort(step, {"p": ref, "o": opt.init(ref)},
                                                batches, mask)
            if codec.stateful:
                return codec_lib.uplink_rt_ef(codec, final["p"], ref, ef)
            return codec_lib.uplink_rt(codec, final["p"], ref), None

        return run

    def _train_round_full(self, r: int, cids: list[int]):
        """Full-model local training of ``cids`` and the N_k/N weighted
        average of their uploads: every plane, at ``exec_plan.width``
        clients a program (the whole cohort, the chunk size, or 1)."""
        prog = self._cohort_program()
        cohorts = cohort_engine.build_cohorts(
            self.clients, cids, {k: 0 for k in cids}, r, self.local_epochs,
            pad_multiple=self.exec_plan.pad_multiple)
        trees, ws = [], []
        for co in cohorts:
            width = self.exec_plan.width(co.mask.shape[1])
            chunks = []
            for sl in cohort_engine.chunk_slices(co.mask.shape[1], width):
                b, m = cohort_engine.slice_clients(co.batches, co.mask, sl)
                b = self._batches(b)
                if self.codec.stateful:
                    cids_c = co.cids[sl.start:min(sl.stop, co.size)]
                    up, ef2 = prog(self.params, b, m, self._gather_ef_cids(cids_c, width))
                    self._scatter_ef_cids(cids_c, ef2)
                else:
                    up, _ = prog(self.params, b, m)
                chunks.append(up)
            n = co.size  # reassemble the cohort stack, drop pad columns
            trees.append(tree_map(lambda *xs: torch.cat(xs)[:n], *chunks))
            ws.append([len(self.clients[k].dataset) for k in co.cids])
        return aggregation.weighted_average_cohorts(trees, ws)

    # ------------------------------------------------------------------
    # error-feedback state (repro/fed/base.py:137-170): one full-model-shaped
    # residual per client in host memory, crossing to the device per chunk
    # ------------------------------------------------------------------
    def _zero_ef(self):
        return tree_map(lambda x: torch.zeros(x.shape, dtype=x.dtype), self.params)

    def _gather_ef_cids(self, cids, width: int):
        """``cids``'s residuals stacked on the client axis, zero-padded to
        ``width`` columns, on the device."""
        t0 = time.perf_counter()
        trees = [self._ef.get(k) or self._zero_ef() for k in cids]
        trees += [self._zero_ef()] * (width - len(trees))
        out = tree_map(lambda *xs: torch.stack(xs).to(self.device), *trees)
        self.ef_copy_s += time.perf_counter() - t0
        return out

    def _scatter_ef_cids(self, cids, ef) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # the chunk's training is not the copy's
        t0 = time.perf_counter()
        ef = tree_map(torch.Tensor.cpu, ef)
        for i, cid in enumerate(cids):
            self._ef[cid] = tree_map(lambda x: x[i].clone(), ef)
        self.ef_copy_s += time.perf_counter() - t0

    def compact(self, keep) -> None:
        """Drop per-client state (cached data clients, EF residuals) of
        clients outside ``keep``, the permanent departures. The engines never
        call this."""
        keep = set(int(k) for k in keep)
        if hasattr(self.clients, "compact"):
            self.clients.compact(keep)
        self._ef = {c: st for c, st in self._ef.items() if c in keep}

    # ------------------------------------------------------------------
    # resumable state (repro/fed/base.py:186-205). No "key", as in
    # DTFLTrainer: the port draws from its generator only at init; a JAX
    # envelope's "key" is ignored, and the JAX package loads an envelope
    # without one.
    # ------------------------------------------------------------------
    def save_state(self) -> dict:
        state = {"params": self.params, "env": self.env.save_state()}
        if self.codec.stateful:
            state["ef"] = {str(cid): t for cid, t in self._ef.items()}
        return state

    def load_state(self, state: dict) -> None:
        """Restore ``save_state``'s dict from either package: new tensors on
        the trainer's device (residuals on the host), laid out as the live
        trees; no live tensor is written."""
        self.params = _fresh(self.params, state["params"], self.device)
        if "env" in state:
            self.env.load_state(state["env"])
        if "ef" in state:
            zero = self._zero_ef()
            self._ef = {int(cid): _fresh(zero, t, "cpu") for cid, t in state["ef"].items()}

    def save(self, path: str) -> None:
        ckpt.save(path, self.save_state())

    def restore(self, path: str) -> None:
        """Load trainer state from ``path``: a bare ``save()`` state or a
        ``fed.engine.save_train_state`` resume envelope (unwrapped)."""
        round_engine.restore_trainer(self, path)

    def run(self, n_rounds: int, eval_batch: dict, *, target_acc: float | None = None,
            participation: float = 1.0, sample_size: int | None = None,
            eval_every: int = 1, verbose: bool = False,
            engine: str = "rounds", churn=None, n_groups: int = 3,
            checkpoint_path: str | None = None, checkpoint_every: int = 10,
            resume: dict | None = None, on_round=None) -> list[RoundLog]:
        """``engine="rounds"``, ``"events"`` (optional churn) or ``"async"``
        (trainers with ``supports_async`` only). ``on_round(trainer, log)``
        is called after each round."""
        common = dict(target_acc=target_acc, participation=participation,
                      eval_every=eval_every, verbose=verbose,
                      checkpoint_path=checkpoint_path,
                      checkpoint_every=checkpoint_every, resume=resume,
                      on_round=on_round)
        if engine == "events":
            return round_engine.run_events(self, n_rounds, eval_batch, churn=churn,
                                           sample_size=sample_size, **common)
        if engine == "async":
            if not self.supports_async:
                raise ValueError(
                    f"{self.name} has no faithful async formulation (its "
                    "algorithm lives outside train_group); run it with "
                    "engine='rounds' or 'events', or use method 'fedat'")
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

    # ------------------------------------------------------------------
    def _full_model_time(self, cid: int, n_batches: int) -> float:
        """FedAvg-style: the client trains the whole model; the comm term
        prices the codec-true download and update upload."""
        prof = self.env.profile(cid)
        compute = self.costs.full_flops * n_batches * self.local_epochs / prof.flops
        comm = (self.wires.full_down + self.wires.full_up) / prof.bytes_per_s
        return compute + comm
