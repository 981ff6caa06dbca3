"""Round engines (pair: ``repro/fed/engine.py``): the synchronous rounds
loop (``run_rounds``, ``:196``) and the event-driven sync engine with churn
(``run_events``, ``:271``).

Trainer contract (as in the JAX package): ``train_round(r, participants)``
plans, trains and observes one round and returns ``(straggler, assign)``;
the events engine calls its parts, ``plan_round``, ``execute_round`` and
``observe_round``, and drains completion, dropout and mid-round switch
events between them. The async engine and checkpoints are not yet ported.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.core import timemodel
from repro_torch.core.events import EventQueue


@dataclass
class RoundLog:
    round: int
    clock: float
    acc: float
    assignment: dict[int, int]
    straggler: float
    # codec-true client->server bytes planned for the round (z uplink +
    # update upload; set by the trainer's plan_round)
    uplink_bytes: float = 0.0
    # guest cid -> host cid under a peer-offload topology (core/topology.py);
    # None for the classic all-server topology
    hosts: dict[int, int] | None = None
    # host seconds the round took, training and eval, up to the point
    # where the device had finished the round's work
    wall_s: float = 0.0


@dataclass
class RoundPlan:
    """A trainer's declarative plan for one round."""

    participants: list[int]        # sampled participants
    trained: list[int]             # subset that actually computes
    assign: dict[int, int]         # cid -> tier
    times: np.ndarray              # (len(trained),) Eq.-5 completion offsets
    obs: dict | None = None        # scheduler observation arrays: t, nu, nb
    topology: object | None = None  # core.topology.OffloadTopology, or None


def _plan_hosts(plan: RoundPlan) -> dict[int, int] | None:
    """Guest->host map for the round log; None when every far half runs on
    the server."""
    topo = plan.topology
    if topo is None or topo.is_server_only:
        return None
    return {k: h for k, h in topo.hosts().items() if h != -1}


def _participants_rng() -> np.random.Generator:
    # the JAX package's loops draw participants from default_rng(0)
    return np.random.default_rng(0)


def _round_sample_size(n_clients: int, participation: float,
                       sample_size: int | None) -> int:
    """Participants per round: ``sample_size`` if given, else the
    fractional ``participation`` of the population."""
    if sample_size is None:
        return max(1, int(participation * n_clients))
    if sample_size < 1:
        raise ValueError(f"sample_size must be >= 1, got {sample_size}")
    return min(int(sample_size), n_clients)


def run_rounds(
    trainer,
    n_rounds: int,
    eval_batch: dict,
    *,
    target_acc: float | None = None,
    participation: float = 1.0,
    sample_size: int | None = None,
    eval_every: int = 1,
    verbose: bool = False,
    on_round: Callable[[object, RoundLog], None] | None = None,
) -> list[RoundLog]:
    """The scalar-clock synchronous loop: sample participants,
    ``train_round``, accumulate the straggler clock, eval on the global
    model, log. ``on_round(trainer, log)`` is called after each round."""
    rng = _participants_rng()
    eval_fn, eval_batch = _eval_setup(trainer, eval_batch)
    clock, logs = 0.0, []
    n_part = _round_sample_size(len(trainer.clients), participation, sample_size)
    for r in range(n_rounds):
        t0 = time.perf_counter()
        participants = sorted(
            rng.choice(len(trainer.clients), n_part, replace=False).tolist()
        )
        straggler, assign = trainer.train_round(r, participants)
        clock += straggler
        acc = eval_fn(trainer.params, eval_batch) if r % eval_every == 0 else (
            logs[-1].acc if logs else 0.0)
        logs.append(RoundLog(r, clock, acc, assign, straggler,
                             uplink_bytes=trainer.last_uplink_bytes,
                             hosts=trainer.last_hosts,
                             wall_s=_synced_wall(trainer, t0)))
        if on_round is not None:
            on_round(trainer, logs[-1])
        if verbose:
            tiers = f" tiers={sorted(set(assign.values()))}" if assign else ""
            hosts = logs[-1].hosts
            pairs = f" pairs={sorted(hosts.items())}" if hosts else ""
            print(f"[{trainer.name}] r={r} clock={clock:.0f}s acc={acc:.3f}"
                  f"{tiers}{pairs} wall={logs[-1].wall_s:.2f}s")
        if target_acc is not None and acc >= target_acc:
            break
    return logs


def _eval_setup(trainer, eval_batch):
    """The eval batch on the trainer's device and the accuracy function."""
    device = trainer.device
    batch = {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in eval_batch.items()}

    def eval_fn(params, b):
        with torch.no_grad():
            return float(trainer.adapter.eval_acc(params, b))

    return eval_fn, batch


def _synced_wall(trainer, t0: float) -> float:
    """Host seconds since ``t0`` once the device has finished the work."""
    if trainer.device.type == "cuda":
        torch.cuda.synchronize(trainer.device)
    return time.perf_counter() - t0


# ===========================================================================
# sync mode: the rounds loop as a degenerate event schedule
# ===========================================================================

def run_events(
    trainer,
    n_rounds: int,
    eval_batch: dict,
    *,
    target_acc: float | None = None,
    participation: float = 1.0,
    sample_size: int | None = None,
    eval_every: int = 1,
    verbose: bool = False,
    churn=None,
    on_round: Callable[[object, RoundLog], None] | None = None,
) -> list[RoundLog]:
    """Event-driven sync rounds (``repro/fed/engine.py:271-407``, without
    checkpoints): every trained client's completion is an event; with a
    ``ChurnModel`` dropouts cancel completions and mid-round profile
    switches reschedule them. Without churn it equals :func:`run_rounds`."""
    rng = _participants_rng()
    eval_fn, eval_batch = _eval_setup(trainer, eval_batch)
    q = EventQueue()
    logs: list[RoundLog] = []
    n_clients = len(trainer.clients)

    for r in range(n_rounds):
        t0 = time.perf_counter()
        # no churn: pass the population SIZE, not an arange (same stream)
        pool = churn.begin_round(r) if churn is not None else n_clients
        pool_n = len(pool) if churn is not None else n_clients
        cap = (int(participation * n_clients) if sample_size is None
               else _round_sample_size(n_clients, participation, sample_size))
        n_part = max(1, min(pool_n, cap))
        participants = sorted(rng.choice(pool, n_part, replace=False).tolist())

        plan = trainer.plan_round(r, participants)
        start = q.now
        # one completion event per trained client; the payload carries the
        # planned offset so float identity survives absolute-time round trips
        pending: dict[int, object] = {}
        for i, k in enumerate(plan.trained):
            pending[i] = q.push(
                start + plan.times[i], "complete",
                cid=k, idx=i, offset=float(plan.times[i]),
            )
        if churn is not None:
            for kind, i, frac in churn.sample_mid_round(plan.trained, plan.times):
                q.push(start + frac * plan.times[i], kind,
                       cid=plan.trained[i], idx=i)

        # drain the round: completions, dropouts, mid-round switches
        survivors: list[int] = []
        offsets: dict[int, float] = {}
        while not q.empty():
            ev = q.pop()
            i = ev.payload["idx"]
            if ev.kind == "complete":
                survivors.append(i)
                offsets[i] = ev.payload["offset"]
            elif ev.kind == "dropout":
                if i in survivors:
                    continue  # completed before the dropout fired
                pending[i].cancel()
                churn.mark_offline(ev.payload["cid"])
            elif ev.kind == "switch":
                if i in survivors:
                    continue
                cid = ev.payload["cid"]
                old = trainer.env.profile(cid)
                churn.resample_profile(trainer.env, cid)
                new = trainer.env.profile(cid)
                new_off = timemodel.rescale_remaining(
                    pending[i].payload["offset"], ev.time - start, old, new
                )
                pending[i].cancel()
                pending[i] = q.push(
                    start + new_off, "complete",
                    cid=cid, idx=i, offset=float(new_off),
                )

        survivors.sort()
        trained = [plan.trained[i] for i in survivors]
        extra = trainer.execute_round(r, plan, trained) or 0.0

        if trained:
            ratios = np.array([offsets[i] / plan.times[i] for i in survivors])
            totals = np.array([offsets[i] for i in survivors])
            if plan.obs is not None:
                obs_t = plan.obs["t"][np.asarray(survivors, int)] * ratios
            else:
                obs_t = totals
            trainer.observe_round(plan, survivors, obs_t, totals)
            base = float(max(offsets[i] for i in survivors)) + extra
        else:
            base = extra  # everyone dropped
        # the server learns of a dropout at the dropout timestamp, so a round
        # never ends before the last drained event (q.now)
        round_end = max(q.now, start + base)
        straggler = round_end - start
        q.advance_to(round_end)

        acc = eval_fn(trainer.params, eval_batch) if r % eval_every == 0 else (
            logs[-1].acc if logs else 0.0)
        logs.append(RoundLog(r, q.now, acc, plan.assign, straggler,
                             uplink_bytes=trainer.last_uplink_bytes,
                             hosts=_plan_hosts(plan),
                             wall_s=_synced_wall(trainer, t0)))
        if on_round is not None:
            on_round(trainer, logs[-1])
        if verbose:
            dropped = len(plan.trained) - len(trained)
            hosts = logs[-1].hosts
            print(f"[events:{trainer.name}] r={r} clock={q.now:.0f}s acc={acc:.3f}"
                  + (f" dropped={dropped}" if dropped else "")
                  + (f" pairs={sorted(hosts.items())}" if hosts else "")
                  + f" wall={logs[-1].wall_s:.2f}s")
        if target_acc is not None and acc >= target_acc:
            break
    return logs
