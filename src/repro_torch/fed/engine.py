"""Round engines (pair: ``repro/fed/engine.py``): the synchronous rounds
loop (``run_rounds``, ``:196``), the event-driven sync engine with churn
(``run_events``, ``:271``), the async tier engine (``run_async``, ``:414``)
and the resumable train-state envelope (``:115-180``).

Trainer contract (as in the JAX package): ``train_round(r, participants)``
plans, trains and observes one round and returns ``(straggler, assign)``;
the events engine calls its parts, ``plan_round``, ``execute_round`` and
``observe_round``, and drains completion, dropout and mid-round switch
events between them. The async engine also calls ``train_group(r, plan,
trained) -> (tree, weight)``, which trains a group without committing the
result, and ``async_groups(cids, n_groups)``, the fast-to-slow speed groups.
Every engine fills ``RoundLog.wall_s`` and calls ``on_round(trainer, log)``
after each round (each merge, under async). On the sharded plane every
rank runs the engine and returns the same logs; only rank 0 writes
checkpoints (and prints: the trainers' ``run`` passes ``verbose`` on rank 0
only).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch.core import aggregation, timemodel
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


def split_speed_groups(order: list[int], n_groups: int) -> list[list[int]]:
    """Slice a fast->slow ordering into ``n_groups`` contiguous speed groups
    (the remainder joins the slowest group; fewer clients than groups yields
    fewer groups)."""
    cut = max(1, len(order) // n_groups)
    groups = [order[i * cut: (i + 1) * cut] for i in range(n_groups - 1)]
    groups.append(order[(n_groups - 1) * cut:])
    return [g for g in groups if g]


def _participants_rng() -> np.random.Generator:
    # the JAX package's loops draw participants from default_rng(0)
    return np.random.default_rng(0)


# ---------------------------------------------------------------------------
# resumable training state (train.py --save-every / --out-ckpt / --resume)
# ---------------------------------------------------------------------------

# the rounds and events engines share round/clock/rng semantics, so their
# envelopes resume interchangeably; async envelopes count merges, not rounds
_SYNC_ENGINES = frozenset({"rounds", "events"})


def save_train_state(path: str, trainer, *, round_: int, clock: float,
                     rng: np.random.Generator | None = None,
                     acc: float = 0.0, engine: str = "rounds") -> None:
    """Checkpoint the full run state as one envelope: the trainer's state
    (params, per-tier aux heads, scheduler history, env profile state, EF
    residuals) plus the loop cursor (next round, virtual clock, last
    evaluated accuracy), the participant-sampling rng stream and the
    originating engine. A spec-built trainer (``repro_torch.api.Federation``)
    also stamps the envelope with its spec's hash and canonical JSON."""
    state = {"round": np.int64(round_), "clock": np.float64(clock),
             "acc": np.float64(acc), "engine": engine,
             "trainer": trainer.save_state()}
    if rng is not None:
        state["rng"] = ckpt.pack_rng(rng)
    stamp = getattr(trainer, "_spec_stamp", None)
    if stamp is not None:
        state["spec"] = dict(stamp)
    ckpt.save(path, state)


def _save_on_lead(path: str, trainer, **kw) -> None:
    """:func:`save_train_state` on rank 0 only (``ExecPlan.lead``; every
    process of an unsharded run); the other ranks wait for it at a
    barrier. Every rank holds the same state."""
    if trainer.exec_plan.lead:
        save_train_state(path, trainer, **kw)
    trainer.exec_plan.barrier()


def apply_resume(trainer, resume: dict, rng: np.random.Generator,
                 *, engine: str) -> tuple[int, float, float]:
    """Restore a :func:`save_train_state` envelope into ``trainer`` and the
    caller's participant rng (mutated in place so the stream continues);
    returns (start_round, start_clock, last_acc). Rejects envelopes whose
    originating engine is incompatible with ``engine``."""
    src = str(resume["engine"]) if "engine" in resume else None
    if src is not None and not (src in _SYNC_ENGINES and engine in _SYNC_ENGINES):
        raise ValueError(
            f"checkpoint was written by engine={src!r}; it cannot resume a "
            f"run under engine={engine!r} (round counters and rng streams "
            "are engine-specific)")
    trainer.load_state(resume["trainer"])
    if "rng" in resume:
        rng.bit_generator.state = ckpt.unpack_rng(resume["rng"]).bit_generator.state
    return (int(resume["round"]), float(resume["clock"]),
            float(resume.get("acc", 0.0)))


def restore_trainer(trainer, path: str) -> None:
    """Load trainer state from ``path``: a bare ``save_state()`` dump or a
    :func:`save_train_state` envelope (unwrapped)."""
    state = ckpt.load(path)
    trainer.load_state(state["trainer"] if "trainer" in state else state)


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
    checkpoint_path: str | None = None,
    checkpoint_every: int = 10,
    resume: dict | None = None,
    on_round: Callable[[object, RoundLog], None] | None = None,
) -> list[RoundLog]:
    """The scalar-clock synchronous loop: sample participants,
    ``train_round``, accumulate the straggler clock, eval on the global
    model, log, checkpoint every ``checkpoint_every`` rounds and at the end.
    ``on_round(trainer, log)`` is called after each round."""
    rng = _participants_rng()
    eval_fn, eval_batch = _eval_setup(trainer, eval_batch)
    clock, logs = 0.0, []
    start_round, last_acc = 0, 0.0
    if resume is not None:
        start_round, clock, last_acc = apply_resume(
            trainer, resume, rng, engine="rounds")
    next_round = start_round
    n_part = _round_sample_size(len(trainer.clients), participation, sample_size)
    for r in range(start_round, n_rounds):
        t0 = time.perf_counter()
        participants = sorted(
            rng.choice(len(trainer.clients), n_part, replace=False).tolist()
        )
        straggler, assign = trainer.train_round(r, participants)
        clock += straggler
        acc = eval_fn(trainer.params, eval_batch) if r % eval_every == 0 else (
            logs[-1].acc if logs else last_acc)
        logs.append(RoundLog(r, clock, acc, assign, straggler,
                             uplink_bytes=trainer.last_uplink_bytes,
                             hosts=trainer.last_hosts,
                             wall_s=_synced_wall(trainer, t0)))
        next_round = r + 1
        if on_round is not None:
            on_round(trainer, logs[-1])
        if verbose:
            tiers = f" tiers={sorted(set(assign.values()))}" if assign else ""
            hosts = logs[-1].hosts
            pairs = f" pairs={sorted(hosts.items())}" if hosts else ""
            print(f"[{trainer.name}] r={r} clock={clock:.0f}s acc={acc:.3f}"
                  f"{tiers}{pairs} wall={logs[-1].wall_s:.2f}s")
        if checkpoint_path and (r + 1) % checkpoint_every == 0:
            _save_on_lead(checkpoint_path, trainer, round_=r + 1,
                          clock=clock, rng=rng, acc=acc)
        if target_acc is not None and acc >= target_acc:
            break
    if checkpoint_path:
        _save_on_lead(checkpoint_path, trainer, round_=next_round,
                      clock=clock, rng=rng,
                      acc=logs[-1].acc if logs else last_acc)
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
    """Host seconds since ``t0`` once the device has finished the work; on
    the sharded plane the slowest rank's, so every rank logs the same."""
    if trainer.device.type == "cuda":
        torch.cuda.synchronize(trainer.device)
    return trainer.exec_plan.max_over_ranks(time.perf_counter() - t0, trainer.device)


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
    checkpoint_path: str | None = None,
    checkpoint_every: int = 10,
    resume: dict | None = None,
    on_round: Callable[[object, RoundLog], None] | None = None,
) -> list[RoundLog]:
    """Event-driven sync rounds (``repro/fed/engine.py:271-407``): every
    trained client's completion is an event; with a ``ChurnModel`` dropouts
    cancel completions and mid-round profile switches reschedule them.
    Without churn it equals :func:`run_rounds`. A resumed run restarts the
    virtual clock at the envelope's; churn state is not checkpointed, so a
    resume with churn is refused."""
    rng = _participants_rng()
    eval_fn, eval_batch = _eval_setup(trainer, eval_batch)
    q = EventQueue()
    logs: list[RoundLog] = []
    n_clients = len(trainer.clients)

    start_round, last_acc = 0, 0.0
    if resume is not None:
        if churn is not None:
            raise ValueError("resume with churn is unsupported (the churn "
                             "model's offline/arrival state is not "
                             "checkpointed); restart without --churn")
        start_round, clock0, last_acc = apply_resume(
            trainer, resume, rng, engine="events")
        q.advance_to(clock0)
    next_round = start_round

    for r in range(start_round, n_rounds):
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
            logs[-1].acc if logs else last_acc)
        logs.append(RoundLog(r, q.now, acc, plan.assign, straggler,
                             uplink_bytes=trainer.last_uplink_bytes,
                             hosts=_plan_hosts(plan),
                             wall_s=_synced_wall(trainer, t0)))
        next_round = r + 1
        if on_round is not None:
            on_round(trainer, logs[-1])
        if verbose:
            dropped = len(plan.trained) - len(trained)
            hosts = logs[-1].hosts
            print(f"[events:{trainer.name}] r={r} clock={q.now:.0f}s acc={acc:.3f}"
                  + (f" dropped={dropped}" if dropped else "")
                  + (f" pairs={sorted(hosts.items())}" if hosts else "")
                  + f" wall={logs[-1].wall_s:.2f}s")
        if checkpoint_path and (r + 1) % checkpoint_every == 0:
            _save_on_lead(checkpoint_path, trainer, round_=r + 1,
                          clock=q.now, rng=rng, acc=acc, engine="events")
        if target_acc is not None and acc >= target_acc:
            break
    if checkpoint_path:
        _save_on_lead(checkpoint_path, trainer, round_=next_round,
                      clock=q.now, rng=rng,
                      acc=logs[-1].acc if logs else last_acc,
                      engine="events")
    return logs


# ===========================================================================
# async mode: FedAT-style per-tier pacing + staleness-weighted merge
# ===========================================================================

def run_async(
    trainer,
    n_rounds: int,
    eval_batch: dict,
    *,
    target_acc: float | None = None,
    participation: float = 1.0,
    eval_every: int = 1,
    verbose: bool = False,
    churn=None,
    n_groups: int = 3,
    staleness_lambda: float = 1.0,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 10,
    resume: dict | None = None,
    on_round: Callable[[object, RoundLog], None] | None = None,
) -> list[RoundLog]:
    """Async tier federation (``repro/fed/engine.py:414-575``): ``n_rounds``
    is a per-group wave budget, so the merge budget is ``n_rounds *
    n_groups``. A group's merge weight is its sample count over ``1 +
    staleness_lambda * staleness`` (FedAT sets ``staleness_lambda``).

    Wave 0 is a synchronous profiling round over all participants; it seeds
    the speed estimates ``async_groups`` needs. After it each group
    schedules its own completion events and the clock advances per group
    straggler. A wave trains from the global params as they were at wave
    LAUNCH, not from merges that landed while it was in flight, and its
    result joins a staleness-weighted merge over the groups that reported.
    The snapshot is the params dict itself: every update of the params
    builds new tensors (optimizer, aggregation, ``load_state``), so a merge
    that lands meanwhile never changes it. ``checkpoint_every`` counts
    merges; resume is refused (the in-flight wave queue is not
    checkpointed). Each merge's ``RoundLog.wall_s`` is the host seconds
    since the previous log, device work included."""
    if resume is not None:
        raise ValueError("resume is supported for engine='rounds'/'events' "
                         "only (the async engine's in-flight wave queue is "
                         "not checkpointed)")
    t0 = time.perf_counter()
    rng = _participants_rng()
    eval_fn, eval_batch = _eval_setup(trainer, eval_batch)
    q = EventQueue()
    logs: list[RoundLog] = []
    n_clients = len(trainer.clients)
    budget = max(1, n_rounds) * n_groups

    def log_merge(log: RoundLog) -> None:
        nonlocal t0
        log.wall_s = _synced_wall(trainer, t0)
        logs.append(log)
        if on_round is not None:
            on_round(trainer, log)
        t0 = time.perf_counter()

    # ---- wave 0: synchronous profiling round (seeds speed estimates) ----
    pool = churn.begin_round(0) if churn is not None else np.arange(n_clients)
    n_part = max(1, min(len(pool), int(participation * n_clients)))
    participants = sorted(rng.choice(pool, n_part, replace=False).tolist())
    plan0 = trainer.plan_round(0, participants)
    trainer.execute_round(0, plan0, plan0.trained)
    idx0 = list(range(len(plan0.trained)))
    trainer.observe_round(
        plan0, idx0,
        plan0.obs["t"] if plan0.obs is not None else plan0.times, plan0.times,
    )
    q.advance_to(float(plan0.times.max()))
    acc = eval_fn(trainer.params, eval_batch)
    log_merge(RoundLog(0, q.now, acc, plan0.assign, float(plan0.times.max()),
                       uplink_bytes=trainer.last_uplink_bytes,
                       hosts=_plan_hosts(plan0)))
    if verbose:
        print(f"[async:{trainer.name}] wave=0 clock={q.now:.0f}s acc={acc:.3f} "
              f"wall={logs[-1].wall_s:.2f}s")
    if target_acc is not None and acc >= target_acc:
        return logs

    # ---- async phase ----
    groups = trainer.async_groups(list(range(n_clients)), n_groups)
    tier_model: dict[int, object] = {}
    tier_weight: dict[int, float] = {}
    last_merge: dict[int, int] = {}
    wave_idx = {g: 1 for g in range(len(groups))}
    last_wave_time = {g: float(plan0.times.max()) for g in range(len(groups))}
    version = 0
    merges = 0

    def launch(g: int) -> None:
        members = groups[g]
        if churn is not None:
            act = set(churn.active())
            members = [k for k in members if k in act]
        if participation < 1.0 and members:
            m = max(1, int(participation * len(members)))
            members = sorted(rng.choice(members, m, replace=False).tolist())
        if not members:
            # whole group offline: re-poll after the group's last wave
            # duration (its natural pace), so rejoin latency stays bounded
            q.push_in(max(last_wave_time[g], 1.0), "wave", g=g, plan=None)
            return
        plan = trainer.plan_round(wave_idx[g], members)
        last_wave_time[g] = float(plan.times.max())
        # snapshot the global params the tier downloads at wave start; the
        # wave trains from this even if other groups merge meanwhile
        q.push_in(last_wave_time[g], "wave", g=g, plan=plan,
                  start_params=trainer.params)

    for g in range(len(groups)):
        launch(g)

    while merges < budget:
        ev = q.pop()
        if ev is None:
            break
        g, plan = ev.payload["g"], ev.payload["plan"]
        if churn is not None:
            churn.begin_round(wave_idx[g])
        if plan is None:
            launch(g)
            continue
        # churn inside the wave: dropouts leave the wave, switches re-roll
        # the ground-truth profile for FUTURE waves
        idx = list(range(len(plan.trained)))
        if churn is not None:
            for kind, i, _ in churn.sample_mid_round(plan.trained, plan.times):
                if kind == "dropout":
                    churn.mark_offline(plan.trained[i])
                    idx.remove(i)
                else:
                    churn.resample_profile(trainer.env, plan.trained[i])
        trained = [plan.trained[i] for i in idx]
        wave_time = float(plan.times.max())
        if trained:
            # train from the wave-launch snapshot, then restore the merged
            # global
            current = trainer.params
            trainer.params = ev.payload["start_params"]
            try:
                tree, w = trainer.train_group(wave_idx[g], plan, trained)
            finally:
                trainer.params = current
            tier_model[g], tier_weight[g] = tree, w
            last_merge[g] = version
            version += 1
            # staleness-weighted cross-tier merge over groups that reported
            gs = sorted(tier_model)
            betas = [tier_weight[x] / (1.0 + staleness_lambda * (version - 1 - last_merge[x]))
                     for x in gs]
            with torch.no_grad():
                trainer.params = aggregation.weighted_average(
                    [tier_model[x] for x in gs], betas)
            obs_t = (plan.obs["t"][np.asarray(idx, int)]
                     if plan.obs is not None else plan.times[np.asarray(idx, int)])
            trainer.observe_round(plan, idx, obs_t, plan.times)
            merges += 1
            acc = eval_fn(trainer.params, eval_batch) if (
                merges % eval_every == 0) else logs[-1].acc
            log_merge(RoundLog(merges, q.now, acc, dict(plan.assign), wave_time,
                               uplink_bytes=trainer.last_uplink_bytes,
                               hosts=_plan_hosts(plan)))
            if verbose:
                print(f"[async:{trainer.name}] merge={merges} group={g} "
                      f"clock={q.now:.0f}s acc={acc:.3f} wall={logs[-1].wall_s:.2f}s")
            if checkpoint_path and merges % checkpoint_every == 0:
                _save_on_lead(checkpoint_path, trainer, round_=merges,
                              clock=q.now, acc=acc, engine="async")
            if target_acc is not None and acc >= target_acc:
                break
        wave_idx[g] += 1
        launch(g)
    if checkpoint_path:
        _save_on_lead(checkpoint_path, trainer, round_=merges, clock=q.now,
                      acc=logs[-1].acc, engine="async")
    return logs
