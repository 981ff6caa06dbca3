"""Synchronous rounds engine (pair: ``repro/fed/engine.py:196``, ``run_rounds``).

Trainer contract (as in the JAX package): ``train_round(r, participants)``
plans, trains and observes one round and returns ``(straggler, assign)``.
The events and async engines and checkpoints come in a later slice.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch


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
    device = trainer.device
    eval_batch = {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in eval_batch.items()}
    clock, logs = 0.0, []
    n_part = _round_sample_size(len(trainer.clients), participation, sample_size)
    for r in range(n_rounds):
        t0 = time.perf_counter()
        participants = sorted(
            rng.choice(len(trainer.clients), n_part, replace=False).tolist()
        )
        straggler, assign = trainer.train_round(r, participants)
        clock += straggler
        if r % eval_every == 0:
            with torch.no_grad():
                acc = float(trainer.adapter.eval_acc(trainer.params, eval_batch))
        else:
            acc = logs[-1].acc if logs else 0.0
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        logs.append(RoundLog(r, clock, acc, assign, straggler,
                             uplink_bytes=trainer.last_uplink_bytes,
                             wall_s=time.perf_counter() - t0))
        if on_round is not None:
            on_round(trainer, logs[-1])
        if verbose:
            tiers = f" tiers={sorted(set(assign.values()))}" if assign else ""
            print(f"[{trainer.name}] r={r} clock={clock:.0f}s acc={acc:.3f}"
                  f"{tiers} wall={logs[-1].wall_s:.2f}s")
        if target_acc is not None and acc >= target_acc:
            break
    return logs
