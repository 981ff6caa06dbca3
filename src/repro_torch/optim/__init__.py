"""Functional optimizers: SGD, Adam, Yogi (+ plateau LR schedule).

Pair: ``repro/optim/__init__.py:1``. An :class:`Optimizer` is an
(init, update) pair over parameter trees; updates return new tensors and
never write in place, so a cohort can keep or drop each client's update
with ``torch.where``. The learning rate rides in the state (``"lr"``) so a
host-side schedule can change it between rounds. Adam's step count ``"t"``
is an int32 tensor: 0-d for one model, (C,) once a cohort broadcasts the
state over its client axis (a masked client's count stays behind), and the
bias corrections ``1 - b ** t`` are computed in fp32 as in
``repro/optim/__init__.py:63-80``. Every update is elementwise, so it works
unchanged on client-stacked leaves.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map

Params = Any
OptState = Any


class Optimizer(NamedTuple):
    init: Callable[[Params], OptState]
    update: Callable[[Params, Params, OptState], tuple[Params, OptState]]


# ---------------------------------------------------------------------------
# SGD
# ---------------------------------------------------------------------------

def sgd(lr: float = 0.01, momentum: float = 0.0) -> Optimizer:
    def init(params):
        state = {"lr": float(lr)}
        if momentum:
            state["mu"] = tree_map(torch.zeros_like, params)
        return state

    def update(params, grads, state):
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g, state["mu"], grads)
            params = tree_map(lambda p, m: p - state["lr"] * m, params, mu)
            return params, {**state, "mu": mu}
        params = tree_map(lambda p, g: p - state["lr"] * g, params, grads)
        return params, state

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Adam / Yogi
# ---------------------------------------------------------------------------

def _per_client(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Broadcast a 0-d or (C,) per-client value against a (C, ...) leaf."""
    return x.reshape(x.shape + (1,) * (like.ndim - x.ndim))


def _adamlike(lr, b1, b2, eps, yogi: bool) -> Optimizer:
    def init(params):
        device = tree_leaves(params)[0].device
        return {
            "lr": float(lr),
            "t": torch.zeros((), dtype=torch.int32, device=device),
            "m": tree_map(torch.zeros_like, params),
            "v": tree_map(torch.zeros_like, params),
        }

    def update(params, grads, state):
        t = state["t"] + 1
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state["m"], grads)
        if yogi:
            # Yogi: v -= (1-b2) * sign(v - g^2) * g^2  (additive, sign-controlled)
            v = tree_map(
                lambda v_, g: v_ - (1 - b2) * torch.sign(v_ - g * g) * g * g,
                state["v"],
                grads,
            )
        else:
            v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * g * g, state["v"], grads)
        tf = t.float()
        bc1 = 1 - torch.pow(torch.full_like(tf, b1), tf)
        bc2 = 1 - torch.pow(torch.full_like(tf, b2), tf)

        def upd(p, m_, v_):
            mh = m_ / _per_client(bc1, m_)
            vh = v_ / _per_client(bc2, v_)
            return p - state["lr"] * mh / (torch.sqrt(torch.clamp_min(vh, 0.0)) + eps)

        params = tree_map(upd, params, m, v)
        return params, {**state, "t": t, "m": m, "v": v}

    return Optimizer(init, update)


def adam(lr: float = 1e-3, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    return _adamlike(lr, b1, b2, eps, yogi=False)


def yogi(lr: float = 1e-2, b1: float = 0.9, b2: float = 0.99, eps: float = 1e-3) -> Optimizer:
    return _adamlike(lr, b1, b2, eps, yogi=True)


def set_lr(opt_state: OptState, lr: float) -> OptState:
    return {**opt_state, "lr": float(lr)}


def get_lr(opt_state: OptState) -> float:
    return float(opt_state["lr"])


# ---------------------------------------------------------------------------
# reduce-on-plateau schedule (paper A.3: x0.9 when accuracy plateaus)
# ---------------------------------------------------------------------------

class PlateauSchedule:
    def __init__(self, factor: float = 0.9, patience: int = 5, min_delta: float = 1e-3):
        self.factor = factor
        self.patience = patience
        self.min_delta = min_delta
        self.best = -float("inf")
        self.bad = 0

    def step(self, metric: float, lr: float) -> float:
        """Call once per round with the current accuracy; returns the new lr."""
        if metric > self.best + self.min_delta:
            self.best = metric
            self.bad = 0
            return lr
        self.bad += 1
        if self.bad >= self.patience:
            self.bad = 0
            return lr * self.factor
        return lr
