"""Rank entry of ``tests/test_torch_sharded.py``'s two-rank run.

The ranks are spawned processes, which import this module again; so it
imports ``torch`` and ``repro_torch`` only, never JAX. Each rank joins a
gloo group on a ``FileStore``, writes what ``ExecPlan.gather_clients``
gives it for a tree of known per-rank slices, and then runs the port's
CLI with ``argv`` (``--exec sharded --devices 2 --device cpu``), its
printed lines sent to a file a rank.
"""
import contextlib

import numpy as np
import torch
import torch.distributed as dist

GATHER_COLS = 6


def gather_slices(rank: int, width: int) -> dict:
    """This rank's slice of the gather check's tree: leaves of ``width``
    client columns whose values name the rank and the column."""
    base = torch.arange(width, dtype=torch.float32)[:, None] + 100.0 * (rank + 1)
    return {"a": base * torch.ones(width, 3), "b": [base[:, 0].to(torch.float64) - 0.5]}


def train_rank(rank: int, world: int, store_path: str, gather_path: str, argv: list,
               log_path: str) -> None:
    """One rank: its printed lines go to ``log_path.<rank>``."""
    with open(f"{log_path}.{rank}", "w") as f, contextlib.redirect_stdout(f):
        _train_rank(rank, world, store_path, gather_path, argv)


def _train_rank(rank, world, store_path, gather_path, argv) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        from repro_torch.fed.execplan import ExecPlan
        from repro_torch.launch import train
        from repro_torch.tree import tree_leaves

        plan = ExecPlan.sharded(devices=world)
        got = plan.gather_clients(gather_slices(rank, GATHER_COLS // world), GATHER_COLS)
        np.savez(f"{gather_path}.{rank}.npz", *[x.numpy() for x in tree_leaves(got)])
        train.main(argv)
    finally:
        dist.destroy_process_group()
