"""ExecPlan: how a round's client computations run (pair:
``repro/fed/execplan.py:34-200``).

* ``loop`` — one client at a time: the cohort program at width 1;
* ``cohort`` — one program per (tier, batch-shape) cohort over the whole
  cohort's client axis;
* ``chunked`` — the same cohort program run ``chunk_size`` clients at a
  time, so the training working set on the device (stacked batches,
  per-client optimizer states, activations) is O(chunk_size), not
  O(cohort);
* ``sharded`` — the cohort's client axis split over the ranks of a
  ``torch.distributed`` process group (one process a device:
  ``launch/mesh.py``). Every rank runs the same host program (scheduler,
  time model, data and clocks are deterministic from the seed); rank r
  trains columns ``[r C/n, (r+1) C/n)`` of each cohort, padded to a
  multiple of n with weight-0 clients that never step. Each rank's
  ``weighted_sum`` partials and weight totals are all-reduced, so every
  rank holds the same global parameters and no per-client tree leaves
  its device. One rank is bit-equal to the cohort plane; n ranks differ
  from it in the order of the cross-rank sum and in the width of each
  rank's products.

Every plane runs ``DTFLTrainer._train_chunked`` (and the baselines'
``_train_round_full``) over the client slices :meth:`ExecPlan.slices`
gives: chunks of :meth:`ExecPlan.width` clients, or this rank's columns.
The collectives live here and nowhere else, and are the identity off the
sharded plane. The process group is made by
``launch.mesh.init_client_group`` (``api.Federation`` calls it); a plan
only reads it.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from repro_torch.core.aggregation import weighted_sum
from repro_torch.fed.cohort import chunk_slices
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

MODES = ("loop", "cohort", "sharded", "chunked")

DEFAULT_CHUNK_SIZE = 16


@dataclass(frozen=True)
class ExecPlan:
    """Execution mode + chunk policy for one trainer; the sharded plane's
    ranks are those of the default process group."""

    mode: str = "cohort"
    chunk_size: int | None = None   # client-chunk length, mode="chunked" only

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown exec mode {self.mode!r}; pick from {MODES}")
        if self.mode == "sharded" and not dist.is_initialized():
            raise ValueError("ExecPlan(mode='sharded') needs an initialised process "
                             "group; call launch.mesh.init_client_group first")
        if self.mode == "chunked":
            if self.chunk_size is None:
                object.__setattr__(self, "chunk_size", DEFAULT_CHUNK_SIZE)
            if self.chunk_size < 1:
                raise ValueError(
                    f"ExecPlan(mode='chunked') needs chunk_size >= 1, got "
                    f"{self.chunk_size!r}")
        elif self.chunk_size is not None:
            raise ValueError(
                f"chunk_size is a mode='chunked' knob; mode={self.mode!r} "
                "does not take one")

    # ------------------------------------------------------------------
    @classmethod
    def sharded(cls, *, devices: int | None = None) -> "ExecPlan":
        """The sharded plan over the initialised default group; ``devices``,
        if given, must be its world size."""
        plan = cls(mode="sharded")
        if devices is not None and devices != plan.n_shards:
            raise RuntimeError(f"devices={devices} differs from the process group's "
                               f"{plan.n_shards} ranks")
        return plan

    @classmethod
    def from_flags(cls, exec_mode: str, *, devices: int | None = None,
                   chunk_size: int | None = None) -> "ExecPlan":
        """CLI adapter: ``--exec`` + ``--devices``/``--chunk-size`` -> ExecPlan."""
        if exec_mode == "sharded":
            return cls.sharded(devices=devices)
        if exec_mode == "chunked":
            return cls(mode="chunked", chunk_size=chunk_size)
        return cls(mode=exec_mode)

    @classmethod
    def resolve(cls, plan: "ExecPlan | str | None") -> "ExecPlan":
        """Trainer-ctor adapter: None -> cohort default, str -> mode name."""
        if plan is None:
            return cls()
        if isinstance(plan, str):
            return cls.from_flags(plan)
        return plan

    # ------------------------------------------------------------------
    @property
    def n_shards(self) -> int:
        return dist.get_world_size() if self.mode == "sharded" else 1

    @property
    def rank(self) -> int:
        return dist.get_rank() if self.mode == "sharded" else 0

    @property
    def lead(self) -> bool:
        """Whether this process prints and writes (rank 0)."""
        return self.rank == 0

    @property
    def pad_multiple(self) -> int:
        """Client-axis divisibility required by this plan's chunking or
        sharding."""
        if self.mode == "sharded":
            return self.n_shards
        return self.chunk_size if self.mode == "chunked" else 1

    def width(self, n_cols: int) -> int:
        """Client columns per cohort program, for a cohort of ``n_cols``
        columns (real + pad)."""
        if self.mode == "sharded":
            return n_cols // self.n_shards
        return {"loop": 1, "cohort": n_cols, "chunked": self.chunk_size}[self.mode]

    def slices(self, n_cols: int) -> list[slice]:
        """The client-axis slices this process runs, one cohort program
        each, of a cohort of ``n_cols`` columns: ``width``-client chunks,
        or on the sharded plane this rank's columns."""
        if self.mode == "sharded":
            return [self.shard_slice(n_cols)]
        return chunk_slices(n_cols, self.width(n_cols))

    def shard_slice(self, n_cols: int) -> slice:
        """This rank's columns of a cohort of ``n_cols`` (real + pad)."""
        w = self.width(n_cols)
        return slice(self.rank * w, (self.rank + 1) * w)

    def describe(self) -> str:
        if self.mode == "sharded":
            return f"sharded[clients={self.n_shards}]"
        if self.mode == "chunked":
            return f"chunked[{self.chunk_size}]"
        return self.mode

    # ------------------------------------------------------------------
    # collectives (repro/fed/execplan.py:181-189): SUM over the ranks
    # ------------------------------------------------------------------
    def _all_reduce_leaves(self, leaves: list, op=dist.ReduceOp.SUM) -> list:
        """All-reduce every leaf, one collective per dtype over the leaves
        laid end to end; returns new tensors (the leaves themselves off the
        sharded plane)."""
        if self.mode != "sharded":
            return list(leaves)
        out = [None] * len(leaves)
        by_dtype: dict = {}
        for i, x in enumerate(leaves):
            by_dtype.setdefault(x.dtype, []).append(i)
        for idx in by_dtype.values():
            flat = torch.cat([leaves[i].reshape(-1) for i in idx])
            dist.all_reduce(flat, op=op)
            parts = torch.split(flat, [leaves[i].numel() for i in idx])
            for i, p in zip(idx, parts):
                out[i] = p.view(leaves[i].shape)
        return out

    def all_reduce_tree(self, tree, scaled_by=None):
        """The cross-rank sum of a tree (``psum_tree``); with
        ``scaled_by``, of its ``weighted_sum`` over this process's
        clients."""
        if scaled_by is not None:
            tree = weighted_sum(tree, scaled_by)
        return tree_unflatten(tree, self._all_reduce_leaves(tree_leaves(tree)))

    def all_reduce_scalar(self, x: torch.Tensor) -> torch.Tensor:
        """The cross-rank sum of a 0-d tensor (``psum_scalar``)."""
        (out,) = self._all_reduce_leaves([x])
        return out

    def max_over_ranks(self, value: float, device) -> float:
        """The largest of every rank's ``value`` (a round's wall seconds);
        ``value`` itself off the sharded plane."""
        if self.mode != "sharded":
            return value  # no tensor to make
        (out,) = self._all_reduce_leaves(
            [torch.tensor([value], dtype=torch.float64, device=device)],
            op=dist.ReduceOp.MAX)
        return float(out.item())

    def gather_clients(self, tree, n_cols: int):
        """Every rank's per-client outputs (leading axis: this rank's
        ``width(n_cols)`` columns) as one tree of ``n_cols`` columns on
        every rank (``client_outs``): this rank's slice written into a
        zero buffer, then summed over the ranks; adding zeros is exact."""
        sl = self.shard_slice(n_cols)

        def place(x):
            buf = torch.zeros((n_cols,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
            buf[sl] = x
            return buf

        return self.all_reduce_tree(tree_map(place, tree))

    def barrier(self) -> None:
        """Wait for every rank (after rank 0 writes a file)."""
        if self.mode == "sharded" and self.n_shards > 1:
            dist.barrier()

