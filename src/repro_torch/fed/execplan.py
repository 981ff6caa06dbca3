"""ExecPlan: how a round's client computations run (pair:
``repro/fed/execplan.py:34``).

* ``loop`` — one client at a time: the cohort program at width 1;
* ``cohort`` — one program per (tier, batch-shape) cohort over the whole
  cohort's client axis;
* ``chunked`` — the same cohort program run ``chunk_size`` clients at a
  time, so the training working set on the device (stacked batches,
  per-client optimizer states, activations) is O(chunk_size), not
  O(cohort).

All three run ``DTFLTrainer._train_chunked`` at the width :meth:`ExecPlan.width`
gives; they differ in nothing else.

The JAX package's ``sharded`` mode (``shard_map`` over a device mesh) is not
yet ported.
"""
from __future__ import annotations

from dataclasses import dataclass

MODES = ("loop", "cohort", "chunked")

DEFAULT_CHUNK_SIZE = 16


@dataclass(frozen=True)
class ExecPlan:
    """Execution mode + chunk policy for one trainer."""

    mode: str = "cohort"
    chunk_size: int | None = None   # client-chunk length, mode="chunked" only

    def __post_init__(self):
        if self.mode == "sharded":
            raise NotImplementedError("exec mode 'sharded' is not yet ported")
        if self.mode not in MODES:
            raise ValueError(f"unknown exec mode {self.mode!r}; pick from {MODES}")
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

    @classmethod
    def from_flags(cls, exec_mode: str, *, chunk_size: int | None = None) -> "ExecPlan":
        """CLI adapter: ``--exec`` + ``--chunk-size`` -> ExecPlan."""
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

    def width(self, n_cols: int) -> int:
        """Client columns per cohort program, for a cohort of ``n_cols``
        columns (real + pad)."""
        return {"loop": 1, "cohort": n_cols, "chunked": self.chunk_size}[self.mode]

    @property
    def pad_multiple(self) -> int:
        """Client-axis divisibility required by this plan's chunking."""
        return self.chunk_size if self.mode == "chunked" else 1
