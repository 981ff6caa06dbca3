"""The client-axis process group of the sharded plane (pair:
``repro/launch/mesh.py:10-89``, ``ensure_sim_devices`` + ``make_sim_mesh``).

The JAX package shards a cohort's client axis over a 1-D device mesh
inside one program. The port runs one process a device (a *rank*) and
joins them in a ``torch.distributed`` process group: NCCL for the card,
gloo for the CPU. :func:`init_client_group` takes, in this order:

1. a default group that is already initialised (ranks spawned by the
   caller, or ``torchrun``'s after an earlier call);
2. ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
   ``MASTER_ADDR``, ``MASTER_PORT``);
3. with ``devices`` of None or 1, a single-rank group on an in-process
   ``HashStore``.

More ranks than one need a launcher; the error names it. Nothing falls
back: a group that cannot be made raises.

The production mesh of the dry-run (``launch/dryrun.py``) is a plain
description, axis names and sizes, that ``launch/specs.py`` reckons
per-device bytes over; nothing is placed on it. ``make_production_mesh``
lays N cards out as ``(data = N / m, model = m)`` with m = min(N, 8), one
HGX node's NVLink domain for the model axis. The JAX package's TPU meshes
(single pod 16x16, multi-pod 2x16x16) are not ported.

  torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train \\
      --arch resnet-56 --exec sharded --devices 2 --device cpu
"""
from __future__ import annotations

import os
from typing import NamedTuple

import torch
import torch.distributed as dist

from repro_torch import resolve_device

CLIENT_AXIS = "clients"
NODE_CARDS = 8          # one HGX node: the model axis's NVLink domain


class Mesh(NamedTuple):
    """A mesh as the dry-run reckons over it: axis names and sizes."""

    axis_names: tuple[str, ...]
    shape: tuple[int, ...]

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def axis_size(self, name: str) -> int:
        return dict(zip(self.axis_names, self.shape))[name]


def make_production_mesh(devices: int = 256) -> Mesh:
    """``(data = devices / m, model = m)``, m = min(devices, 8)."""
    m = min(devices, NODE_CARDS)
    if devices < 1 or devices % m:
        raise ValueError(f"a production mesh takes 1-8 cards or a multiple of {NODE_CARDS}, "
                         f"got {devices}")
    return Mesh(("data", "model"), (devices // m, m))


def data_axes(mesh: Mesh) -> tuple[str, ...]:
    """Axes that carry batch parallelism."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def make_host_mesh() -> Mesh:
    """The one-card mesh, (data 1, model 1)."""
    return Mesh(("data", "model"), (1, 1))


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def init_client_group(devices: int | None = None,
                      device: "str | torch.device | None" = None) -> torch.device:
    """Join (or make) the default process group of the sharded plane and
    return this rank's device: ``cuda:LOCAL_RANK`` on the card under
    ``torchrun``, else ``device`` (``None``: the card). Raises if
    ``devices > 1`` and no ranks were launched, or if ``devices`` differs
    from the group's world size."""
    device = resolve_device(device)
    if not dist.is_initialized():
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(_backend(device), init_method="env://")
        elif devices is None or devices == 1:
            dist.init_process_group(_backend(device), store=dist.HashStore(),
                                    rank=0, world_size=1)
        else:
            raise RuntimeError(
                f"--exec sharded --devices {devices} needs {devices} ranks, one a "
                f"device, and this process is alone; launch it as `torchrun "
                f"--standalone --nproc-per-node {devices} -m repro_torch.launch.train "
                f"... --exec sharded --devices {devices}`")
    world = dist.get_world_size()
    if devices is not None and devices != world:
        raise RuntimeError(
            f"--devices {devices} differs from the process group's {world} ranks; "
            f"launch `torchrun --standalone --nproc-per-node {devices} ...` or pass "
            f"--devices {world}")
    if device.type == "cuda":
        if "LOCAL_RANK" in os.environ:
            device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        elif device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    return device
