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
back: a group that cannot be made raises. The production-mesh functions
(``make_production_mesh``, ``data_axes``, ``make_host_mesh``) wait for
the dry-run (ROADMAP).

  torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train \\
      --arch resnet-56 --exec sharded --devices 2 --device cpu
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from repro_torch import resolve_device

CLIENT_AXIS = "clients"


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
