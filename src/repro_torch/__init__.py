"""PyTorch/CUDA port of the DTFL reproduction (pair: ``src/repro/``).

The port keeps the JAX package's layout at its public functions: the same
nested dict/list parameter trees with the same keys, HWIO convolution
weights and NHWC activations, so ``bridge.py`` copies trees leaf by leaf.
Unlike the JAX package, every model function takes a leading client axis
on parameters and activations; the cohort of a tier trains as batched
products over that axis.

Entry points run on the card: ``device=None`` means ``"cuda"`` and raises
when no CUDA device is present. Pass ``device="cpu"`` to run on the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """``None`` -> the card. Raises if a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev
