"""Model configs of the port (pair: ``repro/configs/``).

``get_config(name)`` as in ``repro/configs/__init__.py:33``: the assigned
architectures the port runs so far; the others raise "not yet ported".
The paper's ResNets live in ``configs/resnet_cifar.py``.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig  # noqa: F401

_ARCH_MODULES = {
    "granite-3-2b": "granite_3_2b",
    "yi-6b": "yi_6b",
    "xlstm-350m": "xlstm_350m",
    "hymba-1.5b": "hymba_1_5b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "deepseek-67b": "deepseek_67b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "smollm-360m": "smollm_360m",
}
# the JAX package's other assigned architectures (repro/configs/__init__.py:12)
_NOT_YET_PORTED = ("whisper-base", "pixtral-12b")


def get_config(name: str) -> ArchConfig:
    if name in _NOT_YET_PORTED:
        raise NotImplementedError(f"arch {name!r} is not yet ported; "
                                  f"ported: {sorted(_ARCH_MODULES)}")
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.CONFIG
