"""Model configs of the port (pair: ``repro/configs/``).

``get_config(name)``, ``list_configs()`` and ``get_input_shape(name)`` as
in ``repro/configs/__init__.py:33-45``: every assigned architecture, in the
JAX package's order (``ASSIGNED_ARCHS``), and the dry-run's input shapes.
The paper's ResNets (``PAPER_MODELS``) live in ``configs/resnet_cifar.py``.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import INPUT_SHAPES, ArchConfig, InputShape  # noqa: F401

_ARCH_MODULES = {
    "whisper-base": "whisper_base",
    "granite-3-2b": "granite_3_2b",
    "pixtral-12b": "pixtral_12b",
    "yi-6b": "yi_6b",
    "xlstm-350m": "xlstm_350m",
    "hymba-1.5b": "hymba_1_5b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "deepseek-67b": "deepseek_67b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "smollm-360m": "smollm_360m",
}

ASSIGNED_ARCHS = list(_ARCH_MODULES)

PAPER_MODELS = ["resnet-56", "resnet-110"]


def get_config(name: str) -> ArchConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")
    return mod.CONFIG


def list_configs() -> list[str]:
    return list(_ARCH_MODULES)


def get_input_shape(name: str) -> InputShape:
    return INPUT_SHAPES[name]
