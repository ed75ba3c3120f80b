"""Architecture registry: ``get_config(arch_id)`` for all ten archs.

Counterpart of ``repro/configs/__init__.py``: the same names, each config
field for field ``repro``'s (shapes only; no weights are loaded).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (
    SHAPES,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    ShapeSpec,
)

_ARCHS = {
    "internvl2-2b": "internvl2_2b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "arctic-480b": "arctic_480b",
    "mamba2-130m": "mamba2_130m",
    "command-r-35b": "command_r_35b",
    "minicpm3-4b": "minicpm3_4b",
    "llama3-8b": "llama3_8b",
    "qwen2-0.5b": "qwen2_0_5b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "musicgen-large": "musicgen_large",
}

ARCH_IDS = tuple(_ARCHS)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCHS[arch_id]}")
    return mod.CONFIG


__all__ = [
    "ARCH_IDS",
    "get_config",
    "ModelConfig",
    "MoEConfig",
    "MLAConfig",
    "ShapeSpec",
    "SHAPES",
]
