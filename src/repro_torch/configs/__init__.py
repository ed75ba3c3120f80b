"""Architecture registry: ``get_config(arch_id)`` for the archs whose model
the port runs.

Counterpart of ``repro/configs/__init__.py``. The port runs dense
attention-mixer models (gqa or rff attention), so the registry names
qwen2-0.5b and llama3-8b; the other archs of ``repro`` wait for MLA, MoE,
mamba2 and rglru (ROADMAP §1 item 11).
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
    "llama3-8b": "llama3_8b",
    "qwen2-0.5b": "qwen2_0_5b",
}

ARCH_IDS = tuple(_ARCHS)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _ARCHS:
        raise KeyError(
            f"arch {arch_id!r} is not ported to repro_torch (ROADMAP §1 item "
            f"11: MLA, MoE, mamba2 and rglru wait); ported: {sorted(_ARCHS)}"
        )
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
