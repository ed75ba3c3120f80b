"""Stub modality frontends: the backbone consumes precomputed patch or
frame embeddings.

Counterpart of ``repro/models/frontend.py``. For the vision (internvl2) and
audio (musicgen) archs the transformer takes ``(B, S, d_model)``
embeddings in place of token ids; this helper draws random but
shape-correct ones. It takes a ``torch.Generator`` where ``repro`` takes a
key (ROADMAP §3, "Generator for key").
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig

__all__ = ["stub_embeddings"]


def stub_embeddings(gen: torch.Generator, cfg: ModelConfig, batch: int,
                    seq: int, *, device="cuda") -> torch.Tensor:
    """Random unit-scale f32 embeddings standing in for ViT patches or
    EnCodec frames: (B, S, d_model), drawn on the generator's device and
    placed on ``device``."""
    x = torch.randn(batch, seq, cfg.d_model, generator=gen,
                    device=gen.device)
    return (x * cfg.d_model ** -0.5).to(resolve_device(device))
