"""The serving step functions of ``repro/train/steps.py``: prefill and
decode. The training step (grad accumulation, AdamW) waits for the port of
``lm_loss`` and ``optim`` (ROADMAP §1 entry 7)."""
from __future__ import annotations

from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer

__all__ = ["make_prefill_step", "make_decode_step"]


def make_prefill_step(cfg: ModelConfig, *,
                      kernel_mode: str = "auto") -> Callable:
    """``prefill(params, batch) -> last-position logits (B, V)``.

    ``batch``: ``{"tokens": (B, S)}``, or ``{"embeds": (B, S, d)}`` for the
    frontend archs. The whole sequence goes through the layer stack at once
    (the chunked RFF or the flash attention kernel where the arch has
    them); the head runs on the last position only."""
    def prefill_step(params, batch: dict):
        x = transformer.embed_inputs(params, cfg, batch.get("tokens"),
                                     batch.get("embeds"))
        h = transformer.apply_stack(params, cfg, x, kernel_mode=kernel_mode)
        return transformer.head_logits(params, cfg, h[:, -1:, :])[:, 0]

    return prefill_step


def make_decode_step(cfg: ModelConfig, *,
                     kernel_mode: str = "auto") -> Callable:
    """``decode(params, state, batch) -> (logits, new_state)`` with
    ``batch`` ``{"token": (B,)}`` or ``{"embed": (B, 1, d)}``."""
    def decode(params, state, batch: dict):
        return transformer.decode_step(params, cfg, state, batch.get("token"),
                                       embed_in=batch.get("embed"),
                                       kernel_mode=kernel_mode)

    return decode
