"""Optimizers and schedules of the training step (``repro.optim``'s
exports)."""
from repro_torch.optim.optimizers import (
    AdamWState,
    adamw_init,
    adamw_update,
    global_norm,
    sgd_update,
)
from repro_torch.optim import schedules

__all__ = [
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "global_norm",
    "sgd_update",
    "schedules",
]
