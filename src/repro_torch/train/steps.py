"""Step functions: train (gradient accumulation over microbatches and
AdamW), prefill and decode.

Counterpart of ``repro/train/steps.py``. ``repro`` jits these; the port
runs them eagerly. The model functions take ``kernel_mode`` ("auto",
"cuda" or "ref"): under autograd the attention kernels (10 and 11) run
their CUDA forward and their plain version's gradient
(``kernels/ops.py``).
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.optim import schedules
from repro_torch.optim.optimizers import (
    adamw_init,
    adamw_update,
    global_norm,
)
from repro_torch.optim.tree import leaves, tree_map, unflatten

__all__ = [
    "TrainStateDict",
    "init_train_state",
    "make_train_step",
    "make_prefill_step",
    "make_decode_step",
]

TrainStateDict = dict  # {"params", "opt": AdamWState, "step": () int32}


def init_train_state(gen: torch.Generator, cfg: ModelConfig, *,
                     device="cuda") -> TrainStateDict:
    """Random parameters drawn from ``gen`` (``models.init_params``), zero
    AdamW moments in ``cfg.opt_dtype`` and step 0, on ``device``."""
    dev = resolve_device(device)
    params = transformer.init_params(gen, cfg, device=dev)
    return {"params": params, "opt": adamw_init(params, cfg.opt_dtype),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _value_and_grad(loss_fn: Callable, params: Any, batch: dict):
    """(loss, grads) of ``loss_fn(params, batch)``: each floating leaf is
    differentiated; a leaf that the loss does not reach (the RFF feature
    buffers, which the model detaches) gets a zero gradient, as
    ``jax.value_and_grad`` gives it through ``stop_gradient``."""
    with torch.enable_grad():
        live = tree_map(lambda p: p.detach().requires_grad_(
            p.is_floating_point()), params)
        flat = leaves(live)
        loss = loss_fn(live, batch)
        wanted = [p for p in flat if p.requires_grad]
        got = iter(torch.autograd.grad(loss, wanted, allow_unused=True))
    grads = []
    for p in flat:
        g = next(got) if p.requires_grad else None
        grads.append(torch.zeros_like(p) if g is None else g)
    return loss.detach(), unflatten(params, grads)


def make_train_step(cfg: ModelConfig, *, num_microbatches: int = 1,
                    lr_schedule: Optional[Callable] = None,
                    peak_lr: float = 3e-4,
                    batch_axes: Optional[tuple] = None, grad_specs: Any = None,
                    kernel_mode: str = "auto") -> Callable:
    """Returns ``train_step(state, batch) -> (new state, metrics)``.

    ``batch``: ``{"tokens": (B, S) int}`` or, for the frontend archs,
    ``{"embeds": (B, S, d), "labels": (B, S) int}``. The global batch is
    split in order into ``num_microbatches`` microbatches of B / n rows;
    each microbatch's gradients (in the parameters' dtype) are added into
    an accumulator in ``cfg.opt_dtype``, microbatch by microbatch, and the
    sum divided by n. Then one ``adamw_update`` at ``lr_schedule(step)``
    (default: ``peak_lr`` constant). ``metrics``: ``loss`` (the mean over
    the microbatches), ``grad_norm`` (of the averaged gradients) and
    ``lr``, each a 0-d tensor.

    The step returns a new state; ``repro`` donates the old one to its
    jitted step (the trainer's ``donate_argnums=(0,)``), and the port's
    callers likewise drop it. ``batch_axes`` and ``grad_specs`` are
    ``repro``'s sharding constraints, accepted and ignored on one device.
    """
    del batch_axes, grad_specs
    if lr_schedule is None:
        lr_schedule = functools.partial(schedules.constant, lr=peak_lr)
    acc_dtype = getattr(torch, cfg.opt_dtype)
    n = num_microbatches

    def loss_fn(params, mb):
        return transformer.lm_loss(params, cfg, tokens=mb.get("tokens"),
                                   embeds=mb.get("embeds"),
                                   labels=mb.get("labels"),
                                   kernel_mode=kernel_mode)

    def train_step(state: TrainStateDict, batch: dict):
        params = state["params"]
        rows = {k: v.shape[0] for k, v in batch.items()}
        for k, b in rows.items():
            if b % n:
                raise ValueError(f"batch[{k!r}] has {b} rows, not a "
                                 f"multiple of {n} microbatches")
        gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dtype,
                                              device=p.device), params)
        lsum = torch.zeros((), dtype=torch.float32,
                           device=state["step"].device)
        for i in range(n):
            mb = {k: v[i * (rows[k] // n):(i + 1) * (rows[k] // n)]
                  for k, v in batch.items()}
            loss, grads = _value_and_grad(loss_fn, params, mb)
            tree_map(lambda a, g: a.add_(g.to(acc_dtype)), gsum, grads)
            del grads
            lsum = lsum + loss
        grads = tree_map(lambda g: g / n, gsum)
        del gsum
        lr = lr_schedule(state["step"])
        new_params, new_opt = adamw_update(params, grads, state["opt"], lr)
        metrics = {"loss": lsum / n, "grad_norm": global_norm(grads),
                   "lr": lr}
        return ({"params": new_params, "opt": new_opt,
                 "step": state["step"] + 1}, metrics)

    return train_step


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
