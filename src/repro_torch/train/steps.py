"""Step functions: train (gradient accumulation over microbatches and
AdamW), prefill and decode.

Counterpart of ``repro/train/steps.py``. ``repro`` jits these; the port
runs them eagerly. The model functions take ``kernel_mode`` ("auto",
"cuda" or "ref"): under autograd the attention kernels (10 and 11) run
their CUDA forward and their plain version's gradient
(``kernels/ops.py``).

The state's leaves may be ``DTensor``s placed by ``launch.sharding``
(``param_specs``, ``moment_specs``); the steps then run under DTensor's
``implicit_replication`` (``transformer.dtensor_scope``) and the train step
applies ``repro``'s sharding constraints: ``batch_axes`` shards each
microbatch's batch dim, ``grad_specs`` pins the gradient accumulator's
placements. With plain tensors both are no-ops.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Optional

import torch
from torch.distributed.tensor import (
    DTensor,
    Replicate,
    Shard,
    distribute_tensor,
)
from torch.distributed.tensor import zeros as dtensor_zeros

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
    callers likewise drop it.

    ``batch_axes`` and ``grad_specs`` are ``repro``'s sharding constraints,
    applied when the params are DTensors: each microbatch is placed
    ``Shard(0)`` on the mesh dims of ``batch_axes`` (``Replicate()`` on the
    others), and each gradient is redistributed to its leaf of
    ``grad_specs`` (placements, or ``launch.sharding.NamedSharding``s, as
    ``param_specs`` and ``param_shardings`` return) before it is added into
    the accumulator, which holds those placements. The new params and
    moments keep the placements of the old. With plain tensors both are
    no-ops: the step is bit for bit the step without them.
    """
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
        mesh = _mesh_of(params)
        rows = {k: v.shape[0] for k, v in batch.items()}
        for k, b in rows.items():
            if b % n:
                raise ValueError(f"batch[{k!r}] has {b} rows, not a "
                                 f"multiple of {n} microbatches")
        gsum = tree_map(lambda p, s: _zeros_placed(p, s, acc_dtype), params,
                        _spec_tree(grad_specs, params))
        with transformer.dtensor_scope(params):
            lsum = torch.zeros((), dtype=torch.float32,
                               device=state["step"].device)
            for i in range(n):
                mb = {k: _place_batch(v[i * (rows[k] // n):
                                        (i + 1) * (rows[k] // n)],
                                      mesh, batch_axes)
                      for k, v in batch.items()}
                loss, grads = _value_and_grad(loss_fn, params, mb)
                tree_map(lambda a, g: a.add_(_like(g, a).to(acc_dtype)),
                         gsum, grads)
                del grads
                lsum = lsum + loss
            grads = tree_map(lambda g: g / n, gsum)
            del gsum
            lr = lr_schedule(state["step"])
            new_params, new_opt = adamw_update(params, grads, state["opt"],
                                               lr)
            if mesh is not None:  # keep the state's layout
                new_params = tree_map(_like, new_params, params)
                new_opt = new_opt._replace(
                    m=tree_map(_like, new_opt.m, state["opt"].m),
                    v=tree_map(_like, new_opt.v, state["opt"].v))
            metrics = {"loss": lsum / n, "grad_norm": global_norm(grads),
                       "lr": lr}
        return ({"params": new_params, "opt": new_opt,
                 "step": state["step"] + 1}, metrics)

    return train_step


def _mesh_of(tree):
    """The mesh of the first DTensor leaf of ``tree``, else None."""
    for leaf in leaves(tree):
        if isinstance(leaf, DTensor):
            return leaf.device_mesh
    return None


def _spec_tree(specs, params):
    """``specs`` (a tree of placements or ``NamedSharding``s, as
    ``param_specs``/``param_shardings`` return), or the params' own
    placements when None."""
    if specs is None:
        return tree_map(lambda p: getattr(p, "placements", None), params)
    return specs


def _zeros_placed(p, spec, dtype):
    """A zero accumulator of ``p``'s global shape in ``dtype``, with the
    placements of ``spec`` on ``p``'s mesh (a plain ``p`` gives a plain
    tensor)."""
    if not isinstance(p, DTensor):
        return torch.zeros(p.shape, dtype=dtype, device=p.device)
    places = getattr(spec, "placements", spec) or p.placements
    return dtensor_zeros(p.shape, dtype=dtype, device_mesh=p.device_mesh,
                         placements=tuple(places))


def _like(t, ref):
    """``t`` redistributed to ``ref``'s placements where both are
    DTensors and they differ; otherwise ``t``."""
    if (isinstance(t, DTensor) and isinstance(ref, DTensor)
            and tuple(t.placements) != tuple(ref.placements)):
        return t.redistribute(ref.device_mesh, ref.placements)
    return t


def _place_batch(x, mesh, batch_axes):
    """A microbatch with its batch dim ``Shard(0)`` on the mesh dims of
    ``batch_axes`` and ``Replicate()`` on the others. A plain microbatch is
    taken as the same global tensor on every rank (cut locally, no
    collective). No mesh or no ``batch_axes``: ``x`` as it is."""
    if mesh is None or not batch_axes:
        return x
    names = mesh.mesh_dim_names
    missing = [a for a in batch_axes if a not in names]
    if missing:
        raise ValueError(f"batch_axes {batch_axes}: {missing} not on the "
                         f"mesh {names}")
    want = tuple(Shard(0) if a in batch_axes else Replicate() for a in names)
    if isinstance(x, DTensor):
        return x if tuple(x.placements) == want else x.redistribute(mesh,
                                                                    want)
    return distribute_tensor(x, mesh, want, src_data_rank=None)


def make_prefill_step(cfg: ModelConfig, *,
                      kernel_mode: str = "auto") -> Callable:
    """``prefill(params, batch) -> last-position logits (B, V)``.

    ``batch``: ``{"tokens": (B, S)}``, or ``{"embeds": (B, S, d)}`` for the
    frontend archs. The whole sequence goes through the layer stack at once
    (the chunked RFF or the flash attention kernel where the arch has
    them); the head runs on the last position only."""
    def prefill_step(params, batch: dict):
        with transformer.dtensor_scope(params, batch):
            x = transformer.embed_inputs(params, cfg, batch.get("tokens"),
                                         batch.get("embeds"))
            h = transformer.apply_stack(params, cfg, x,
                                        kernel_mode=kernel_mode)
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
