"""Optimizers: AdamW and plain SGD over parameter trees.

Counterpart of ``repro/optim/optimizers.py``, with its arithmetic: the
update is computed in f32 and cast back to each parameter's dtype; the
moments are kept in ``moment_dtype`` (``"bfloat16"`` halves the
optimizer's memory for arctic-480b, ``cfg.opt_dtype``). Trees are nested
dicts, lists and NamedTuples of tensors, flattened in JAX's order
(:mod:`repro_torch.optim.tree`). Every function returns new tensors and
leaves its inputs as they were.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.optim.tree import leaves, tree_map, unflatten

__all__ = ["AdamWState", "adamw_init", "adamw_update", "sgd_update",
           "global_norm"]


class AdamWState(NamedTuple):
    m: Any  # tree like params
    v: Any
    count: torch.Tensor  # () int32


def _dtype(d) -> torch.dtype:
    return getattr(torch, d) if isinstance(d, str) else d


def adamw_init(params: Any, moment_dtype=torch.float32) -> AdamWState:
    """Zero moments in ``moment_dtype`` (a ``torch.dtype`` or its name)
    beside each leaf, and a count of 0, on the leaves' devices."""
    dtype = _dtype(moment_dtype)

    def zeros(p):
        return torch.zeros(p.shape, dtype=dtype, device=p.device)

    first = leaves(params)
    device = first[0].device if first else None
    return AdamWState(m=tree_map(zeros, params), v=tree_map(zeros, params),
                      count=torch.zeros((), dtype=torch.int32,
                                        device=device))


def adamw_update(params: Any, grads: Any, state: AdamWState, lr, *,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, grad_clip: float = 1.0):
    """One AdamW step: clip by global norm, bias-correct in f32, decay the
    leaves of two or more dims. ``lr`` is a float or a 0-d f32 tensor.
    Returns (new params, new state).

    As in ``repro``: the clip scale is an f32 tensor, so a clipped bf16
    gradient is promoted to f32; ``b1 ** count`` is an f32 power of the
    f32 count, not a Python float."""
    count = state.count + 1
    if grad_clip:
        gnorm = global_norm(grads)
        scale = torch.clamp(grad_clip / (gnorm + 1e-9), max=1.0)
        grads = tree_map(lambda g: g.float() * scale, grads)
    count32 = count.float()
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                      device=count.device), count32)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                      device=count.device), count32)

    def upd(p, g, m, v):
        g32 = g.float()
        m32 = b1 * m.float() + (1 - b1) * g32
        v32 = b2 * v.float() + (1 - b2) * torch.square(g32)
        step = (m32 / c1) / (torch.sqrt(v32 / c2) + eps)
        p32 = p.float()
        if weight_decay and p.ndim >= 2:  # no decay on norms and biases
            step = step + weight_decay * p32
        p_new = p32 - lr * step
        return p_new.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)

    out = [upd(*leaf) for leaf in zip(*(leaves(t) for t in (
        params, grads, state.m, state.v)))]
    new_p, new_m, new_v = ([o[i] for o in out] for i in range(3))
    return unflatten(params, new_p), AdamWState(
        m=unflatten(state.m, new_m), v=unflatten(state.v, new_v),
        count=count)


def sgd_update(params: Any, grads: Any, lr) -> Any:
    """``p - lr * g`` in each leaf's dtype."""
    return tree_map(lambda p, g: (p - lr * g.to(p.dtype)).to(p.dtype),
                    params, grads)


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares, the leaves added
    in JAX's order."""
    total = 0
    for leaf in leaves(tree):
        total = total + torch.sum(torch.square(leaf.float()))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))
