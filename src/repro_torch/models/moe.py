"""Mixture-of-experts FFN with GShard capacity routing.

Counterpart of ``repro/models/moe.py``, with ``repro``'s routing exactly:
an f32 router; the gates cast to the activation dtype before the top k;
the k chosen gates renormalized by ``max(sum, 1e-9)``; a capacity of
``max(1, int(top_k * S * capacity_factor / E))`` slots per (batch row,
expert); slots filled in token order one k-slice at a time, the fill
carried across slices; tokens past capacity dropped. DeepSeek's shared
experts and Arctic's dense residual FFN are added to the routed output.

Two things differ in form, not in result:

* The top k is a stable descending sort: among equal gates the lower
  expert index comes first, the rule of ``jax.lax.top_k``
  (``torch.topk`` promises no order, and bf16 gates tie).
* The dispatch is by index: the kept tokens are copied into their
  ``(E, B*C, d)`` slots, the experts run as batched matmuls, and each
  token gathers its k experts' rows back, weighted by its gates and summed
  in f32 in a fixed order. ``repro`` forms the same slots with one-hot
  einsums, which multiply by zero at (B, S, E, C) scale.

On DTensors (a sharded model) each rank routes and dispatches its own
batch rows (the capacity is per row, so rows are independent), with every
MoE weight gathered whole at use, as fsdp gathers weights; the sequence and
hidden dims are made whole first. DTensor has no rule for the dispatch's
indexed write (``aten.index_put_``) on every version, and the rows' own
dispatch moves no token between ranks.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.placement_types import _StridedShard

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models.layers import (
    dense_init,
    glu_mlp,
    glu_mlp_init,
    normal,
)

__all__ = ["moe_init", "moe_apply", "route", "top_k_lower_first"]


def _expert_stack_init(gen, n: int, d: int, dff: int, dtype, device) -> dict:
    """Stacked gated-MLP experts: (E, d, ff) x2 and (E, ff, d)."""
    return {
        "wi": normal(gen, (n, d, dff), d ** -0.5, dtype, device),
        "wg": normal(gen, (n, d, dff), d ** -0.5, dtype, device),
        "wo": normal(gen, (n, dff, d), dff ** -0.5, dtype, device),
    }


def moe_init(gen, cfg: ModelConfig, dtype=torch.float32,
             device="cuda") -> dict:
    m: MoEConfig = cfg.moe
    d = cfg.d_model
    dev = resolve_device(device)
    p = {
        "router": dense_init(gen, d, m.num_experts, dtype=torch.float32,
                             device=dev),
        "experts": _expert_stack_init(gen, m.num_experts, d, m.d_ff_expert,
                                      dtype, dev),
    }
    if m.num_shared:
        p["shared"] = glu_mlp_init(gen, d, m.num_shared * m.d_ff_expert,
                                   dtype, dev)
    if m.dense_residual_ff:
        p["dense_residual"] = glu_mlp_init(gen, d, m.dense_residual_ff,
                                           dtype, dev)
    return p


def top_k_lower_first(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, the lower
    index first among equal values (``jax.lax.top_k``'s rule)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(gates: torch.Tensor, top_k: int, capacity: int):
    """Top-k capacity assignment of ``repro``'s ``_dispatch_combine``.

    gates: (B, S, E) router probabilities in the activation dtype.
    Returns (expert (B, S, k), slot (B, S, k), keep (B, S, k) bool, gate
    (B, S, k)): each token's j-th expert, its slot in that expert's queue,
    whether the slot is within capacity, and its renormalized gate.

    ``repro`` fills the queues one k-slice at a time in token order, the
    fill carried across slices: a slot is the count of earlier (j, s)
    entries, in that order, with the same expert, which one exclusive
    cumulative sum over the k*S entries gives.
    """
    b, s, e = gates.shape
    topv, topi = top_k_lower_first(gates, top_k)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    order = topi.transpose(1, 2).reshape(b, top_k * s)  # (j, s) order
    onehot = F.one_hot(order, e).transpose(1, 2).contiguous()  # (B, E, kS)
    prior = torch.cumsum(onehot, dim=2) - onehot
    slot = torch.gather(prior, 1, order[:, None, :])[:, 0]
    slot = slot.view(b, top_k, s).transpose(1, 2)
    return topi, slot, slot < capacity, topv


def _moe_on_local_rows(p: dict, cfg: ModelConfig, x: DTensor) -> DTensor:
    """:func:`moe_apply` on each rank's batch rows of a DTensor ``x``, the
    weights gathered whole (their gradient a partial sum over the mesh dims
    that split the rows)."""
    from repro_torch.optim.tree import tree_map

    mesh = x.device_mesh
    rows = tuple(q if isinstance(q, (Shard, _StridedShard)) and q.dim == 0
                 else Replicate() for q in x.placements)
    if rows != tuple(x.placements):
        x = x.redistribute(mesh, rows)
    grads = [Replicate() if isinstance(q, Replicate) else Partial()
             for q in rows]
    whole = tree_map(lambda w: w.full_tensor(grad_placements=grads)
                     if isinstance(w, DTensor) else w, p)
    out = moe_apply(whole, cfg, x.to_local())
    return DTensor.from_local(out, mesh, rows, run_check=False,
                              shape=x.shape, stride=torch.empty(
                                  x.shape, device="meta").stride())


def moe_apply(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """MoE FFN. x: (B, S, d) -> (B, S, d)."""
    if isinstance(x, DTensor):
        return _moe_on_local_rows(p, cfg, x)
    m: MoEConfig = cfg.moe
    b, s, d = x.shape
    n_exp = m.num_experts
    gates = torch.softmax(x.float() @ p["router"]["w"], dim=-1)
    capacity = max(1, int(m.top_k * s * m.capacity_factor / n_exp))
    expert, slot, keep, gate = route(gates.to(x.dtype), m.top_k, capacity)

    # Flat slot of each (token, j) in the (E, B, C) expert batch; a dropped
    # one is written to a spare row past the batch, which nothing reads
    # (no boolean indexing, so no wait on the device).
    n_slots = n_exp * b * capacity
    rows = torch.arange(b, device=x.device)[:, None, None]
    flat = (expert * b + rows) * capacity + slot
    dest = torch.where(keep, flat, torch.full_like(flat, n_slots))
    xe = x.new_zeros(n_slots + 1, d)
    src = x[:, :, None, :].expand(b, s, m.top_k, d).reshape(-1, d)
    xe[dest.reshape(-1)] = src
    xe = xe[:n_slots].view(n_exp, b * capacity, d)
    ex = p["experts"]
    he = F.silu(torch.bmm(xe, ex["wg"])) * torch.bmm(xe, ex["wi"])
    ye = torch.bmm(he, ex["wo"]).view(n_slots, d)
    # Each token's k rows (a dropped one weighted 0), summed in f32 in j
    # order: the same on every run.
    w = torch.where(keep, gate, torch.zeros_like(gate)).float()
    got = ye[torch.where(keep, flat, torch.zeros_like(flat)).reshape(-1)]
    y = (got.view(b, s, m.top_k, d).float() * w[..., None]).sum(dim=2)
    y = y.to(x.dtype)

    if m.num_shared:
        y = y + glu_mlp(p["shared"], x)
    if m.dense_residual_ff:
        y = y + glu_mlp(p["dense_residual"], x)
    return y
