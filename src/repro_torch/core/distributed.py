"""Distributed (diffusion) RFF-KLMS: the paper's §1 motivation, ref [21].

Counterpart of ``repro/core/distributed.py``. With RFF each node's
solution is a fixed ``theta in R^D``, so diffusion's combine step is one
fixed-size collective where classic diffusion KLMS ships growing
dictionaries. Adapt-then-Combine (ATC) over a 1-D ``DeviceMesh`` dim,
every rank one node:

    adapt:    theta_k' = theta_k + mu e_k z(x_k)     (local LMS ticks)
    combine:  theta_k  = mean_j theta_j'             (uniform weights)

The ticks between two combines run as one call of the KLMS chunk kernel
at B = 1 (``ops.rff_klms_bank_chunk``, kernel 1; a chunk equals its
steps bit for bit). ``repro``'s ``pmean`` becomes one
``dist.all_reduce(SUM)`` on the dim's group divided by the world size
(gloo has no AVG). ``compress=True`` averages the int8 error-feedback
message instead (the gradient-compression trick for DCN-bound
deployments).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import Shard

from repro_torch import resolve_device
from repro_torch.core.klms import LMSState
from repro_torch.core.krls import _place, mesh_axis
from repro_torch.features.base import FeatureLike, as_trig
from repro_torch.kernels import ops

__all__ = [
    "DiffusionState",
    "diffusion_klms_run",
    "quantize_int8",
    "dequantize_int8",
]


class DiffusionState(NamedTuple):
    lms: LMSState  # per-node filter state
    comp_err: torch.Tensor  # (D,) error-feedback residual for compression


def quantize_int8(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization; returns (q, scale). Rounds
    half to even, as ``jnp.round`` does."""
    scale = torch.clamp(torch.max(torch.abs(v)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(v / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _combine(theta, comp_err, compress: bool, group, nodes: int):
    """The mean of every node's theta (or of its int8 message, keeping the
    local quantization error), through one all_reduce."""
    if not compress:
        dist.all_reduce(theta, group=group)
        return theta / nodes, comp_err
    msg = theta + comp_err
    q, scale = quantize_int8(msg)
    deq = dequantize_int8(q, scale)
    new_err = msg - deq
    dist.all_reduce(deq, group=group)
    return deq / nodes, new_err


def diffusion_klms_run(mesh, axis: str, rff: FeatureLike, xs, ys,
                       mu: float, combine_every: int = 1,
                       compress: bool = False):
    """Run ATC diffusion RFF-KLMS over mesh dim ``axis``.

    Args:
      xs: ``(nodes, n, d)`` per-node streams, ``ys``: ``(nodes, n)``, the
        same on every rank. ``nodes`` must equal the dim's size: rank r
        runs node r (``repro`` silently drops the nodes past the mesh; the
        port raises).
      combine_every: combine after every k-th tick (``10**9``: never).

    Returns:
      (theta per node ``(nodes, D)``, prior errors ``(nodes, n)``), both
      ``Shard(0)`` DTensors.
    """
    group, size, rank = mesh_axis(mesh, axis)
    if xs.shape[0] != size:
        raise ValueError(
            f"{xs.shape[0]} nodes on a {axis!r} axis of {size}: diffusion "
            "runs one node a rank")
    dev = resolve_device(mesh.device_type)
    tf = as_trig(rff).to(dev)
    x_l = xs[rank].to(dev).contiguous()
    y_l = ys[rank].to(dev).contiguous()
    n, dfeat = x_l.shape[0], tf.num_features
    theta = torch.zeros((1, dfeat), dtype=x_l.dtype, device=dev)
    comp_err = torch.zeros(dfeat, dtype=x_l.dtype, device=dev)
    errs = []
    for start in range(0, n, combine_every):
        stop = min(start + combine_every, n)
        theta, _, err = ops.rff_klms_bank_chunk(
            theta, x_l[None, start:stop], y_l[None, start:stop], tf.omega,
            tf.bias, mu, s=tf.scale)
        errs.append(err[0])
        if stop % combine_every == 0:
            theta, comp_err = _combine(theta, comp_err, compress, group,
                                       size)
    err = torch.cat(errs) if errs else y_l.new_zeros((0,))
    return (_place(theta, mesh, (Shard(0),), (size, dfeat)),
            _place(err[None], mesh, (Shard(0),), (size, n)))
