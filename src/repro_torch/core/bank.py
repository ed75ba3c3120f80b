"""Filter-bank engine, KLMS and KRLS tiers: B independent RFF filters
sharing one feature map, stepped as one program.

Counterpart of the fused KLMS and KRLS tiers of ``repro/core/bank.py``.
The bank axis that ``repro`` gets from ``jax.vmap`` is written out: theta
is ``(B, D)`` (and P ``(B, D, D)``) and every tick goes through the fused
kernels of ``kernels/ops.py`` (the CUDA kernels on the card, the plain
versions on the CPU). State is never updated in place: each tick returns a
fresh theta and P, so a published snapshot that still holds the old ones
never changes under its readers.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.core.klms import LMSState, StepOut
from repro_torch.core.krls import RLSState
from repro_torch.features.base import FeatureLike, as_trig, feature_dtype
from repro_torch.kernels import ops, ref

__all__ = [
    "bank_predict_block",
    "klms_bank_init",
    "klms_bank_step",
    "klms_bank_chunk_step",
    "klms_bank_run",
    "krls_bank_init",
    "krls_bank_step",
    "krls_bank_chunk_step",
    "krls_bank_run",
    "tenant_row",
    "set_tenant_row",
]


def bank_predict_block(state, xq: torch.Tensor, rff: FeatureLike,
                       mode: str = "auto", precision=None) -> torch.Tensor:
    """Fused read path: a ``(B, Q, d)`` query block per tenant ->
    ``(B, Q)`` against read-only ``state.theta``. ``precision="bf16"``
    follows the contract in ``kernels/ref.py``."""
    tf = as_trig(rff)
    return ops.rff_bank_predict(
        state.theta, xq, tf.omega, tf.bias, tf.scale, mode=mode,
        precision=ref.canon_precision(precision),
    )


def klms_bank_init(rff: FeatureLike, size: int, dtype=None) -> LMSState:
    """Zero bank state ``theta (B, D)``, ``step (B,)`` on the map's device."""
    device = rff.omega.device
    return LMSState(
        theta=torch.zeros(size, rff.num_features,
                          dtype=dtype or feature_dtype(rff), device=device),
        step=torch.zeros(size, dtype=torch.int32, device=device),
    )


def klms_bank_step(state: LMSState, xs, ys, rff: FeatureLike, mu,
                   mode: str = "auto"):
    """One fused tick for the whole bank: ``xs (B, d)``, ``ys (B,)``."""
    tf = as_trig(rff)
    theta, pred, err = ops.rff_klms_bank_step(
        state.theta, xs, ys, tf.omega, tf.bias, mu, tf.scale, mode=mode
    )
    return (
        LMSState(theta=theta, step=state.step + 1),
        StepOut(prediction=pred, error=err),
    )


def klms_bank_chunk_step(state: LMSState, xs, ys, rff: FeatureLike, mu,
                         mask=None, mode: str = "auto", chunk=None):
    """T ticks for the whole bank: ``xs (B, T, d)``, ``ys (B, T)``,
    optional ``mask (B, T)`` validity gate (the serve queue's ragged
    chunks). Masked ticks don't advance ``step``."""
    tf = as_trig(rff)
    theta, pred, err = ops.rff_klms_bank_chunk(
        state.theta, xs, ys, tf.omega, tf.bias, mu, mask, tf.scale,
        mode=mode, chunk=chunk,
    )
    return (
        LMSState(theta=theta, step=_masked_ticks(state, ys, mask)),
        StepOut(prediction=pred, error=err),
    )


def klms_bank_run(rff: FeatureLike, xs, ys, mu,
                  state: Optional[LMSState] = None, mode: str = "auto",
                  chunk: Optional[int] = None):
    """Serve B KLMS streams ``xs (B, n, d)``, ``ys (B, n)``.

    Without ``chunk`` every tick is one step launch; ``chunk=T`` runs
    ceil(n/T) chunk launches with a zero-masked remainder. The two
    schedules agree bit for bit (the kernels share one tick).
    """
    if state is None:
        state = klms_bank_init(rff, xs.shape[0])
    tf = as_trig(rff)
    if chunk is not None:
        return klms_bank_chunk_step(state, xs, ys, tf, mu, mode=mode,
                                    chunk=chunk)
    return _per_tick(
        lambda s, x, y: klms_bank_step(s, x, y, tf, mu, mode=mode),
        state, xs, ys,
    )


def _masked_ticks(state, ys, mask):
    """``state.step`` advanced by the live ticks of a ``(B, T)`` chunk."""
    if mask is None:
        return state.step + ys.shape[1]
    return state.step + mask.sum(dim=1).to(state.step.dtype)


def krls_bank_init(rff: FeatureLike, size: int,
                   lam: Union[float, torch.Tensor] = 1e-4,
                   dtype=None) -> RLSState:
    """Bank state theta ``(B, D)`` = 0, P ``(B, D, D)`` = I / lam, step
    ``(B,)`` on the map's device. ``lam`` is a scalar or ``(B,)``
    (per-tenant regularizers)."""
    device = rff.omega.device
    dt = dtype or feature_dtype(rff)
    dfeat = rff.num_features
    lam_b = torch.as_tensor(lam, dtype=dt, device=device).expand(size)
    eye = torch.eye(dfeat, dtype=dt, device=device)
    return RLSState(
        theta=torch.zeros(size, dfeat, dtype=dt, device=device),
        pmat=eye.expand(size, dfeat, dfeat) / lam_b[:, None, None],
        step=torch.zeros(size, dtype=torch.int32, device=device),
    )


def krls_bank_step(state: RLSState, xs, ys, rff: FeatureLike,
                   beta: Union[float, torch.Tensor] = 0.9995,
                   mode: str = "auto"):
    """One fused EW-RLS tick for the whole bank: ``xs (B, d)``, ``ys (B,)``,
    ``beta`` scalar or ``(B,)``."""
    tf = as_trig(rff)
    theta, pmat, pred, err = ops.rff_krls_bank_step(
        state.theta, state.pmat, xs, ys, tf.omega, tf.bias, beta, tf.scale,
        mode=mode,
    )
    return (
        RLSState(theta=theta, pmat=pmat, step=state.step + 1),
        StepOut(prediction=pred, error=err),
    )


def krls_bank_chunk_step(state: RLSState, xs, ys, rff: FeatureLike,
                         beta: Union[float, torch.Tensor] = 0.9995,
                         mask=None, mode: str = "auto", chunk=None):
    """T EW-RLS ticks for the whole bank: ``xs (B, T, d)``, ``ys (B, T)``,
    optional ``mask (B, T)`` validity gate. Masked ticks don't advance
    ``step`` and leave theta and P untouched."""
    tf = as_trig(rff)
    theta, pmat, pred, err = ops.rff_krls_bank_chunk(
        state.theta, state.pmat, xs, ys, tf.omega, tf.bias, beta, mask,
        tf.scale, mode=mode, chunk=chunk,
    )
    return (
        RLSState(theta=theta, pmat=pmat, step=_masked_ticks(state, ys, mask)),
        StepOut(prediction=pred, error=err),
    )


def krls_bank_run(rff: FeatureLike, xs, ys,
                  lam: Union[float, torch.Tensor] = 1e-4,
                  beta: Union[float, torch.Tensor] = 0.9995,
                  state: Optional[RLSState] = None, mode: str = "auto",
                  chunk: Optional[int] = None):
    """Serve B KRLS streams ``xs (B, n, d)``, ``ys (B, n)``; ``lam`` and
    ``beta`` are scalars or ``(B,)``.

    Without ``chunk`` every tick is one step launch; ``chunk=T`` runs
    ceil(n/T) chunk launches with a zero-masked remainder. The two
    schedules agree bit for bit (the kernels share one tick).
    """
    if state is None:
        state = krls_bank_init(rff, xs.shape[0], lam)
    tf = as_trig(rff)
    if chunk is not None:
        return krls_bank_chunk_step(state, xs, ys, tf, beta, mode=mode,
                                    chunk=chunk)
    return _per_tick(
        lambda s, x, y: krls_bank_step(s, x, y, tf, beta, mode=mode),
        state, xs, ys,
    )


def _per_tick(tick, state, xs, ys):
    """``tick(state, xs[:, t], ys[:, t])`` for every t; StepOut ``(B, n)``."""
    preds, errs = [], []
    for t in range(xs.shape[1]):
        state, out = tick(state, xs[:, t].contiguous(), ys[:, t].contiguous())
        preds.append(out.prediction)
        errs.append(out.error)
    return state, StepOut(prediction=torch.stack(preds, 1),
                          error=torch.stack(errs, 1))


def tenant_row(state, tenant: int):
    """One tenant's view of a bank state (``LMSState`` or ``RLSState``)."""
    return type(state)(*(a[tenant] for a in state))


def set_tenant_row(state, tenant: int, row):
    """A copy of ``state`` (``LMSState`` or ``RLSState``) with slot
    ``tenant`` replaced by ``row`` (out of place, like ``repro``'s
    ``.at[].set``: a published snapshot holding ``state`` stays as it
    was)."""
    out = []
    for a, r in zip(state, row):
        a = a.clone()
        a[tenant] = torch.as_tensor(r, dtype=a.dtype, device=a.device)
        out.append(a)
    return type(state)(*out)
