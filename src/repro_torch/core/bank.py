"""Filter-bank engine: B independent online learners stepped as one
program.

Counterpart of ``repro/core/bank.py``'s generic tier (``bank_init``,
``bank_step``, ``bank_run``, ``bank_predict``: any ``OnlineLearner``), its
fused KLMS and KRLS tiers (B RFF filters sharing one feature map) and the
slot lifecycle (``evict_tenant``, ``rebuild_tenant``). The bank axis that
``repro`` gets from ``jax.vmap`` is written out: every state leaf carries
a leading ``(B,)`` axis, the generic tier calls the learner's step on the
whole bank (``core/learner.py``'s steps take leading batch dims), and
every fused tick goes through the kernels of ``kernels/ops.py`` (the CUDA
kernels on the card, the plain versions on the CPU). State is never
updated in place: each tick returns fresh tensors, so a published snapshot
that still holds the old ones never changes under its readers.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.core.klms import LMSState, StepOut
from repro_torch.core.krls import RLSState, rff_krls_init
from repro_torch.core.learner import OnlineLearner
from repro_torch.core.scan import replay_klms, replay_krls
from repro_torch.features.base import FeatureLike, as_trig, feature_dtype
from repro_torch.kernels import ops, ref

__all__ = [
    "bank_init",
    "bank_step",
    "bank_run",
    "bank_predict",
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
    "evict_tenant",
    "bank_size",
    "rebuild_tenant",
]


def bank_init(learner: OnlineLearner, size: int, key=None):
    """``size`` fresh learners: each leaf of ``learner.init()`` stacked on
    a leading bank axis (``key`` is accepted for ``repro``'s signature)."""
    del key
    row = learner.init()
    return type(row)(*(a.expand(size, *a.shape).clone() for a in row))


def bank_step(learner: OnlineLearner, states, xs: torch.Tensor,
              ys: torch.Tensor):
    """One lockstep tick: ``xs (B, d)``, ``ys (B,)`` -> (state, StepOut
    ``(B,)``)."""
    return learner.step_fn(states, xs, ys)


def bank_run(learner: OnlineLearner, states, xs: torch.Tensor,
             ys: torch.Tensor):
    """Drive B lockstep streams ``xs (B, n, d)``, ``ys (B, n)``: a loop
    over time of the bank's step. Returns the final state and ``StepOut``
    tensors ``(B, n)``."""
    return learner.run(states, xs, ys)


def bank_predict(learner: OnlineLearner, states,
                 xs: torch.Tensor) -> torch.Tensor:
    """Batched inference: one ``x (d,)`` per learner, ``xs (B, d)``."""
    return learner.predict_fn(states, xs)


def per_query(state):
    """A bank state with a query axis after the bank axis, so a learner's
    ``predict_fn`` answers a ``(B, Q, d)`` block with ``(B, Q)``."""
    return type(state)(*(a.unsqueeze(1) for a in state))


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
    device = as_trig(rff).omega.device
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
    device = as_trig(rff).omega.device
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


def _hp_row(v, tenant: int):
    """A scalar hyperparameter, or one tenant's entry of a per-tenant
    ``(B,)`` tensor. Python scalars pass through unwrapped, so a replay
    runs the same arithmetic as the training path."""
    if isinstance(v, (int, float)):
        return v
    t = torch.as_tensor(v)
    return t[tenant] if t.ndim else t


def _fresh_row(state, lam: Union[float, torch.Tensor] = 1e-4,
               tenant: int = 0):
    """A fresh single-learner row shaped like one slot of ``state``: zero
    theta (and step), and for an RLS bank ``P_0 = I / lam`` with the
    tenant's own ``lam`` when it is a ``(B,)`` tensor."""
    if isinstance(state, RLSState):
        fresh = rff_krls_init(state.pmat.shape[-1], _hp_row(lam, tenant),
                              state.pmat.dtype, device=state.pmat.device)
        return RLSState(theta=fresh.theta.to(state.theta.dtype),
                        pmat=fresh.pmat, step=fresh.step)
    return type(state)(*(torch.zeros_like(a) for a in tenant_row(state, tenant)))


def evict_tenant(state, tenant: int, init_row=None,
                 lam: Union[float, torch.Tensor] = 1e-4):
    """Release bank slot ``tenant``: one row write (out of place), nothing
    else moves. ``init_row`` is the row to park there, a fresh
    single-learner row by default (zero theta; ``P_0 = I / lam`` for an RLS
    bank, per tenant when ``lam`` is ``(B,)``)."""
    if init_row is None:
        init_row = _fresh_row(state, lam, tenant)
    return set_tenant_row(state, tenant, init_row)


def bank_size(state) -> int:
    """Number of slots B (the leading axis of every state tensor)."""
    return int(state[0].shape[0])


def rebuild_tenant(state, tenant: int, rff: FeatureLike, xs, ys, *,
                   mu: Union[float, torch.Tensor] = 0.5,
                   lam: Union[float, torch.Tensor] = 1e-4,
                   beta: Union[float, torch.Tensor] = 0.9995,
                   mode: str = "scan", chunk: Optional[int] = None,
                   normalized: bool = False, eps: float = 1e-6,
                   kernel_mode: str = "auto"):
    """Reconstruct slot ``tenant`` from its replay log ``xs (T, d)``, ``ys
    (T,)`` (tensors or host arrays) and write it into a copy of the bank.

    The family follows the state (``RLSState`` = KRLS, else KLMS;
    ``normalized=True`` with ``eps`` for NKLMS); hyperparameters are
    scalars or per-tenant ``(B,)`` (the tenant's entry is used). The
    replay starts from a fresh row. ``mode`` / ``chunk`` pick the schedule
    of ``core/scan.py`` (``"sequential"`` is bit for bit the training
    path); ``kernel_mode`` is the ops dispatch. Returns the new bank state.
    """
    like = state[0]
    xs = torch.as_tensor(xs, dtype=like.dtype, device=like.device)
    ys = torch.as_tensor(ys, dtype=like.dtype, device=like.device)
    if isinstance(state, RLSState):
        row = replay_krls(rff, xs, ys, lam=_hp_row(lam, tenant),
                          beta=_hp_row(beta, tenant), mode=mode, chunk=chunk,
                          kernel_mode=kernel_mode)
    else:
        row = replay_klms(rff, xs, ys, _hp_row(mu, tenant), mode=mode,
                          chunk=chunk, normalized=normalized, eps=eps,
                          kernel_mode=kernel_mode)
    return set_tenant_row(state, tenant, row)
