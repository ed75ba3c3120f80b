"""Filter-bank engine: B independent online learners stepped as one
program.

Counterpart of ``repro/core/bank.py``: the generic tier (``bank_init``,
``bank_step``, ``bank_run``, ``bank_predict``: any ``OnlineLearner``) with
its hyperparameter sweeps (``hp_bank_*`` over :class:`BankHParams`), the
fused KLMS and KRLS tiers (B filters sharing one feature map), the
mixed-family tier (a feature map per tenant) and the slot lifecycle
(``evict_tenant``, ``rebuild_tenant``, ``resize_bank``,
``resymmetrize_tenant``). The bank axis that ``repro`` gets from
``jax.vmap`` is written out: every state leaf carries a leading ``(B,)``
axis, and a step takes leading batch dims (``core/learner.py``'s steps,
the ``hp_bank_*`` step functions).

The fused tiers route on the map's type, as ``repro``'s do: a trig map
(``as_trig_or_none`` not None: rff, orf, qmc, gq) goes through the kernels
of ``kernels/ops.py`` (the CUDA kernels on the card, the plain versions on
the CPU); a map without the trig form (taylor) goes through the generic
route, ``featurize`` then the same tick arithmetic (``ref.klms_tick_math``,
``ref.krls_tick_math``), plain PyTorch on any device as ``repro`` runs it
through XLA. State is never updated in place: each tick returns fresh
tensors, so a published snapshot that still holds the old ones never
changes under its readers.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Union

import torch

from repro_torch.core.klms import LMSState, StepOut, rff_klms_init
from repro_torch.core.krls import RLSState, rff_krls_init
from repro_torch.core.learner import OnlineLearner
from repro_torch.core.scan import replay_klms, replay_krls
from repro_torch.features.base import (
    FeatureLike,
    TrigFeatures,
    as_trig,
    as_trig_or_none,
    feature_device,
    feature_dtype,
    featurize,
)
from repro_torch.kernels import ops, ref
from repro_torch.obs import trace as _trace

__all__ = [
    "bank_init",
    "bank_step",
    "bank_run",
    "bank_predict",
    "bank_predict_block",
    "BankHParams",
    "bank_hparams",
    "hp_bank_init",
    "hp_bank_step",
    "hp_bank_run",
    "klms_bank_init",
    "klms_bank_step",
    "klms_bank_chunk_step",
    "klms_bank_run",
    "krls_bank_init",
    "krls_bank_step",
    "krls_bank_chunk_step",
    "krls_bank_run",
    "stack_feature_maps",
    "mixed_klms_bank_run",
    "mixed_krls_bank_run",
    "tenant_row",
    "set_tenant_row",
    "evict_tenant",
    "resymmetrize_tenant",
    "rebuild_tenant",
    "bank_size",
    "resize_bank",
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
    ``(B, Q)`` against read-only ``state.theta``. A trig map takes the read
    kernel (one launch); a map without the trig form featurizes the block
    and reduces in f32. ``precision="bf16"`` follows the contract in
    ``kernels/ref.py``."""
    with _trace.span("lockstep.read", B=xq.shape[0], Q=xq.shape[1]):
        precision = ref.canon_precision(precision)
        tf = as_trig_or_none(rff)
        if tf is None:
            z = featurize(rff, xq)  # (B, Q, D)
            if precision == "bf16":
                z = z.to(torch.bfloat16)
            theta = state.theta
            pred = torch.sum(theta[:, None, :].float() * z.float(), dim=-1)
            return pred.to(theta.dtype)
        return ops.rff_bank_predict(
            state.theta, xq, tf.omega, tf.bias, tf.scale, mode=mode,
            precision=precision,
        )


# ---------------------------------------------------------------------------
# Hyperparameter sweeps: one bank, a (mu, beta, lam) row per tenant.
# ---------------------------------------------------------------------------


class BankHParams(NamedTuple):
    """Per-tenant hyperparameters, a leading bank axis on each leaf: KLMS
    reads ``mu``, EW-RLS ``beta`` (forgetting) and ``lam`` (the init
    regularizer); a family ignores the fields it does not use."""

    mu: torch.Tensor  # (B,)
    beta: torch.Tensor  # (B,)
    lam: torch.Tensor  # (B,)


def bank_hparams(size: int, mu=0.5, beta=0.9995, lam=1e-4,
                 dtype=torch.float32, device=None) -> BankHParams:
    """Broadcast scalars or ``(B,)`` values into a full ``BankHParams``
    (on ``device``, or on the device of a tensor among the values)."""
    if device is None:
        device = next((v.device for v in (mu, beta, lam)
                       if isinstance(v, torch.Tensor)), "cpu")

    def to_b(v):
        return torch.as_tensor(v, dtype=dtype, device=device).expand(size)

    return BankHParams(mu=to_b(mu), beta=to_b(beta), lam=to_b(lam))


def _stack_rows(rows):
    """Single-learner states stacked on a new leading bank axis."""
    return type(rows[0])(*(torch.stack(leaves) for leaves in zip(*rows)))


def hp_bank_init(init_fn: Callable, hparams: BankHParams, key=None):
    """Bank state from a per-tenant init ``init_fn(hp, key) -> state``:
    ``init_fn`` sees one ``BankHParams`` row (0-d leaves), e.g. a KRLS
    init reading ``hp.lam`` so each tenant gets its own ``P_0 = I / lam``,
    and the rows are stacked (``key`` is passed through; the port draws no
    key)."""
    rows = [init_fn(BankHParams(*(leaf[i] for leaf in hparams)), key)
            for i in range(hparams.mu.shape[0])]
    return _stack_rows(rows)


def hp_bank_step(step_fn: Callable, states, hparams: BankHParams,
                 xs: torch.Tensor, ys: torch.Tensor):
    """One lockstep tick ``step_fn(states, hparams, xs (B, d), ys (B,))``.
    The step takes the whole bank at once (leading batch dims on the
    state, the ``(B,)`` hyperparameters, x and y), where ``repro`` vmaps a
    single-tenant step."""
    return step_fn(states, hparams, xs, ys)


def hp_bank_run(step_fn: Callable, states, hparams: BankHParams,
                xs: torch.Tensor, ys: torch.Tensor):
    """Drive B hyperparameter candidates ``xs (B, n, d)``, ``ys (B, n)``:
    a loop over time of :func:`hp_bank_step`. Returns the final state and
    ``StepOut`` tensors ``(B, n)``."""
    return _per_tick(
        lambda s, x, y: hp_bank_step(step_fn, s, hparams, x, y),
        states, xs, ys,
    )


# ---------------------------------------------------------------------------
# Fused KLMS and KRLS banks: one shared feature map. A trig map runs the
# kernels; a map without the trig form (taylor) runs the generic route,
# featurize then the same tick arithmetic.
# ---------------------------------------------------------------------------


def _generic_klms_tick(fm, theta, xs, ys, mu):
    """One KLMS bank tick over ``featurize`` (``ref.klms_tick_math``)."""
    z = featurize(fm, xs)  # (B, D)
    return ref.klms_tick_math(theta, z, ys, ref.mu_column(mu, theta,
                                                          ys.shape[0]))


def _generic_klms_chunk(fm, theta, xs, ys, mu, mask):
    """T masked KLMS ticks over ``featurize`` (mirrors
    ``ref.rff_klms_bank_chunk_ref``): a masked tick emits its prior
    prediction and error and leaves theta untouched."""
    gate = (torch.ones_like(ys) if mask is None else mask).to(theta.dtype)
    mu_b = ref.mu_column(mu, theta, ys.shape[0])
    preds, errs = [], []
    for t in range(ys.shape[1]):
        z = featurize(fm, xs[:, t])
        theta, pred, err = ref.klms_tick_math(theta, z, ys[:, t], mu_b,
                                              gate=gate[:, t])
        preds.append(pred)
        errs.append(err)
    return (theta, *_stacked(preds, errs, ys))


def _generic_krls_tick(fm, theta, pmat, xs, ys, beta):
    """One EW-RLS bank tick over ``featurize`` (``ref.krls_tick_math``)."""
    z = featurize(fm, xs)
    return ref.krls_tick_math(theta, pmat, z, ys,
                              ref.beta_column(beta, theta, ys.shape[0]))


def _generic_krls_chunk(fm, theta, pmat, xs, ys, beta, mask):
    """T masked EW-RLS ticks over ``featurize`` (mirrors
    ``ref.rff_krls_bank_chunk_ref``): a masked tick keeps theta and P."""
    live = (torch.ones_like(ys) if mask is None else mask).to(theta.dtype) > 0
    preds, errs = [], []
    for t in range(ys.shape[1]):
        th2, pm2, pred, err = _generic_krls_tick(fm, theta, pmat, xs[:, t],
                                                 ys[:, t], beta)
        keep = live[:, t]
        theta = torch.where(keep[:, None], th2, theta)
        pmat = torch.where(keep[:, None, None], pm2, pmat)
        preds.append(pred)
        errs.append(err)
    return (theta, pmat, *_stacked(preds, errs, ys))


def _stacked(preds, errs, ys):
    """Per-tick outputs as ``(B, T)`` (``(B, 0)`` for no tick)."""
    if not preds:
        empty = ys.new_zeros((ys.shape[0], 0))
        return empty, empty
    return torch.stack(preds, 1), torch.stack(errs, 1)


def klms_bank_init(rff: FeatureLike, size: int, dtype=None) -> LMSState:
    """Zero bank state ``theta (B, D)``, ``step (B,)`` on the map's device."""
    device = feature_device(rff)
    return LMSState(
        theta=torch.zeros(size, rff.num_features,
                          dtype=dtype or feature_dtype(rff), device=device),
        step=torch.zeros(size, dtype=torch.int32, device=device),
    )


def klms_bank_step(state: LMSState, xs, ys, rff: FeatureLike, mu,
                   mode: str = "auto"):
    """One fused tick for the whole bank: ``xs (B, d)``, ``ys (B,)``."""
    tf = as_trig_or_none(rff)
    if tf is None:
        theta, pred, err = _generic_klms_tick(rff, state.theta, xs, ys, mu)
    else:
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
    tf = as_trig_or_none(rff)
    if tf is None:
        theta, pred, err = _generic_klms_chunk(rff, state.theta, xs, ys, mu,
                                               mask)
    else:
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
    tf = as_trig_or_none(rff)
    fm = rff if tf is None else tf
    if chunk is not None:
        return klms_bank_chunk_step(state, xs, ys, fm, mu, mode=mode,
                                    chunk=chunk)
    return _per_tick(
        lambda s, x, y: klms_bank_step(s, x, y, fm, mu, mode=mode),
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
    device = feature_device(rff)
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
    tf = as_trig_or_none(rff)
    if tf is None:
        theta, pmat, pred, err = _generic_krls_tick(
            rff, state.theta, state.pmat, xs, ys, beta)
    else:
        theta, pmat, pred, err = ops.rff_krls_bank_step(
            state.theta, state.pmat, xs, ys, tf.omega, tf.bias, beta,
            tf.scale, mode=mode,
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
    tf = as_trig_or_none(rff)
    if tf is None:
        theta, pmat, pred, err = _generic_krls_chunk(
            rff, state.theta, state.pmat, xs, ys, beta, mask)
    else:
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
    schedules agree bit for bit on the plain path and on the resident
    route (the kernels share one tick); on the compact route (D past the
    resident triangle) within f32 rounding, its blocks reassociating the
    recursion.
    """
    if state is None:
        state = krls_bank_init(rff, xs.shape[0], lam)
    tf = as_trig_or_none(rff)
    fm = rff if tf is None else tf
    if chunk is not None:
        return krls_bank_chunk_step(state, xs, ys, fm, beta, mode=mode,
                                    chunk=chunk)
    return _per_tick(
        lambda s, x, y: krls_bank_step(s, x, y, fm, beta, mode=mode),
        state, xs, ys,
    )


# ---------------------------------------------------------------------------
# Mixed-family bank: a feature map and hyperparameters per tenant. The
# trig forms stack into a (B, d, D) / (B, D) / (B, D) TrigFeatures and each
# tick is the single-tenant recursion on every row at once (a batched
# product; plain PyTorch, as repro runs it through XLA).
# ---------------------------------------------------------------------------


def stack_feature_maps(fms: Sequence[FeatureLike]) -> TrigFeatures:
    """Stack per-tenant trig maps into one bank-axis ``TrigFeatures``:
    omega ``(B, d, D)``, bias ``(B, D)``, scale ``(B, D)``. Every map must
    share ``input_dim`` and ``num_features``; any trig families mix."""
    tfs = [as_trig(fm) for fm in fms]
    shapes = {(tf.input_dim, tf.num_features) for tf in tfs}
    if len(shapes) != 1:
        raise ValueError(
            f"stacked feature maps must share (d, D); got {sorted(shapes)}"
        )
    return TrigFeatures(*(torch.stack(leaves) for leaves in zip(*tfs)))


def _mixed_features(tfs: TrigFeatures, x: torch.Tensor) -> torch.Tensor:
    """``z_b = s_b cos(x_b W_b + b_b)`` for every tenant: x ``(B, d)``."""
    proj = torch.bmm(x[:, None, :], tfs.omega)[:, 0] + tfs.bias
    return tfs.scale * torch.cos(proj)


def mixed_klms_bank_run(tfs: TrigFeatures, xs, ys,
                        hparams: Optional[BankHParams] = None, mu=0.5,
                        state: Optional[LMSState] = None):
    """Drive B KLMS tenants with per-tenant maps (``stack_feature_maps``)
    over ``xs (B, n, d)``, ``ys (B, n)``; ``hparams`` supplies per-tenant
    ``mu`` (or pass ``mu``). Each row is its tenant's ``rff_klms_run`` up
    to the batched product's rounding."""
    size = ys.shape[0]
    omega = tfs.omega
    if hparams is None:
        hparams = bank_hparams(size, mu=mu, dtype=omega.dtype,
                               device=omega.device)
    if state is None:
        single = rff_klms_init(omega.shape[-1], omega.dtype,
                               device=omega.device)
        state = LMSState(*(a.expand(size, *a.shape).clone() for a in single))
    mu_b = hparams.mu.to(omega.dtype)

    def tick(s, x, y):
        theta, pred, err = ref.klms_tick_math(s.theta, _mixed_features(tfs, x),
                                              y, mu_b)
        return LMSState(theta, s.step + 1), StepOut(pred, err)

    return _per_tick(tick, state, xs, ys)


def mixed_krls_bank_run(tfs: TrigFeatures, xs, ys,
                        hparams: Optional[BankHParams] = None, lam=1e-4,
                        beta=0.9995, state: Optional[RLSState] = None):
    """Drive B EW-RLS tenants with per-tenant maps; per-tenant ``beta`` and
    init ``lam`` from ``hparams`` (or the ``lam`` / ``beta`` arguments).
    Each row is its tenant's ``rff_krls_run`` up to the batched products'
    rounding, which the P recursion amplifies (``repro`` pins 1e-3)."""
    size = ys.shape[0]
    omega = tfs.omega
    if hparams is None:
        hparams = bank_hparams(size, beta=beta, lam=lam, dtype=omega.dtype,
                               device=omega.device)
    if state is None:
        dfeat = omega.shape[-1]
        state = hp_bank_init(
            lambda hp, key: rff_krls_init(dfeat, hp.lam, omega.dtype,
                                          device=omega.device), hparams)
    beta_b = hparams.beta.to(omega.dtype)

    def tick(s, x, y):
        theta, pmat, pred, err = ref.krls_tick_math(
            s.theta, s.pmat, _mixed_features(tfs, x), y, beta_b)
        return RLSState(theta, pmat, s.step + 1), StepOut(pred, err)

    return _per_tick(tick, state, xs, ys)


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


def resize_bank(state, new_size: int, fresh_row=None,
                lam: Union[float, torch.Tensor] = 1e-4):
    """Grow or shrink the bank's leading axis to ``new_size`` slots.

    Growth appends copies of ``fresh_row`` (by default the family's fresh
    row: zero theta, ``P_0 = I / lam`` for an RLS bank); the existing rows
    are copied unchanged, bit for bit. Shrinking keeps the first
    ``new_size`` rows: the caller (the policy tier) compacts the live
    tenants below ``new_size`` first.
    """
    size = bank_size(state)
    if new_size < 1:
        raise ValueError("bank must keep at least one slot")
    if new_size == size:
        return state
    with _trace.span("bank.resize", size=size, new_size=new_size):
        if new_size < size:
            return type(state)(*(a[:new_size] for a in state))
        if fresh_row is None:
            fresh_row = _fresh_row(state, lam)

        def grow(a, r):
            r = torch.as_tensor(r, dtype=a.dtype, device=a.device)
            return torch.cat([a, r.expand(new_size - size, *a.shape[1:])])

        return type(state)(*(grow(a, r) for a, r in zip(state, fresh_row)))


def resymmetrize_tenant(state, tenant: int):
    """Project slot ``tenant``'s P back onto the symmetric matrices, ``P <-
    (P + P^T) / 2`` (out of place): the cheapest repair of the recovery
    ladder. The result is exactly symmetric. Raises ``ValueError`` for a
    state without a P leaf."""
    if not isinstance(state, RLSState):
        raise ValueError(
            "resymmetrize_tenant needs a bank state with a P leaf")
    with _trace.span("bank.resymmetrize_tenant", tenant=tenant):
        p = state.pmat[tenant]
        pmat = state.pmat.clone()
        pmat[tenant] = (p + p.T) / 2
        return state._replace(pmat=pmat)


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
    path); ``kernel_mode`` is the ops dispatch. ``rff`` is the map itself:
    one without the trig form (taylor) replays through ``featurize``.
    Returns the new bank state.
    """
    like = state[0]
    xs = torch.as_tensor(xs, dtype=like.dtype, device=like.device)
    ys = torch.as_tensor(ys, dtype=like.dtype, device=like.device)
    with _trace.span("bank.rebuild_tenant", tenant=tenant,
                     ticks=int(xs.shape[0]), mode=mode):
        if isinstance(state, RLSState):
            row = replay_krls(rff, xs, ys, lam=_hp_row(lam, tenant),
                              beta=_hp_row(beta, tenant), mode=mode,
                              chunk=chunk, kernel_mode=kernel_mode)
        else:
            row = replay_klms(rff, xs, ys, _hp_row(mu, tenant), mode=mode,
                              chunk=chunk, normalized=normalized, eps=eps,
                              kernel_mode=kernel_mode)
        return set_tenant_row(state, tenant, row)
