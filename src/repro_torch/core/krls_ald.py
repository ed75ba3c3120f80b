"""Engel's KRLS with ALD sparsification (Engel, Mannor & Meir 2004).

Counterpart of ``repro/core/krls_ald.py``, the paper's §6 baseline. A
point joins the dictionary when its Approximate Linear Dependence residual

    delta_t = k(x_t, x_t) - k_t^T a_t,   a_t = Ktilde^{-1} k_t

exceeds ``nu``; otherwise only the reduced coefficients are updated.
Fixed-capacity buffers with an occupancy count, as in ``core/qklms.py``;
the O(M^2) per-step cost of the growing method is kept.

Recursions (Engel 2004, Table 1):

  ALD (grow):   Kinv' = (1/delta) [[delta Kinv + a a^T, -a], [-a^T, 1]]
                P'    = [[P, 0], [0, 1]]
                alpha'= [alpha - (a/delta) e ; e/delta],  e = y - k^T alpha
  else (stay):  q = P a / (1 + a^T P a)
                P' = P - q (a^T P)
                alpha' = alpha + Kinv q e

Both branches are computed and then selected per row, ``delta`` is
clamped at 1e-12, and Kinv and P are symmetrized after each step, as in
``repro``. The state takes leading batch dims (a bank is the same call on
leaves with a leading ``(B,)`` axis). The grow branch's one-hot outer
products touch one row and one column of Kinv, so they are written as
indexed updates of those rows, adding the same terms in the same order as
``repro``'s outer products (the other terms are exact zeros).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import resolve_device
from repro_torch.core.klms import StepOut

__all__ = [
    "ALDKRLSState",
    "ald_krls_init",
    "ald_krls_step",
    "ald_krls_run",
    "ald_krls_predict",
]


class ALDKRLSState(NamedTuple):
    centers: torch.Tensor  # (..., cap, d)
    alpha: torch.Tensor  # (..., cap)
    kinv: torch.Tensor  # (..., cap, cap) Ktilde^{-1} on the occupied block
    pmat: torch.Tensor  # (..., cap, cap) P on the occupied block
    size: torch.Tensor  # (...) int32
    step: torch.Tensor  # (...) int32


def ald_krls_init(capacity: int, input_dim: int, dtype=torch.float32,
                  device="cuda") -> ALDKRLSState:
    """An empty dictionary of ``capacity`` slots (every buffer zero)."""
    dev = resolve_device(device)
    return ALDKRLSState(
        centers=torch.zeros(capacity, input_dim, dtype=dtype, device=dev),
        alpha=torch.zeros(capacity, dtype=dtype, device=dev),
        kinv=torch.zeros(capacity, capacity, dtype=dtype, device=dev),
        pmat=torch.zeros(capacity, capacity, dtype=dtype, device=dev),
        size=torch.zeros((), dtype=torch.int32, device=dev),
        step=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _gauss_vec(centers, x, sigma):
    sq = torch.sum(torch.square(centers - x[..., None, :]), dim=-1)
    return torch.exp(-sq / (2.0 * sigma**2))


def _masked_kvec(centers, size, x, sigma):
    cap = centers.shape[-2]
    occ = torch.arange(cap, device=size.device) < size[..., None]
    return _gauss_vec(centers, x, sigma) * occ.to(x.dtype)


def _dot(u, v):
    return torch.sum(u * v, dim=-1)


def _matvec(m, v):
    # A product and a sum over the last axis, not a batched matmul: each
    # row's bits then do not depend on how many rows the call holds, so a
    # row replayed alone equals its row of the bank.
    return torch.sum(m * v[..., None, :], dim=-1)


def ald_krls_predict(state: ALDKRLSState, x: torch.Tensor, sigma: float):
    """``f(x) = sum_k alpha_k kappa(c_k, x)`` over the occupied slots, the
    same masked dot as the step's prediction. ``x (..., d)`` broadcasts
    against the state's leading dims."""
    kvec = _masked_kvec(state.centers, state.size, x, sigma)
    return _dot(kvec, state.alpha)


def _step_rows(centers, alpha, kinv, pmat, size, x, y, sigma, nu):
    """One step for N rows: leaves ``(N, ...)``, ``x (N, d)``, ``y (N,)``."""
    cap = centers.shape[-2]
    rows = torch.arange(centers.shape[0], device=x.device)
    kvec = _masked_kvec(centers, size, x, sigma)  # (N, cap)
    y_hat = _dot(kvec, alpha)
    err = y - y_hat
    a = _matvec(kinv, kvec)  # zero outside the occupied block
    delta = torch.clamp(1.0 - _dot(kvec, a), min=1e-12)  # k(x, x) = 1
    grow = ((delta > nu) | (size == 0)) & (size < cap)
    pos = torch.clamp(size, max=cap - 1).long()

    # Grow: Kinv + a a^T/delta - e a^T/delta - a e^T/delta + e e^T/delta
    # with e the one-hot of pos; P + e e^T; alpha - (a/delta) err +
    # e (err/delta).
    ad = a / delta[:, None]
    kinv_g = a[:, :, None] * a[:, None, :]
    kinv_g = kinv_g.div_(delta[:, None, None]).add_(kinv)
    kinv_g[rows, pos] = kinv_g[rows, pos] - ad
    kinv_g[rows, :, pos] = kinv_g[rows, :, pos] - ad
    kinv_g[rows, pos, pos] = kinv_g[rows, pos, pos] + 1.0 / delta
    alpha_g = alpha - ad * err[:, None]
    alpha_g[rows, pos] = alpha_g[rows, pos] + err / delta

    # Stay.
    pa = _matvec(pmat, a)
    q = pa / (1.0 + _dot(a, pa))[:, None]
    pmat_s = pmat - q[:, :, None] * pa[:, None, :]
    alpha_s = alpha + _matvec(kinv, q) * err[:, None]

    g1, g2 = grow[:, None], grow[:, None, None]
    centers = centers.clone()
    centers[rows, pos] = torch.where(g1, x, centers[rows, pos])
    kinv = torch.where(g2, kinv_g, kinv)
    pmat = torch.where(g2, pmat, pmat_s)
    pmat[rows, pos, pos] = torch.where(grow, pmat[rows, pos, pos] + 1.0,
                                       pmat[rows, pos, pos])
    alpha = torch.where(g1, alpha_g, alpha_s)
    size = size + grow.to(torch.int32)
    # Symmetrize to slow f32 drift (the paper's Matlab runs were f64; with
    # a near-flat Gaussian kernel the bordered inverse is ill-conditioned).
    kinv = torch.add(kinv, kinv.mT).mul_(0.5)
    pmat = torch.add(pmat, pmat.mT).mul_(0.5)
    return centers, alpha, kinv, pmat, size, StepOut(y_hat, err)


def ald_krls_step(state: ALDKRLSState, sample, sigma: float, nu: float):
    """One ALD-KRLS step on ``sample = (x, y)``."""
    x, y = sample
    lead = x.shape[:-1]
    cap, d = state.centers.shape[-2:]
    centers, alpha, kinv, pmat, size, out = _step_rows(
        state.centers.reshape(-1, cap, d), state.alpha.reshape(-1, cap),
        state.kinv.reshape(-1, cap, cap), state.pmat.reshape(-1, cap, cap),
        state.size.reshape(-1), x.reshape(-1, d), y.reshape(-1), sigma, nu,
    )
    return (
        ALDKRLSState(
            centers=centers.reshape(*lead, cap, d),
            alpha=alpha.reshape(*lead, cap),
            kinv=kinv.reshape(*lead, cap, cap),
            pmat=pmat.reshape(*lead, cap, cap),
            size=size.reshape(lead),
            step=state.step + 1,
        ),
        StepOut(prediction=out.prediction.reshape(lead),
                error=out.error.reshape(lead)),
    )


def ald_krls_run(xs: torch.Tensor, ys: torch.Tensor, sigma: float,
                 nu: float = 5e-4, capacity: int = 256,
                 state: Optional[ALDKRLSState] = None):
    """Drive a fresh (or given) dictionary over ``xs (n, d)``, ``ys (n,)``
    (paper §6: nu = 0.0005; in f32 ``repro`` runs 5e-3 at sigma = 5)."""
    if state is None:
        state = ald_krls_init(capacity, xs.shape[-1], xs.dtype,
                              device=xs.device)
    preds, errs = [], []
    for x, y in zip(xs, ys):
        state, out = ald_krls_step(state, (x, y), sigma, nu)
        preds.append(out.prediction)
        errs.append(out.error)
    if not preds:
        empty = ys.new_zeros((0,))
        return state, StepOut(prediction=empty, error=empty)
    return state, StepOut(prediction=torch.stack(preds),
                          error=torch.stack(errs))
