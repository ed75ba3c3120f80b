"""QKLMS — Quantized Kernel LMS (Chen et al. 2012), the paper's §2 baseline.

Counterpart of ``repro/core/qklms.py``. A growing-dictionary KLMS with
input-space quantization: a sample becomes a new centre only if its
squared distance to every occupied centre is at least ``eps``; otherwise
the nearest centre's coefficient absorbs the update. The dictionary is a
fixed-capacity buffer ``(capacity, d)`` with an occupancy count, so the
per-step cost is O(capacity d), the sequential search the paper
criticizes.

Every function takes leading batch dims on the state and the sample alike:
a bank of B learners is the same call on leaves with a leading ``(B,)``
axis (``core/bank.py``'s generic tier). A step makes its decisions with
``torch.where`` per row and writes by one-hot selects, so a tick never
reads a value back to the host.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import resolve_device
from repro_torch.core.klms import StepOut

__all__ = ["QKLMSState", "qklms_init", "qklms_step", "qklms_run",
           "qklms_predict"]

_BIG = 1e30  # the squared distance of an empty slot


class QKLMSState(NamedTuple):
    centers: torch.Tensor  # (..., capacity, d)
    coeffs: torch.Tensor  # (..., capacity)
    size: torch.Tensor  # (...) int32 dictionary size M
    step: torch.Tensor  # (...) int32


def qklms_init(capacity: int, input_dim: int, dtype=torch.float32,
               device="cuda") -> QKLMSState:
    """An empty dictionary of ``capacity`` slots."""
    dev = resolve_device(device)
    return QKLMSState(
        centers=torch.zeros(capacity, input_dim, dtype=dtype, device=dev),
        coeffs=torch.zeros(capacity, dtype=dtype, device=dev),
        size=torch.zeros((), dtype=torch.int32, device=dev),
        step=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _kernel_vec(centers, x, sigma):
    """Gaussian kernel values and squared distances of ``x`` to every
    slot, in ``repro``'s order: the sum over d of the squared differences,
    then ``exp(-sq / (2 sigma^2))``."""
    sq = torch.sum(torch.square(centers - x[..., None, :]), dim=-1)
    return torch.exp(-sq / (2.0 * sigma**2)), sq


def _occupied(state: QKLMSState) -> torch.Tensor:
    cap = state.centers.shape[-2]
    idx = torch.arange(cap, device=state.size.device)
    return idx < state.size[..., None]


def qklms_predict(state: QKLMSState, x: torch.Tensor, sigma: float):
    """``f(x) = sum_k coeffs_k kappa(c_k, x)`` over the occupied slots.
    ``x (..., d)`` broadcasts against the state's leading dims, so one
    row answers ``(Q, d)`` queries."""
    kvec, _ = _kernel_vec(state.centers, x, sigma)
    terms = torch.where(_occupied(state), state.coeffs * kvec, 0.0)
    return torch.sum(terms, dim=-1)


def qklms_step(state: QKLMSState, sample, sigma: float, mu: float,
               eps: float):
    """One QKLMS iteration (paper §2 steps 1-6) on ``sample = (x, y)``.

    ``eps`` is the quantization size, compared with the squared distance
    ``d_k = ||x - c_k||^2``. The first sample always grows; a full
    dictionary merges into the nearest centre (the insert position is
    clamped, as in ``repro``).
    """
    x, y = sample
    cap = state.centers.shape[-2]
    occupied = _occupied(state)
    kvec, sq = _kernel_vec(state.centers, x, sigma)
    y_hat = torch.sum(torch.where(occupied, state.coeffs * kvec, 0.0), dim=-1)
    err = y - y_hat

    dists = torch.where(occupied, sq, _BIG)
    k_min = torch.argmin(dists, dim=-1)  # the first minimum, as jnp.argmin
    d_min = torch.gather(dists, -1, k_min[..., None])[..., 0]
    insert_at = torch.clamp(state.size, max=cap - 1).to(k_min.dtype)
    full = state.size >= cap
    grow = (d_min >= eps) & (state.size > 0) & ~full
    do_insert = grow | (state.size == 0)
    slot = torch.where(do_insert, insert_at, k_min)

    onehot = torch.arange(cap, device=slot.device) == slot[..., None]
    old = torch.gather(state.coeffs, -1, slot[..., None])[..., 0]
    new_coeff = torch.where(do_insert, mu * err, old + mu * err)
    coeffs = torch.where(onehot, new_coeff[..., None], state.coeffs)
    write = (onehot & do_insert[..., None])[..., None]
    centers = torch.where(write, x[..., None, :], state.centers)
    size = state.size + do_insert.to(torch.int32)
    return (
        QKLMSState(centers=centers, coeffs=coeffs, size=size,
                   step=state.step + 1),
        StepOut(prediction=y_hat, error=err),
    )


def qklms_run(xs: torch.Tensor, ys: torch.Tensor, sigma: float, mu: float,
              eps: float, capacity: int = 512,
              state: Optional[QKLMSState] = None):
    """Drive a fresh (or given) dictionary over ``xs (n, d)``, ``ys (n,)``;
    returns the final state and per-step ``StepOut`` tensors ``(n,)``.
    ``capacity`` bounds the dictionary."""
    if state is None:
        state = qklms_init(capacity, xs.shape[-1], xs.dtype, device=xs.device)
    preds, errs = [], []
    for x, y in zip(xs, ys):
        state, out = qklms_step(state, (x, y), sigma, mu, eps)
        preds.append(out.prediction)
        errs.append(out.error)
    if not preds:
        empty = ys.new_zeros((0,))
        return state, StepOut(prediction=empty, error=empty)
    return state, StepOut(prediction=torch.stack(preds),
                          error=torch.stack(errs))
