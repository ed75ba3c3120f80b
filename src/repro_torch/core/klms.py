"""RFF-KLMS — the paper's algorithm (§4): linear LMS on RFF-mapped data.

Counterpart of ``repro/core/klms.py`` (init, step, the normalized step,
run with its chunked schedule, and the mini-batch step). The solution is
a fixed-size ``theta in R^D``:

    y_hat_n = theta . z(x_n),   e_n = y_n - y_hat_n,
    theta  <- theta + mu e_n z(x_n).

``jax.lax.scan`` becomes a Python loop over the stream; the bank tier
(``core/bank.py``) runs many filters through the CUDA kernels.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import resolve_device
from repro_torch.features.base import FeatureLike, feature_dtype, featurize

__all__ = [
    "LMSState",
    "StepOut",
    "rff_klms_init",
    "lms_step",
    "rff_klms_step",
    "rff_nklms_step",
    "rff_klms_run",
    "rff_klms_batch_step",
]


class LMSState(NamedTuple):
    theta: torch.Tensor  # (D,) fixed-size solution, or (B, D) for a bank
    step: torch.Tensor  # () int32 iteration counter, or (B,)


class StepOut(NamedTuple):
    prediction: torch.Tensor  # y_hat_n
    error: torch.Tensor  # prior error e_n (the learning-curve quantity)


def rff_klms_init(num_features: int, dtype=torch.float32,
                  device="cuda") -> LMSState:
    """theta = 0 (paper: 'Set theta = 0')."""
    dev = resolve_device(device)
    return LMSState(
        theta=torch.zeros(num_features, dtype=dtype, device=dev),
        step=torch.zeros((), dtype=torch.int32, device=dev),
    )


def lms_step(theta, z, y, mu):
    """One linear-LMS update in feature space."""
    y_hat = theta @ z
    err = y - y_hat
    return theta + mu * err * z, StepOut(prediction=y_hat, error=err)


def rff_klms_step(state: LMSState, sample, rff: FeatureLike, mu: float):
    """Paper §4 steps 1-3 on one ``(x_n, y_n)`` pair."""
    x, y = sample
    theta, out = lms_step(state.theta, featurize(rff, x), y, mu)
    return LMSState(theta=theta, step=state.step + 1), out


def rff_nklms_step(state: LMSState, sample, rff: FeatureLike, mu: float,
                   eps: float = 1e-6):
    """Normalized variant: ``mu_eff = mu / (eps + ||z||^2)`` (beyond the
    paper)."""
    x, y = sample
    z = featurize(rff, x)
    y_hat = state.theta @ z
    err = y - y_hat
    theta = state.theta + (mu / (eps + z @ z)) * err * z
    return LMSState(theta=theta, step=state.step + 1), StepOut(y_hat, err)


def rff_klms_run(rff: FeatureLike, xs: torch.Tensor, ys: torch.Tensor,
                 mu: float, state: Optional[LMSState] = None,
                 normalized: bool = False, eps: float = 1e-6,
                 chunk: Optional[int] = None):
    """Drive the filter over ``xs (n, d)``, ``ys (n,)``; returns the final
    state and per-step ``StepOut`` tensors ``(n,)``. ``normalized=True``
    runs :func:`rff_nklms_step`.

    ``chunk=T`` featurizes T samples at a time in one ``(T, d) @ (d, D)``
    product and replays the recursion over the precomputed rows
    (``repro`` pads the last block and masks its padding; here the last
    block is short, which leaves the same state). The trajectory matches
    the per-tick run to the feature product's rounding.
    """
    if state is None:
        state = rff_klms_init(rff.num_features, feature_dtype(rff),
                              device=xs.device)
    preds, errs = [], []
    if chunk is None:
        for x, y in zip(xs, ys):
            if normalized:
                state, out = rff_nklms_step(state, (x, y), rff, mu, eps)
            else:
                state, out = rff_klms_step(state, (x, y), rff, mu)
            preds.append(out.prediction)
            errs.append(out.error)
    else:
        theta, step = state
        for start in range(0, xs.shape[0], chunk):
            zc = featurize(rff, xs[start:start + chunk])
            for z, y in zip(zc, ys[start:start + chunk]):
                mu_eff = mu / (eps + z @ z) if normalized else mu
                theta, out = lms_step(theta, z, y, mu_eff)
                step = step + 1
                preds.append(out.prediction)
                errs.append(out.error)
        state = LMSState(theta=theta, step=step)
    if not preds:
        empty = ys.new_zeros((0,))
        return state, StepOut(prediction=empty, error=empty)
    return state, StepOut(prediction=torch.stack(preds),
                          error=torch.stack(errs))


def rff_klms_batch_step(state: LMSState, xb: torch.Tensor, yb: torch.Tensor,
                        rff: FeatureLike, mu: float):
    """Mini-batch LMS: one step along the mean gradient of a batch ``xb
    (n, d)``, ``yb (n,)`` (one feature product instead of n matvecs; it
    changes the stochastic trajectory, not the stationary point). Returns
    (state, prior errors)."""
    zb = featurize(rff, xb)
    errs = yb - zb @ state.theta
    grad = zb.T @ errs / xb.shape[0]
    return (LMSState(theta=state.theta + mu * grad,
                     step=state.step + xb.shape[0]), errs)
