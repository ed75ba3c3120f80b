"""RFF-KRLS — the paper's §6: exponentially weighted RLS on RFF-mapped data.

Counterpart of the dense half of ``repro/core/krls.py`` (init, step, run
and the chunked run; the sharded half is ROADMAP §1 item 10). The state is
a fixed ``theta (D,)`` plus a fixed ``(D, D)`` inverse-correlation matrix:

    P_0 = I / lam,   z = z(x_n),   e = y_n - theta . z,
    g = P z / (beta + z . P z),   theta <- theta + g e,
    P <- (P - g (P z)^T) / beta,  then symmetrized.

``jax.lax.scan`` becomes a Python loop over the stream; the bank tier
(``core/bank.py``) runs many tenants through the CUDA kernels.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch import resolve_device
from repro_torch.core.klms import StepOut
from repro_torch.features.base import FeatureLike, feature_dtype, featurize

__all__ = [
    "RLSState",
    "rff_krls_init",
    "rls_step",
    "rff_krls_step",
    "rff_krls_run",
]


class RLSState(NamedTuple):
    theta: torch.Tensor  # (D,), or (B, D) for a bank
    pmat: torch.Tensor  # (D, D) inverse-correlation estimate, or (B, D, D)
    step: torch.Tensor  # () int32 iteration counter, or (B,)


def rff_krls_init(num_features: int, lam: float = 1e-4, dtype=torch.float32,
                  device="cuda") -> RLSState:
    """theta = 0, P_0 = I / lam."""
    dev = resolve_device(device)
    return RLSState(
        theta=torch.zeros(num_features, dtype=dtype, device=dev),
        pmat=torch.eye(num_features, dtype=dtype, device=dev) / lam,
        step=torch.zeros((), dtype=torch.int32, device=dev),
    )


def rls_step(theta, pmat, z, y, beta):
    """One EW-RLS update in feature space; returns (theta, P, StepOut)."""
    y_hat = theta @ z
    err = y - y_hat
    pz = pmat @ z
    denom = beta + z @ pz
    gain = pz / denom
    theta = theta + gain * err
    pmat = (pmat - torch.outer(gain, pz)) / beta
    # Symmetrize to fight drift over long streams (numerical hygiene).
    pmat = 0.5 * (pmat + pmat.T)
    return theta, pmat, StepOut(prediction=y_hat, error=err)


def rff_krls_step(state: RLSState, sample, rff: FeatureLike,
                  beta: float = 0.9995):
    """Paper §6 on one ``(x_n, y_n)`` pair."""
    x, y = sample
    theta, pmat, out = rls_step(state.theta, state.pmat, featurize(rff, x),
                                y, beta)
    return RLSState(theta=theta, pmat=pmat, step=state.step + 1), out


def _stack(outs, like):
    if not outs:
        empty = like.new_zeros((0,))
        return StepOut(prediction=empty, error=empty)
    return StepOut(prediction=torch.stack([o.prediction for o in outs]),
                   error=torch.stack([o.error for o in outs]))


def rff_krls_run(rff: FeatureLike, xs: torch.Tensor, ys: torch.Tensor,
                 lam: float = 1e-4, beta: float = 0.9995,
                 state: Optional[RLSState] = None,
                 chunk: Optional[int] = None):
    """Drive the filter over ``xs (n, d)``, ``ys (n,)`` (paper §6 settings:
    lam = 1e-4, beta = 0.9995, D = 300). Returns the final state and
    per-step ``StepOut`` tensors ``(n,)``.

    ``chunk=T`` featurizes T samples at a time in one ``(T, d) @ (d, D)``
    product and replays the recursion over the precomputed rows (``repro``
    pads the last block and masks its padding; here the last block is
    short, which leaves the same state).
    """
    if state is None:
        state = rff_krls_init(rff.num_features, lam, feature_dtype(rff),
                              device=xs.device)
    outs = []
    if chunk is None:
        for x, y in zip(xs, ys):
            state, out = rff_krls_step(state, (x, y), rff, beta)
            outs.append(out)
        return state, _stack(outs, ys)
    for start in range(0, xs.shape[0], chunk):
        zc = featurize(rff, xs[start:start + chunk])
        for z, y in zip(zc, ys[start:start + chunk]):
            theta, pmat, out = rls_step(state.theta, state.pmat, z, y, beta)
            state = RLSState(theta=theta, pmat=pmat, step=state.step + 1)
            outs.append(out)
    return state, _stack(outs, ys)
