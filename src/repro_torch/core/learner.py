"""One ``OnlineLearner`` interface over every kernel adaptive filter.

Counterpart of ``repro/core/learner.py`` (without the sharded KRLS
adapter, ROADMAP §1 item 10). Each of the five algorithms (RFF-KLMS,
normalized RFF-KLMS, RFF-KRLS, QKLMS, ALD-KRLS) is wrapped behind one
protocol:

    init() -> state                       (a fresh single learner)
    step(state, x, y) -> (state, StepOut) (one sample)
    run(state, xs, ys) -> (state, StepOut tensors)
    predict(state, x) -> y_hat            (no update)
    rebuild(xs, ys, state, mode) -> state (replay; sequential for learners
                                           without scan elements)

Where ``repro`` vmaps a step over a bank, the port writes the bank axis
out: every ``step_fn`` and ``predict_fn`` takes leading batch dims on the
state and the sample alike, so ``core/bank.py``'s generic tier calls them
on ``(B, ...)`` leaves. For one learner (``x (d,)``) the RFF adapters run
the legacy step, bit for bit ``rff_klms_run`` / ``rff_krls_run``; with a
leading bank axis they run the same update with per-row reductions.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.core.klms import (
    LMSState,
    StepOut,
    rff_klms_init,
    rff_klms_step,
    rff_nklms_step,
)
from repro_torch.core.krls import RLSState, rff_krls_init, rff_krls_step
from repro_torch.core.krls_ald import (
    ald_krls_init,
    ald_krls_predict,
    ald_krls_step,
)
from repro_torch.core.qklms import qklms_init, qklms_predict, qklms_step
from repro_torch.core.scan import (
    ScanElement,
    klms_scan_element,
    krls_scan_element,
    nklms_scan_element,
    replay_klms,
    replay_krls,
)
from repro_torch.features.base import (
    FeatureLike,
    feature_device,
    feature_dtype,
    featurize,
)

__all__ = [
    "OnlineLearner",
    "klms_learner",
    "nklms_learner",
    "krls_learner",
    "qklms_learner",
    "ald_krls_learner",
]


@dataclass(frozen=True)
class OnlineLearner:
    """Algorithm-agnostic online learner: pure functions and a driver.

    Attributes:
      init_fn: ``(key=None) -> state``, a fresh single learner (the key is
        accepted for ``repro``'s signature and unused).
      step_fn: ``(state, x, y) -> (state, StepOut)``; leading batch dims
        on the state and on ``x (..., d)``, ``y (...)`` run a bank.
      predict_fn: ``(state, x) -> y_hat`` without an update.
      scan_element: the recurrence as an associative element
        (``core/scan.py``), or None for the dictionary learners.
      replay_fn: ``(xs, ys, state=None, mode=..., chunk=...) -> state``,
        the parallel-in-time rebuild, or None to fall back to ``run``.
    """

    init_fn: Callable
    step_fn: Callable
    predict_fn: Callable
    scan_element: Optional[ScanElement] = None
    replay_fn: Optional[Callable] = None

    def init(self, key=None):
        return self.init_fn(key)

    def step(self, state, x: torch.Tensor, y: torch.Tensor):
        return self.step_fn(state, x, y)

    def predict(self, state, x: torch.Tensor) -> torch.Tensor:
        return self.predict_fn(state, x)

    def run(self, state, xs: torch.Tensor, ys: torch.Tensor):
        """Drive the filter over ``xs (..., n, d)``, ``ys (..., n)``
        (leading dims: a bank). ``state=None`` starts a fresh single
        learner. Returns the final state and ``StepOut`` tensors
        ``(..., n)``; ``out.error**2`` is the learning curve."""
        if state is None:
            state = self.init()
        preds, errs = [], []
        for t in range(xs.shape[-2]):
            state, out = self.step_fn(state, xs[..., t, :], ys[..., t])
            preds.append(out.prediction)
            errs.append(out.error)
        if not preds:
            empty = ys.new_zeros(ys.shape)
            return state, StepOut(prediction=empty, error=empty)
        return state, StepOut(prediction=torch.stack(preds, dim=-1),
                              error=torch.stack(errs, dim=-1))

    def rebuild(self, xs: torch.Tensor, ys: torch.Tensor, state=None,
                mode: str = "scan", chunk: Optional[int] = None):
        """The final state after a replay log (no per-tick outputs).
        ``mode="sequential"``, or a learner without a ``replay_fn``, runs
        :meth:`run`, bit for bit the training path of one learner;
        ``"scan"`` / ``"blocked"`` go through ``core/scan.py``."""
        if self.replay_fn is None or mode == "sequential":
            final, _ = self.run(state, xs, ys)
            return final
        return self.replay_fn(xs, ys, state=state, mode=mode, chunk=chunk)


def _rowdot(u, v):
    return torch.sum(u * v, dim=-1)


def _lms_rows(state: LMSState, x, y, rff, mu, normalized, eps):
    """The (normalized) LMS update of a bank: ``theta (..., D)``."""
    z = featurize(rff, x)
    y_hat = _rowdot(state.theta, z)
    err = y - y_hat
    rate = mu / (eps + _rowdot(z, z)) if normalized else mu
    theta = state.theta + (rate * err)[..., None] * z
    return LMSState(theta=theta, step=state.step + 1), StepOut(y_hat, err)


def _rls_rows(state: RLSState, x, y, rff, beta):
    """The EW-RLS update of a bank: ``theta (..., D)``, ``P (..., D, D)``."""
    z = featurize(rff, x)
    y_hat = _rowdot(state.theta, z)
    err = y - y_hat
    pz = torch.matmul(state.pmat, z[..., None])[..., 0]
    gain = pz / (beta + _rowdot(z, pz))[..., None]
    theta = state.theta + gain * err[..., None]
    pmat = (state.pmat - gain[..., :, None] * pz[..., None, :]) / beta
    pmat = 0.5 * (pmat + pmat.mT)
    return (RLSState(theta=theta, pmat=pmat, step=state.step + 1),
            StepOut(y_hat, err))


def _theta_predict(rff):
    """``z(x) . theta``; ``x (..., d)`` broadcasts against theta's leading
    dims (one row answers ``(Q, d)`` queries)."""

    def predict(state, x):
        z = featurize(rff, x)
        if z.ndim == 1:
            return z @ state.theta
        return _rowdot(z, state.theta)

    return predict


def klms_learner(rff: FeatureLike, mu: float) -> OnlineLearner:
    """RFF-KLMS (paper §4): a fixed ``theta (D,)``, O(D d) a step."""

    def step(s, x, y):
        if x.ndim == 1:
            return rff_klms_step(s, (x, y), rff, mu)
        return _lms_rows(s, x, y, rff, mu, False, 0.0)

    return OnlineLearner(
        init_fn=lambda key=None: rff_klms_init(
            rff.num_features, feature_dtype(rff),
            device=feature_device(rff)),
        step_fn=step,
        predict_fn=_theta_predict(rff),
        scan_element=klms_scan_element(mu),
        replay_fn=lambda xs, ys, state=None, mode="scan", chunk=None: (
            replay_klms(rff, xs, ys, mu, state=state, mode=mode, chunk=chunk)
        ),
    )


def nklms_learner(rff: FeatureLike, mu: float,
                  eps: float = 1e-6) -> OnlineLearner:
    """Normalized RFF-KLMS: ``mu_eff = mu / (eps + ||z||^2)``."""

    def step(s, x, y):
        if x.ndim == 1:
            return rff_nklms_step(s, (x, y), rff, mu, eps)
        return _lms_rows(s, x, y, rff, mu, True, eps)

    return OnlineLearner(
        init_fn=lambda key=None: rff_klms_init(
            rff.num_features, feature_dtype(rff),
            device=feature_device(rff)),
        step_fn=step,
        predict_fn=_theta_predict(rff),
        scan_element=nklms_scan_element(mu, eps),
        replay_fn=lambda xs, ys, state=None, mode="scan", chunk=None: (
            replay_klms(rff, xs, ys, mu, state=state, mode=mode, chunk=chunk,
                        normalized=True, eps=eps)
        ),
    )


def krls_learner(rff: FeatureLike, lam: float = 1e-4,
                 beta: float = 0.9995) -> OnlineLearner:
    """RFF-KRLS (paper §6): a fixed ``theta (D,)`` and ``(D, D)`` P."""

    def step(s, x, y):
        if x.ndim == 1:
            return rff_krls_step(s, (x, y), rff, beta)
        return _rls_rows(s, x, y, rff, beta)

    return OnlineLearner(
        init_fn=lambda key=None: rff_krls_init(
            rff.num_features, lam, feature_dtype(rff),
            device=feature_device(rff)),
        step_fn=step,
        predict_fn=_theta_predict(rff),
        scan_element=krls_scan_element(beta),
        replay_fn=lambda xs, ys, state=None, mode="scan", chunk=None: (
            replay_krls(rff, xs, ys, lam=lam, beta=beta, state=state,
                        mode=mode, chunk=chunk)
        ),
    )


def qklms_learner(input_dim: int, sigma: float, mu: float, eps: float,
                  capacity: int = 512, dtype=torch.float32,
                  device="cuda") -> OnlineLearner:
    """The QKLMS baseline (a growing dictionary in a fixed buffer)."""
    return OnlineLearner(
        init_fn=lambda key=None: qklms_init(capacity, input_dim, dtype,
                                            device=device),
        step_fn=lambda s, x, y: qklms_step(s, (x, y), sigma, mu, eps),
        predict_fn=lambda s, x: qklms_predict(s, x, sigma),
    )


def ald_krls_learner(input_dim: int, sigma: float, nu: float = 5e-4,
                     capacity: int = 256, dtype=torch.float32,
                     device="cuda") -> OnlineLearner:
    """Engel's ALD-KRLS baseline (a growing dictionary, O(M^2) a step)."""
    return OnlineLearner(
        init_fn=lambda key=None: ald_krls_init(capacity, input_dim, dtype,
                                               device=device),
        step_fn=lambda s, x, y: ald_krls_step(s, (x, y), sigma, nu),
        predict_fn=lambda s, x: ald_krls_predict(s, x, sigma),
    )
