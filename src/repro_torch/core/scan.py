"""Parallel-in-time replay: learner recurrences as associative scan elements.

Counterpart of ``repro/core/scan.py``. The RFF map makes every learner's
state a fixed-size Euclidean object, so each tick is a structured affine
map on it, and affine maps compose associatively: T sequential ticks
rebuild in O(log T) depth. This is the engine of tenant rebuild from a
replay log (``core.bank.rebuild_tenant``).

Two element algebras:

* **Affine elements** (KLMS / NKLMS): the LMS tick is
  ``theta' = (I - mu z z^T) theta + mu y z``, an :class:`AffineElement`
  ``(A, v)`` composed by ``(A2 A1, A2 v1 + v2)`` (a (D, D) product).
* **Decay elements** (KRLS): in information form, ``Phi = P^{-1}``,
  ``Phi' = beta Phi + z z^T``, ``r' = beta r + y z``, ``theta = Phi^{-1}
  r``; a :class:`DecayElement` ``(g, Phi_add, r_add)`` composes with O(D^2)
  adds, and the one inversion happens at the end.

Modes of ``replay_klms`` / ``replay_krls``:

* ``"sequential"`` — the per-tick runs (:func:`rff_klms_run`,
  :func:`rff_krls_run`); bit for bit the training path;
* ``"scan"`` — per-tick elements from one featurize of the whole log
  (``ops.rff_features``, the feature-map kernel on the card) and
  :func:`tree_reduce`; materializes (T, D, D) elements;
* ``"blocked"`` — the element kernels (``ops.rff_*_chunk_elements``) fold
  each chunk of Tc ticks into one element, then :func:`tree_reduce` over
  the nc chunk elements.

The reference composes with ``jax.lax.associative_scan`` and keeps only
the last prefix. PyTorch has no ``associative_scan``, and replay needs no
other prefix, so :func:`tree_reduce` computes that last prefix alone: the
same pairing as the scan's odd/even recursion, with n - 1 combines and
no (n, ...) prefix buffers. The cross-chunk products and the final
``linalg.inv`` / ``solve`` are PyTorch calls, as the reference leaves
them to XLA outside any kernel.

A family without an affine-trig form runs ``"scan"`` through the generic
``featurize``; ``"blocked"`` needs the trig form and falls back to
``"scan"`` for it (the reference's rule; every ported family has the trig
form).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core.klms import LMSState, rff_klms_init, rff_klms_run
from repro_torch.core.krls import RLSState, rff_krls_run
from repro_torch.features.base import (
    FeatureLike,
    as_trig_or_none,
    feature_dtype,
    featurize,
)
from repro_torch.kernels import ops

__all__ = [
    "AffineElement",
    "DecayElement",
    "ScanElement",
    "affine_combine",
    "affine_identity",
    "affine_apply",
    "decay_combine",
    "decay_identity",
    "decay_apply",
    "tree_reduce",
    "klms_to_element",
    "nklms_to_element",
    "krls_to_element",
    "klms_scan_element",
    "nklms_scan_element",
    "krls_scan_element",
    "replay_klms",
    "replay_krls",
]


# ---------------------------------------------------------------------------
# Element algebras.
# ---------------------------------------------------------------------------


class AffineElement(NamedTuple):
    """Affine state maps ``theta -> a @ theta + v``: ``a (..., D, D)``,
    ``v (..., D)``."""

    a: torch.Tensor
    v: torch.Tensor


def affine_combine(first: AffineElement, second: AffineElement) -> AffineElement:
    """Apply ``first``, then ``second``: ``(A2 A1, A2 v1 + v2)``. Leading
    batch axes broadcast."""
    return AffineElement(
        a=torch.matmul(second.a, first.a),
        v=torch.matmul(second.a, first.v[..., None])[..., 0] + second.v,
    )


def affine_identity(num_features: int, dtype=torch.float32,
                    device=None) -> AffineElement:
    """The do-nothing tick ``(I, 0)``."""
    return AffineElement(
        a=torch.eye(num_features, dtype=dtype, device=device),
        v=torch.zeros(num_features, dtype=dtype, device=device),
    )


def affine_apply(element: AffineElement, theta: torch.Tensor) -> torch.Tensor:
    """``A theta + v``: advance a start state through a composed element."""
    return torch.matmul(element.a, theta[..., None])[..., 0] + element.v


class DecayElement(NamedTuple):
    """Scalar-gated additive maps ``(Phi, r) -> (g Phi + phi, g r + r)``:
    ``g (...,)``, ``phi (..., D, D)``, ``r (..., D)``."""

    g: torch.Tensor
    phi: torch.Tensor
    r: torch.Tensor


def decay_combine(first: DecayElement, second: DecayElement) -> DecayElement:
    """Apply ``first``, then ``second``."""
    g2 = second.g
    return DecayElement(
        g=g2 * first.g,
        phi=g2[..., None, None] * first.phi + second.phi,
        r=g2[..., None] * first.r + second.r,
    )


def decay_identity(num_features: int, dtype=torch.float32,
                   device=None) -> DecayElement:
    """The do-nothing tick ``(1, 0, 0)``."""
    return DecayElement(
        g=torch.ones((), dtype=dtype, device=device),
        phi=torch.zeros(num_features, num_features, dtype=dtype,
                        device=device),
        r=torch.zeros(num_features, dtype=dtype, device=device),
    )


def decay_apply(element: DecayElement, phi0: torch.Tensor, r0: torch.Tensor):
    """Advance a start information state ``(Phi_0, r_0)``."""
    return (
        element.g[..., None, None] * phi0 + element.phi,
        element.g[..., None] * r0 + element.r,
    )


def _take(elems, index):
    return type(elems)(*(a[index] for a in elems))


def tree_reduce(combine: Callable, elems):
    """Compose ``elems`` (a ``NamedTuple`` of tensors sharing a leading axis
    of length n >= 1) in order under the associative ``combine(first,
    second)``: the last element of their inclusive scan.

    A pairwise tree reduction that associates as the odd/even recursion of
    ``jax.lax.associative_scan`` does for its last element: an even n
    combines neighbouring pairs and reduces the n/2 results; an odd n
    reduces the first n - 1 and combines the last one on. n - 1 combines,
    each level one batched ``combine`` over the leading axis.
    """
    n = elems[0].shape[0]
    if n < 1:
        raise ValueError("tree_reduce needs at least one element")
    if n == 1:
        return _take(elems, 0)
    if n % 2:
        return combine(tree_reduce(combine, _take(elems, slice(0, -1))),
                       _take(elems, -1))
    return tree_reduce(combine, combine(_take(elems, slice(0, None, 2)),
                                        _take(elems, slice(1, None, 2))))


# ---------------------------------------------------------------------------
# Per-learner tick elements.
# ---------------------------------------------------------------------------


def klms_to_element(z: torch.Tensor, y: torch.Tensor, mu) -> AffineElement:
    """One KLMS tick ``(I - mu z z^T, mu y z)``; ``z (..., D)``, ``y
    (...,)``, leading axes batch."""
    eye = torch.eye(z.shape[-1], dtype=z.dtype, device=z.device)
    mu = torch.as_tensor(mu, dtype=z.dtype, device=z.device)
    a = eye - mu * z[..., :, None] * z[..., None, :]
    return AffineElement(a=a, v=mu * y[..., None] * z)


def nklms_to_element(z: torch.Tensor, y: torch.Tensor, mu,
                     eps: float = 1e-6) -> AffineElement:
    """One normalized-LMS tick, ``mu_eff = mu / (eps + ||z||^2)``: still
    affine in theta because the normalizer depends only on z."""
    mu_eff = torch.as_tensor(mu, dtype=z.dtype, device=z.device) / (
        eps + torch.sum(z * z, dim=-1, keepdim=True)
    )
    eye = torch.eye(z.shape[-1], dtype=z.dtype, device=z.device)
    a = eye - mu_eff[..., None] * z[..., :, None] * z[..., None, :]
    return AffineElement(a=a, v=mu_eff * y[..., None] * z)


def krls_to_element(z: torch.Tensor, y: torch.Tensor, beta) -> DecayElement:
    """One EW-RLS tick in information form ``(beta, z z^T, y z)``."""
    beta = torch.as_tensor(beta, dtype=z.dtype, device=z.device)
    return DecayElement(
        g=beta.expand(z.shape[:-1]),
        phi=z[..., :, None] * z[..., None, :],
        r=y[..., None] * z,
    )


# ---------------------------------------------------------------------------
# The ScanElement contract: one bundle per learner family.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ScanElement:
    """A learner recurrence packaged as an associative algebra.

    Attributes:
      to_element: ``(z, y) -> element``, one tick (hyperparameters closed
        over), batched over leading axes.
      combine: associative ``(first, second) -> element``.
      identity: ``(num_features, dtype) -> element``, the no-op tick.
      apply: ``(element, state) -> state``.
    """

    to_element: Callable
    combine: Callable
    identity: Callable
    apply: Callable


def _affine_apply_state(element: AffineElement, state: LMSState) -> LMSState:
    """Advance an :class:`LMSState` through a composed element (step
    accounting is the caller's job)."""
    return LMSState(theta=affine_apply(element, state.theta), step=state.step)


def klms_scan_element(mu: float) -> ScanElement:
    """The KLMS recurrence as a :class:`ScanElement` (fixed ``mu``)."""
    return ScanElement(
        to_element=lambda z, y: klms_to_element(z, y, mu),
        combine=affine_combine,
        identity=affine_identity,
        apply=_affine_apply_state,
    )


def nklms_scan_element(mu: float, eps: float = 1e-6) -> ScanElement:
    """The normalized-KLMS recurrence as a :class:`ScanElement`."""
    return ScanElement(
        to_element=lambda z, y: nklms_to_element(z, y, mu, eps),
        combine=affine_combine,
        identity=affine_identity,
        apply=_affine_apply_state,
    )


def krls_scan_element(beta: float) -> ScanElement:
    """The EW-RLS recurrence (information form) as a :class:`ScanElement`;
    ``apply`` converts back to covariance form (:func:`_decay_to_rls`)."""
    return ScanElement(
        to_element=lambda z, y: krls_to_element(z, y, beta),
        combine=decay_combine,
        identity=decay_identity,
        apply=_decay_apply_state,
    )


def _decay_to_rls(phi: torch.Tensor, r: torch.Tensor, step) -> RLSState:
    """Information form -> covariance form: ``theta = Phi^{-1} r``, ``P =
    Phi^{-1}``, symmetrized as the sequential path does."""
    pmat = torch.linalg.inv(phi)
    pmat = 0.5 * (pmat + pmat.mT)
    theta = torch.linalg.solve(phi, r)
    return RLSState(theta=theta, pmat=pmat, step=step)


def _decay_apply_state(element: DecayElement, state: RLSState) -> RLSState:
    """Advance an :class:`RLSState` through a composed element: the start
    covariance is inverted once (``Phi_0 = P_0^{-1}``, ``r_0 = Phi_0
    theta_0``). Step accounting is the caller's job."""
    phi0 = torch.linalg.inv(state.pmat)
    phi0 = 0.5 * (phi0 + phi0.mT)
    r0 = phi0 @ state.theta
    phi, r = decay_apply(element, phi0, r0)
    return _decay_to_rls(phi, r, state.step)


# ---------------------------------------------------------------------------
# Replay: rebuild a learner state from an (xs, ys) log.
# ---------------------------------------------------------------------------


def _log_features(rff: FeatureLike, tf, xs, kernel_mode):
    """The log's (T, D) features: the feature-map op for a trig map, the
    generic ``featurize`` otherwise."""
    if tf is None:
        return featurize(rff, xs)
    return ops.rff_features(xs, tf.omega, tf.bias, tf.scale, mode=kernel_mode)


def replay_klms(rff: FeatureLike, xs: torch.Tensor, ys: torch.Tensor, mu,
                state: Optional[LMSState] = None, mode: str = "scan",
                chunk: Optional[int] = None, normalized: bool = False,
                eps: float = 1e-6, kernel_mode: str = "auto") -> LMSState:
    """Rebuild a KLMS state from a replay log ``xs (T, d)``, ``ys (T,)``.

    ``mode``: ``"sequential"`` (:func:`rff_klms_run`, bit for bit the
    training path), ``"scan"`` (per-tick affine elements, (T, D, D)
    memory) or ``"blocked"`` (per-chunk elements from the element kernel,
    (nc, D, D) memory; ``chunk=None`` takes ``default_chunk_t(...,
    elements=True)``). ``kernel_mode`` is the ops dispatch ("auto",
    "cuda", "ref"). Non-sequential modes match the sequential trajectory
    to reassociation rounding, not bit for bit.
    """
    if state is None:
        state = rff_klms_init(rff.num_features, feature_dtype(rff),
                              device=xs.device)
    if mode == "sequential":
        final, _ = rff_klms_run(rff, xs, ys, mu, state=state,
                                normalized=normalized, eps=eps)
        return final
    tf = as_trig_or_none(rff)
    if mode == "blocked" and tf is None:
        mode = "scan"  # no fused kernel form without the trig map
    if mode == "scan":
        z = _log_features(rff, tf, xs, kernel_mode)  # (T, D)
        if normalized:
            elements = nklms_to_element(z, ys, mu, eps)
        else:
            elements = klms_to_element(z, ys, mu)
    elif mode == "blocked":
        elements = AffineElement(*ops.rff_klms_chunk_elements(
            xs, ys, tf.omega, tf.bias, mu, tf.scale, mode=kernel_mode,
            chunk=chunk, normalized=normalized, eps=eps,
        ))
    else:
        raise ValueError(f"unknown replay mode {mode!r}")
    composed = tree_reduce(affine_combine, elements)
    return LMSState(theta=affine_apply(composed, state.theta),
                    step=state.step + xs.shape[0])


def replay_krls(rff: FeatureLike, xs: torch.Tensor, ys: torch.Tensor,
                lam: float = 1e-4, beta: float = 0.9995,
                state: Optional[RLSState] = None, mode: str = "scan",
                chunk: Optional[int] = None,
                kernel_mode: str = "auto") -> RLSState:
    """Rebuild a KRLS state from a replay log ``xs (T, d)``, ``ys (T,)``.

    ``mode`` as :func:`replay_klms`, with ``"sequential"`` the dense
    Sherman-Morrison replay (:func:`rff_krls_run`). The scan modes
    accumulate the information form and invert once, so they track the
    sequential trajectory to solver accuracy, which at a small ``lam`` is
    limited by cond(Phi) (tests/test_torch_replay.py states the bounds).
    """
    if mode == "sequential":
        final, _ = rff_krls_run(rff, xs, ys, lam=lam, beta=beta, state=state)
        return final
    tf = as_trig_or_none(rff)
    if mode == "blocked" and tf is None:
        mode = "scan"
    if mode == "scan":
        z = _log_features(rff, tf, xs, kernel_mode)
        elements = krls_to_element(z, ys, beta)
    elif mode == "blocked":
        elements = DecayElement(*ops.rff_krls_chunk_elements(
            xs, ys, tf.omega, tf.bias, beta, tf.scale, mode=kernel_mode,
            chunk=chunk,
        ))
    else:
        raise ValueError(f"unknown replay mode {mode!r}")
    composed = tree_reduce(decay_combine, elements)
    if state is None:
        # Fresh start: Phi_0 = lam I exactly, no inversion needed.
        dfeat = rff.num_features
        dtype = feature_dtype(rff)
        phi0 = lam * torch.eye(dfeat, dtype=dtype, device=xs.device)
        phi, r = decay_apply(composed, phi0,
                             torch.zeros(dfeat, dtype=dtype, device=xs.device))
        step = torch.tensor(xs.shape[0], dtype=torch.int32, device=xs.device)
        return _decay_to_rls(phi, r, step)
    final = _decay_apply_state(composed, state)
    return final._replace(step=state.step + xs.shape[0])
