"""The paper's experiment generators (§5.1-§5.4, §6) and model (7).

Counterpart of ``repro/data/synthetic.py``. The port cannot reproduce
JAX's PRNG, so each generator is split in two: ``gen_*`` draws the noise
from an explicit ``torch.Generator`` (on its device, in bulk), and a
``*_from_noise`` function of the noise alone computes the stream. Tests
hand the ``*_from_noise`` functions the noise that ``repro``'s keys draw.

``runs=R`` draws R independent realizations at once: every tensor gains a
leading ``(R,)`` axis, the bank axis of a figure's Monte-Carlo runs. All
constants default to the paper's values.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch.core.rff import gaussian_kernel

__all__ = [
    "KernelExpansionData",
    "kernel_expansion_from_noise",
    "nonlinear_wiener_from_noise",
    "chaotic1_from_noise",
    "chaotic2_from_noise",
    "gen_kernel_expansion",
    "gen_nonlinear_wiener",
    "gen_chaotic1",
    "gen_chaotic2",
    "make_lagged",
]


class KernelExpansionData(NamedTuple):
    xs: torch.Tensor  # (..., n, d)
    ys: torch.Tensor  # (..., n)
    centers: torch.Tensor  # (..., M, d)
    coeffs: torch.Tensor  # (..., M)


def _randn(generator, runs, *shape):
    lead = () if runs is None else (runs,)
    return torch.randn(*lead, *shape, generator=generator,
                       device=generator.device)


def kernel_expansion_from_noise(centers, coeffs, xs, eta,
                                sigma: float = 5.0) -> torch.Tensor:
    """Model (7): ``y = sum_m a_m kappa_sigma(c_m, x) + eta`` from the
    drawn ``centers (..., M, d)``, ``coeffs (..., M)``, ``xs (..., n, d)``
    and ``eta (..., n)`` (each already scaled)."""
    kmat = gaussian_kernel(xs[..., :, None, :], centers[..., None, :, :],
                           sigma)
    return torch.matmul(kmat, coeffs[..., None])[..., 0] + eta


def nonlinear_wiener_from_noise(w0, w1, xs, eta) -> torch.Tensor:
    """Model (9): ``y = w0 . x + 0.1 (w1 . x)^2 + eta``."""
    lin = torch.matmul(xs, w0[..., None])[..., 0]
    quad = torch.matmul(xs, w1[..., None])[..., 0]
    return lin + 0.1 * torch.square(quad) + eta


def chaotic1_from_noise(us, eta, d_init: float = 1.0):
    """§5.3: ``d_n = d_{n-1} / (1 + d_{n-1}^2) + u_{n-1}^3``, ``y_n = d_n +
    eta_n``; the filter's input is ``x_n = (u_{n-1}, d_{n-1})``. Returns
    ``xs (..., n, 2)``, ``ys (..., n)``."""
    d_prev = torch.full(us.shape[:-1], d_init, dtype=us.dtype,
                        device=us.device)
    ds, d_prevs = [], []
    for t in range(us.shape[-1]):
        d = d_prev / (1.0 + d_prev**2) + us[..., t] ** 3
        ds.append(d)
        d_prevs.append(d_prev)
        d_prev = d
    xs = torch.stack([us, torch.stack(d_prevs, dim=-1)], dim=-1)
    return xs, torch.stack(ds, dim=-1) + eta


def _phi(d):
    pos = d / (3.0 * torch.sqrt(0.1 + 0.9 * d**2))
    neg = -torch.square(d) * (1.0 - torch.exp(0.7 * d)) / 3.0
    return torch.where(d >= 0, pos, neg)


def chaotic2_from_noise(vs, eta_hat, eta, d_init: float = 1.0):
    """§5.4: an ARMA series ``d_n = u_n + 0.5 v_n - 0.2 d_{n-1} + 0.35
    d_{n-2}`` with ``u_n = 0.5 v_n + eta_hat_n`` through the saturating
    ``phi``, ``y_n = phi(d_n) + eta_n``; the input regressor is ``x_n =
    (u_n, u_{n-1})``. Returns ``xs (..., n, 2)``, ``ys (..., n)``."""
    us = 0.5 * vs + eta_hat
    d1 = torch.full(us.shape[:-1], d_init, dtype=us.dtype, device=us.device)
    d2 = d1
    ds = []
    for t in range(us.shape[-1]):
        d = us[..., t] + 0.5 * vs[..., t] - 0.2 * d1 + 0.35 * d2
        ds.append(d)
        d1, d2 = d, d1
    ys = _phi(torch.stack(ds, dim=-1)) + eta
    u_prev = torch.cat([torch.zeros_like(us[..., :1]), us[..., :-1]], dim=-1)
    return torch.stack([us, u_prev], dim=-1), ys


def gen_kernel_expansion(generator: torch.Generator, num_samples: int = 5000,
                         input_dim: int = 5, num_centers: int = 10,
                         sigma: float = 5.0, sigma_x: float = 1.0,
                         sigma_eta: float = 0.1, coeff_std: float = 5.0,
                         runs: Optional[int] = None) -> KernelExpansionData:
    """§5.1, model (7): ``a_m ~ N(0, 25)``, ``x ~ N(0, I)``, ``eta ~ N(0,
    0.1^2)``, sigma = 5, on the generator's device."""
    centers = _randn(generator, runs, num_centers, input_dim)
    coeffs = coeff_std * _randn(generator, runs, num_centers)
    xs = sigma_x * _randn(generator, runs, num_samples, input_dim)
    eta = sigma_eta * _randn(generator, runs, num_samples)
    ys = kernel_expansion_from_noise(centers, coeffs, xs, eta, sigma)
    return KernelExpansionData(xs=xs, ys=ys, centers=centers, coeffs=coeffs)


def gen_nonlinear_wiener(generator: torch.Generator,
                         num_samples: int = 15000, input_dim: int = 5,
                         sigma_eta: float = 0.05,
                         runs: Optional[int] = None):
    """§5.2, model (9), ``w0, w1 ~ N(0, I)``. Returns ``(xs, ys)``."""
    w0 = _randn(generator, runs, input_dim)
    w1 = _randn(generator, runs, input_dim)
    xs = _randn(generator, runs, num_samples, input_dim)
    eta = sigma_eta * _randn(generator, runs, num_samples)
    return xs, nonlinear_wiener_from_noise(w0, w1, xs, eta)


def gen_chaotic1(generator: torch.Generator, num_samples: int = 500,
                 sigma_u: float = 0.15, sigma_eta: float = 0.01,
                 d_init: float = 1.0, runs: Optional[int] = None):
    """§5.3, chaotic series 1. Returns ``(xs, ys)``."""
    us = sigma_u * _randn(generator, runs, num_samples)
    eta = sigma_eta * _randn(generator, runs, num_samples)
    return chaotic1_from_noise(us, eta, d_init)


def gen_chaotic2(generator: torch.Generator, num_samples: int = 1000,
                 sigma_v2: float = 0.0156, sigma_eta: float = 0.001,
                 d_init: float = 1.0, runs: Optional[int] = None):
    """§5.4, chaotic series 2 (``v``, ``eta_hat`` iid ``N(0, 0.0156)``).
    Returns ``(xs, ys)``."""
    sv = math.sqrt(sigma_v2)
    vs = sv * _randn(generator, runs, num_samples)
    eta_hat = sv * _randn(generator, runs, num_samples)
    eta = sigma_eta * _randn(generator, runs, num_samples)
    return chaotic2_from_noise(vs, eta_hat, eta, d_init)


def make_lagged(series: torch.Tensor, num_lags: int) -> torch.Tensor:
    """Lag vectors ``x_n = (s_n, ..., s_{n-L+1})`` of a scalar series, the
    first ``L - 1`` rows zero."""
    x = torch.stack([torch.roll(series, i) for i in range(num_lags)], dim=-1)
    x[: num_lags - 1] = 0.0
    return x
