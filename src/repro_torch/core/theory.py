"""Closed-form convergence theory for RFF-KLMS (paper §4, Lemma 1, Prop. 1).

Counterpart of ``repro/core/theory.py``. For data of the paper's model (7),

    y_n = sum_m a_m kappa(c_m, x_n) + eta_n,   x_n ~ N(0, sigma_x^2 I_d),
    eta_n ~ N(0, sigma_eta^2),

the correlation matrix ``R_zz = E[z(x) z(x)^T]`` has closed-form entries.
With the ``sqrt(2/D)`` feature scale each picks up ``2/D``:

    r_ij = (1/D) [ exp(-||w_i - w_j||^2 sx^2 / 2) cos(b_i - b_j)
                 + exp(-||w_i + w_j||^2 sx^2 / 2) cos(b_i + b_j) ].

Proposition 1: mean convergence iff ``0 < mu < 2 / lambda_max(R)``; the
recursion ``A_{n+1} ~= A_n - mu (R A_n + A_n R) + mu^2 sigma_eta^2 R`` has
the stationary MSE ``J_ss ~= sigma_eta^2 + (mu sigma_eta^2 / 2) tr(R)``.
These are oracles for tests and figure 1: small-D dense algebra.
"""
from __future__ import annotations

import torch

from repro_torch.core.rff import RFF, rff_features

__all__ = [
    "rzz_closed_form",
    "rzz_monte_carlo",
    "theta_opt",
    "max_stable_mu",
    "steady_state_mse",
    "mse_evolution",
]


def rzz_closed_form(rff: RFF, sigma_x: float) -> torch.Tensor:
    """Closed-form ``R_zz`` for ``x ~ N(0, sigma_x^2 I)``, from
    ``E[cos(u . x + c)] = exp(-||u||^2 sigma_x^2 / 2) cos(c)``."""
    w, b = rff.omega, rff.bias
    sq = torch.sum(torch.square(w), dim=0)
    dots = w.T @ w
    diff_sq = sq[:, None] + sq[None, :] - 2.0 * dots
    sum_sq = sq[:, None] + sq[None, :] + 2.0 * dots
    s2 = sigma_x**2 / 2.0
    r = (torch.exp(-diff_sq * s2) * torch.cos(b[:, None] - b[None, :])
         + torch.exp(-sum_sq * s2) * torch.cos(b[:, None] + b[None, :]))
    return r / rff.num_features


def rzz_monte_carlo(rff: RFF, sigma_x: float, generator: torch.Generator,
                    num_samples: int = 200_000) -> torch.Tensor:
    """Monte-Carlo estimate of ``R_zz`` (the closed form's check); the
    draw comes from ``generator``, on the map's device."""
    x = sigma_x * torch.randn(num_samples, rff.input_dim, generator=generator,
                              dtype=rff.omega.dtype,
                              device=generator.device).to(rff.omega.device)
    z = rff_features(rff, x)
    return z.T @ z / num_samples


def theta_opt(rff: RFF, centers: torch.Tensor,
              coeffs: torch.Tensor) -> torch.Tensor:
    """Optimal solution, eq. (8) without the eta' term (large D):
    ``theta_opt ~= Z_C^T a`` with ``Z_C = [z(c_1); ...; z(c_M)]``."""
    return rff_features(rff, centers).T @ coeffs


def max_stable_mu(rzz: torch.Tensor) -> torch.Tensor:
    """Largest mean-convergent step: ``2 / lambda_max`` (Prop. 1.1)."""
    return 2.0 / torch.linalg.eigvalsh(rzz)[-1]


def steady_state_mse(rzz: torch.Tensor, mu: float,
                     sigma_eta: float) -> torch.Tensor:
    """Prop. 1.4's stationary point ``sigma_eta^2 (1 + mu tr(R) / 2)``."""
    return sigma_eta**2 * (1.0 + mu * torch.trace(rzz) / 2.0)


def mse_evolution(rzz: torch.Tensor, theta0_err_cov: torch.Tensor, mu: float,
                  sigma_eta: float, num_steps: int) -> torch.Tensor:
    """Iterate Prop. 1.4's recursion; returns ``J_n (num_steps,)`` with
    ``J_n = tr(R A_n) + sigma_eta^2``."""
    a = theta0_err_cov
    js = []
    for _ in range(num_steps):
        js.append(torch.trace(rzz @ a) + sigma_eta**2)
        a = a - mu * (rzz @ a + a @ rzz) + mu**2 * sigma_eta**2 * rzz
    return torch.stack(js) if js else rzz.new_zeros((0,))
