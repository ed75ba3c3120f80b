"""Monte-Carlo summaries of the online learners' learning curves.

Counterpart of ``repro/core/adaptive.py``. ``repro`` maps a realization
function over split PRNG keys; the port runs a figure's realizations as
one bank (``core/bank.py``), so :func:`monte_carlo_mse` takes their prior
errors ``(runs, n)`` and averages the squares over runs: the quantity
plotted in the paper's figures 1-3.
"""
from __future__ import annotations

import torch

__all__ = ["monte_carlo_mse", "ema"]


def monte_carlo_mse(errors: torch.Tensor) -> torch.Tensor:
    """The MSE learning curve ``(n,)``: the mean over runs of ``e_n^2``,
    from the prior errors ``(runs, n)`` of ``runs`` realizations."""
    return torch.mean(torch.square(errors), dim=0)


def ema(curve: torch.Tensor, alpha: float = 0.05) -> torch.Tensor:
    """Exponential smoothing ``m_n = (1 - alpha) m_{n-1} + alpha x_n`` from
    ``m_0 = x_0``, for readable learning-curve summaries (a host loop over
    the curve)."""
    out = torch.empty_like(curve)
    m = curve[0]
    for n, x in enumerate(curve):
        m = (1 - alpha) * m + alpha * x
        out[n] = m
    return out
