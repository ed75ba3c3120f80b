"""Deterministic feature maps: Gaussian-quadrature trig features and
Taylor-expansion polynomial features.

Counterpart of ``repro/features/deterministic.py``. Both are built on the
host in float64 numpy, exactly as ``repro`` builds them, and cast once, so
their parameters are ``repro``'s bit for bit and two constructions with
the same arguments are identical.

``gq_map``: a tensor-product Gauss-Hermite rule for Bochner's integral,
truncated to the ``m = D/2`` heaviest nodes (weights renormalized so the
estimate at lag 0 is 1), as cos/sin pairs whose per-feature scale is
``sqrt(a_j)``: the affine-trig form the CUDA kernels take.

``taylor_map``: ``phi_alpha(x) = exp(-||x||^2 / (2 sigma^2)) x^alpha /
sqrt(alpha! sigma^(2|alpha|))`` for ``|alpha| <= degree``. It has no
affine-trig form, so every bank tier runs it through the generic
``featurize`` route (plain PyTorch, as ``repro`` runs it through XLA).
"""
from __future__ import annotations

import itertools
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.features.base import FeatureMap, trig_map
from repro_torch.features.qmc import pair_trig

__all__ = [
    "gq_map",
    "taylor_map",
    "TaylorParams",
    "taylor_features",
    "taylor_num_features",
    "taylor_weights",
]

# The largest tensor grid enumerated on the host before truncating to the
# D/2 heaviest nodes (repro's cap).
_MAX_GRID = 1 << 21


def gq_map(input_dim: int, num_features: int, sigma: float,
           dtype=torch.float32, device="cuda") -> FeatureMap:
    """Deterministic Gauss-Hermite feature map for the Gaussian kernel.

    ``num_features`` must be even (cos/sin pairs). The order per dimension
    is the smallest ``n`` with ``n^d >= D/2``; a grid past ``_MAX_GRID``
    raises (use qmc, rff or orf for wide inputs).
    """
    if num_features % 2:
        raise ValueError(
            f"gq num_features must be even (cos/sin pairs), got {num_features}"
        )
    m = num_features // 2
    order = 1
    while order**input_dim < m:
        order += 1
        if order**input_dim > _MAX_GRID:
            raise ValueError(
                f"gq tensor grid for input_dim={input_dim} cannot reach "
                f"{m} nodes under the {_MAX_GRID}-point cap; use qmc/rff/orf "
                "for high-dimensional inputs"
            )
    # Physicists' Gauss-Hermite: omega = sqrt(2) t / sigma, a = w / sqrt(pi).
    nodes1, weights1 = np.polynomial.hermite.hermgauss(order)
    nodes1 = np.sqrt(2.0) * nodes1 / sigma
    weights1 = weights1 / np.sqrt(np.pi)

    grids = np.meshgrid(*([nodes1] * input_dim), indexing="ij")
    omega_all = np.stack([g.reshape(-1) for g in grids], axis=-1)  # (n^d, d)
    wgrids = np.meshgrid(*([weights1] * input_dim), indexing="ij")
    a_all = np.prod(np.stack([g.reshape(-1) for g in wgrids], -1), axis=-1)

    # The m heaviest nodes, ties in a stable order; renormalized to sum 1.
    keep = np.argsort(-a_all, kind="stable")[:m]
    a = a_all[keep]
    root_a = np.sqrt(a / np.sum(a))
    return trig_map("gq", pair_trig(omega_all[keep], np.concatenate(
        [root_a, root_a]), dtype, device), deterministic=True)


class TaylorParams(NamedTuple):
    """Taylor feature parameters, one row per multi-index alpha:
    ``exponents (D, d)`` int32, ``coeff (D,)`` =
    ``1 / sqrt(alpha! sigma^(2|alpha|))`` and ``inv_two_sigma_sq ()`` =
    ``1 / (2 sigma^2)``."""

    exponents: torch.Tensor
    coeff: torch.Tensor
    inv_two_sigma_sq: torch.Tensor

    @property
    def input_dim(self) -> int:
        return self.exponents.shape[1]

    @property
    def num_features(self) -> int:
        return self.exponents.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.coeff.dtype

    @property
    def device(self) -> torch.device:
        return self.coeff.device

    def to(self, device) -> "TaylorParams":
        """The same parameters on ``device`` (contiguous)."""
        return TaylorParams(*(t.to(device).contiguous() for t in self))


def taylor_features(params: TaylorParams, x: torch.Tensor) -> torch.Tensor:
    """``phi(x) = exp(-||x||^2 / 2 sigma^2) * coeff * x^alpha``, x (..., d)."""
    exps = params.exponents.to(x.dtype)
    monomials = torch.prod(x[..., None, :] ** exps, dim=-1)  # (..., D)
    envelope = torch.exp(
        -params.inv_two_sigma_sq.to(x.dtype)
        * torch.sum(torch.square(x), dim=-1, keepdim=True)
    )
    return params.coeff.to(x.dtype) * monomials * envelope


def taylor_weights(params: TaylorParams) -> torch.Tensor:
    """Per-feature expansion weights ``coeff**2`` (module-level, so maps
    built the same way carry the same ``weights_fn``)."""
    return torch.square(params.coeff)


def taylor_num_features(input_dim: int, degree: int) -> int:
    """Number of multi-indices with ``|alpha| <= degree``: C(d + r, r)."""
    return math.comb(input_dim + degree, degree)


def taylor_map(input_dim: int, degree: int, sigma: float,
               dtype=torch.float32, device="cuda") -> FeatureMap:
    """Deterministic Taylor feature map truncated at total ``degree``;
    ``num_features = C(d + degree, degree)``. Accuracy falls with
    ``||x|| / sigma``."""
    alphas = []
    for r in range(degree + 1):
        for combo in itertools.combinations_with_replacement(
            range(input_dim), r
        ):
            alpha = [0] * input_dim
            for i in combo:
                alpha[i] += 1
            alphas.append(alpha)
    exponents = np.asarray(alphas, np.int32)  # (D, d)
    orders = exponents.sum(axis=1)
    # alpha! as exact Python integers first: np.prod would fold them into
    # int64 and overflow past 20!.
    fact = np.array(
        [float(math.prod(math.factorial(int(e)) for e in row))
         for row in exponents],
        np.float64,
    )
    coeff = 1.0 / np.sqrt(fact * sigma ** (2.0 * orders))
    params = TaylorParams(
        exponents=torch.from_numpy(exponents),
        coeff=torch.from_numpy(coeff).to(dtype),
        inv_two_sigma_sq=torch.tensor(1.0 / (2.0 * sigma**2),
                                      dtype=torch.float64).to(dtype),
    ).to(resolve_device(device))
    return FeatureMap(family="taylor", params=params,
                      featurize_fn=taylor_features, weights_fn=taylor_weights,
                      deterministic=True)
