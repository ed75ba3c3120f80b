"""Random Fourier feature maps (Rahimi & Recht), the paper's core device.

Counterpart of ``repro/core/rff.py``. Trig features: for the
Gaussian kernel ``exp(-||u - v||^2 / (2 sigma^2))``,
``omega ~ N(0, I_d / sigma^2)``, ``b ~ U[0, 2 pi]`` and

    z(x) = sqrt(2/D) cos(x @ omega + b),   z(x) . z(y) ~= kappa(x - y).

Positive random features (:func:`sample_prf`,
:func:`positive_random_features`) estimate the softmax kernel
``exp(q . k)``; the RFF linear-attention layer uses them.

Sampling draws from an explicit CPU ``torch.Generator`` and then moves the
parameters to ``device``, so a seed gives the same map on every device.
It does not reproduce ``repro``'s JAX PRNG stream: tests hand both
packages the same numbers through ``repro_torch.convert``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.kernels.ref import mc_scale, prf_root

__all__ = [
    "RFF",
    "sample_rff",
    "rff_features",
    "rff_features_unscaled",
    "kernel_estimate",
    "gaussian_kernel",
    "sample_prf",
    "positive_random_features",
    "softmax_kernel_estimate",
]


class RFF(NamedTuple):
    """Random-feature parameters: ``omega (d, D)``, ``bias (D,)``."""

    omega: torch.Tensor
    bias: torch.Tensor

    @property
    def input_dim(self) -> int:
        return self.omega.shape[0]

    @property
    def num_features(self) -> int:
        return self.omega.shape[1]

    def featurize(self, x: torch.Tensor) -> torch.Tensor:
        """:func:`rff_features` of ``x``."""
        return rff_features(self, x)


def sample_rff(
    generator: torch.Generator,
    input_dim: int,
    num_features: int,
    sigma: float,
    dtype: torch.dtype = torch.float32,
    orthogonal: bool = False,
    device="cuda",
) -> RFF:
    """Draw RFF parameters for the Gaussian kernel of bandwidth ``sigma``.

    ``orthogonal=True``: orthogonal random features (Yu et al. 2016) —
    blocks of up to ``input_dim`` spectral samples are orthogonalized (QR)
    and rescaled to chi(d) norms (the norm of a d-dim standard normal), so
    the marginals are unchanged and the kernel estimate's variance drops.
    """
    dev = resolve_device(device)
    bias = torch.rand(num_features, generator=generator, dtype=dtype)
    bias = bias * (2.0 * math.pi)
    if not orthogonal:
        omega = torch.randn(
            input_dim, num_features, generator=generator, dtype=dtype
        ) / sigma
        return RFF(omega=omega.to(dev), bias=bias.to(dev))
    omega = _orthogonal_omega(generator, input_dim, num_features, dtype)
    return RFF(omega=(omega / sigma).to(dev), bias=bias.to(dev))


def rff_features(rff: RFF, x: torch.Tensor) -> torch.Tensor:
    """``z(x) = sqrt(2/D) cos(x @ omega + b)`` — paper eq. (3)."""
    proj = x @ rff.omega + rff.bias
    return mc_scale(rff.num_features) * torch.cos(proj)


def rff_features_unscaled(rff: RFF, x: torch.Tensor) -> torch.Tensor:
    """``sqrt(2) cos(x @ omega + b)`` — the per-feature form of Theorem 1
    (``sqrt(2)`` rounded once to the working dtype, as ``repro``'s)."""
    proj = x @ rff.omega + rff.bias
    root2 = torch.tensor(math.sqrt(2.0), dtype=proj.dtype, device=proj.device)
    return root2 * torch.cos(proj)


def kernel_estimate(rff: RFF, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Monte-Carlo kernel estimate ``z(x) . z(y)`` — paper eq. (4)."""
    zx = rff_features(rff, x)
    zy = zx if y is x else rff_features(rff, y)
    return torch.sum(zx * zy, dim=-1)


def gaussian_kernel(x: torch.Tensor, y: torch.Tensor, sigma: float):
    """Exact Gaussian kernel ``exp(-||x - y||^2 / (2 sigma^2))``."""
    sq = torch.sum(torch.square(x - y), dim=-1)
    return torch.exp(-sq / (2.0 * sigma**2))


def _orthogonal_omega(generator, input_dim, num_features, dtype):
    """Blocks of up to ``input_dim`` orthogonalized (QR) Gaussian columns,
    rescaled to chi(d) norms (the norm of a d-dim standard normal), drawn
    on the generator's device."""
    n_blocks = -(-num_features // input_dim)
    blocks = []
    for _ in range(n_blocks):
        g = torch.randn(input_dim, input_dim, generator=generator, dtype=dtype,
                        device=generator.device)
        q, _ = torch.linalg.qr(g)
        blocks.append(q)
    omega = torch.cat(blocks, dim=1)[:, :num_features]
    norms = torch.linalg.vector_norm(
        torch.randn(num_features, input_dim, generator=generator, dtype=dtype,
                    device=generator.device),
        dim=1,
    )
    return omega * norms[None, :]


def sample_prf(
    generator: torch.Generator,
    input_dim: int,
    num_features: int,
    dtype: torch.dtype = torch.float32,
    orthogonal: bool = True,
    device="cuda",
) -> RFF:
    """Projections for positive random features of ``exp(q . k)``.

    Columns are standard Gaussian; ``orthogonal=True`` orthogonalizes
    blocks of up to ``input_dim`` columns and rescales them to chi(d)
    norms, which lowers the estimator's variance. The bias is zero (PRF has
    no phase). The draws are made on ``generator``'s device.
    """
    dev = resolve_device(device)
    if orthogonal:
        omega = _orthogonal_omega(generator, input_dim, num_features, dtype)
    else:
        omega = torch.randn(input_dim, num_features, generator=generator,
                            dtype=dtype, device=generator.device)
    return RFF(omega=omega.to(dev),
               bias=torch.zeros(num_features, dtype=dtype, device=dev))


def positive_random_features(rff: RFF, x: torch.Tensor,
                             eps: float = 1e-6) -> torch.Tensor:
    """``phi(x) = exp(x @ omega - ||x||^2 / 2) / sqrt(D) + eps``, so that
    ``phi(q) . phi(k) ~= exp(q . k)`` in expectation.

    No per-vector max shift: a shift that differs between two keys would
    bias their attention-weight ratio and break the prefill/decode state
    contract. The attention layer pre-scales inputs by ``dh ** -0.25``.
    """
    proj = x @ rff.omega
    stab = proj - torch.sum(torch.square(x), dim=-1, keepdim=True) / 2.0
    return torch.exp(stab) / prf_root(rff.num_features, proj.device) + eps


def softmax_kernel_estimate(rff: RFF, q: torch.Tensor,
                            k: torch.Tensor) -> torch.Tensor:
    """Estimate of ``exp(q . k)`` (relative weights)."""
    pq = positive_random_features(rff, q)
    pk = positive_random_features(rff, k)
    return torch.sum(pq * pk, dim=-1)
