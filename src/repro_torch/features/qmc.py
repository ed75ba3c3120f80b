"""Quasi-Monte-Carlo trig features: Halton points through the Gaussian
inverse CDF.

Counterpart of ``repro/features/qmc.py``. The first ``m = D/2`` points of
the d-dimensional Halton sequence go through the inverse Gaussian CDF to
give spectral nodes ``omega_j ~ N(0, I / sigma^2)``, and the map is the
cos/sin pair

    z(x) = sqrt(1/m) [cos(Omega^T x); sin(Omega^T x)],

written in the affine-trig form with ``W = [Omega, Omega]``, ``b = [0,
-pi/2]`` and the uniform scale ``sqrt(1/m)`` (``sin(t) = cos(t - pi/2)``),
so the CUDA kernels run it unchanged. The nodes are built on the host in
float64 numpy, as ``repro`` builds them, and cast once: the parameters are
``repro``'s bit for bit, whatever the device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.features.base import FeatureMap, TrigFeatures, trig_map

__all__ = ["qmc_map", "halton_sequence", "inverse_normal_cdf"]


def _first_primes(n: int) -> list[int]:
    """The first ``n`` primes (Halton bases), by trial division."""
    primes: list[int] = []
    candidate = 2
    while len(primes) < n:
        if all(candidate % p for p in primes):
            primes.append(candidate)
        candidate += 1
    return primes


def _radical_inverse(indices: np.ndarray, base: int) -> np.ndarray:
    """van der Corput radical inverse of ``indices`` in ``base`` (float64)."""
    idx = indices.astype(np.int64).copy()
    result = np.zeros(idx.shape, np.float64)
    frac = 1.0 / base
    while np.any(idx > 0):
        result += (idx % base) * frac
        idx //= base
        frac /= base
    return result


def halton_sequence(num_points: int, dims: int, skip: int = 1) -> np.ndarray:
    """The first ``num_points`` d-dimensional Halton points, ``(n, dims)``
    in (0, 1). ``skip=1`` drops the index-0 point (all zeros, which the
    inverse CDF would map to -inf)."""
    indices = np.arange(skip, skip + num_points)
    cols = [_radical_inverse(indices, p) for p in _first_primes(dims)]
    return np.stack(cols, axis=-1)


# Acklam's rational approximation of the inverse normal CDF, refined with
# one Halley step against math.erf, in host float64 (repro's constants).
_A = (-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
      1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00)
_B = (-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
      6.680131188771972e+01, -1.328068155288572e+01)
_C = (-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
      -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00)
_D = (7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
      3.754408661907416e+00)


def inverse_normal_cdf(p: np.ndarray) -> np.ndarray:
    """Vectorized standard-normal quantile function on (0, 1), float64."""
    p = np.asarray(p, np.float64)
    q = np.where(p < 0.5, p, 1.0 - p)  # the lower half (x <= 0)

    low = q < 0.02425
    r = np.sqrt(-2.0 * np.log(np.where(low, q, 0.5)))
    tail = (((((_C[0] * r + _C[1]) * r + _C[2]) * r + _C[3]) * r + _C[4]) * r
            + _C[5]) / ((((_D[0] * r + _D[1]) * r + _D[2]) * r + _D[3]) * r
                        + 1.0)
    s = np.where(low, 0.5, q) - 0.5
    t = s * s
    central = (((((_A[0] * t + _A[1]) * t + _A[2]) * t + _A[3]) * t + _A[4])
               * t + _A[5]) * s / (((((_B[0] * t + _B[1]) * t + _B[2]) * t
                                     + _B[3]) * t + _B[4]) * t + 1.0)
    x = np.where(low, tail, central)

    # One Halley step: e = Phi(x) - q, u = e sqrt(2 pi) exp(x^2 / 2).
    erf = np.vectorize(math.erf, otypes=[np.float64])
    e = 0.5 * (1.0 + erf(x / math.sqrt(2.0))) - q
    u = e * math.sqrt(2.0 * math.pi) * np.exp(0.5 * x * x)
    x = x - u / (1.0 + 0.5 * x * u)
    return np.where(p < 0.5, x, -x)


def pair_trig(omega_t: np.ndarray, scale: np.ndarray, dtype,
              device) -> TrigFeatures:
    """The cos/sin pair of nodes ``omega_t (m, d)`` (float64) as affine-trig
    parameters: ``W = [Omega, Omega]``, ``b = [0, -pi/2]`` (``-pi/2``
    rounded once to ``dtype``, as ``repro``'s ``jnp.full``), per-feature
    ``scale (2m,)``; every float64 value is rounded once to ``dtype``."""
    m = omega_t.shape[0]
    omega = np.concatenate([omega_t.T, omega_t.T], axis=1)
    bias = torch.cat([torch.zeros(m, dtype=dtype),
                      torch.full((m,), -float(np.pi / 2.0), dtype=dtype)])
    return TrigFeatures(
        omega=torch.from_numpy(omega).to(dtype),
        bias=bias,
        scale=torch.as_tensor(scale, dtype=torch.float64).to(dtype),
    ).to(resolve_device(device))


def qmc_map(input_dim: int, num_features: int, sigma: float,
            dtype=torch.float32, device="cuda") -> FeatureMap:
    """Deterministic QMC feature map for ``exp(-||u||^2 / (2 sigma^2))``.

    ``num_features`` must be even (cos/sin pairs). No random generator:
    two constructions with the same arguments are bitwise identical, on
    any device. The scale is ``float((1/m) ** 0.5)`` rounded once to
    ``dtype`` (``repro``'s), not the Monte-Carlo ``sqrt(2/D)``.
    """
    if num_features % 2:
        raise ValueError(
            f"qmc num_features must be even (cos/sin pairs), got {num_features}"
        )
    m = num_features // 2
    omega_t = inverse_normal_cdf(halton_sequence(m, input_dim)) / sigma
    scale = np.full((num_features,), float((1.0 / m) ** 0.5))
    return trig_map("qmc", pair_trig(omega_t, scale, dtype, device),
                    deterministic=True)
