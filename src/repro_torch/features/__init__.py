"""Feature maps: one contract, five families.

Counterpart of ``repro/features``. The learners see a :class:`FeatureMap`
(params plus a pure ``featurize`` and metadata); the CUDA kernels see its
affine-trig form ``(W, b, per-feature scale)`` through :func:`as_trig`.

====== ============= ====================================================
family construction  notes
====== ============= ====================================================
rff    Monte-Carlo   the paper's map (a ``torch.Generator`` draws it)
orf    Monte-Carlo   QR blocks with chi row norms
qmc    deterministic Halton points through the inverse Gaussian CDF
gq     deterministic Gauss-Hermite nodes and weights
taylor deterministic polynomial times a Gaussian envelope; no trig form
====== ============= ====================================================

:func:`make_feature_map` is the registry. The deterministic families are
built on the host in float64 numpy, as ``repro`` builds them, so their
parameters are ``repro``'s bit for bit and take no generator.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.features.base import (
    FeatureLike,
    FeatureMap,
    TrigFeatures,
    as_trig,
    as_trig_or_none,
    feature_device,
    feature_dtype,
    feature_weights,
    featurize,
    input_dim,
    map_to,
    num_features,
    trig_features,
    trig_from_rff,
    trig_map,
    trig_weights,
    uniform_trig_scale,
)
from repro_torch.features.deterministic import (
    TaylorParams,
    gq_map,
    taylor_features,
    taylor_map,
    taylor_num_features,
    taylor_weights,
)
from repro_torch.features.qmc import (
    halton_sequence,
    inverse_normal_cdf,
    qmc_map,
)
from repro_torch.features.random import orf_map, rff_map

__all__ = [
    "FAMILIES",
    "FeatureLike",
    "FeatureMap",
    "TrigFeatures",
    "TaylorParams",
    "as_trig",
    "as_trig_or_none",
    "feature_device",
    "feature_dtype",
    "feature_weights",
    "featurize",
    "gq_map",
    "halton_sequence",
    "input_dim",
    "inverse_normal_cdf",
    "make_feature_map",
    "map_to",
    "num_features",
    "orf_map",
    "qmc_map",
    "rff_map",
    "taylor_features",
    "taylor_map",
    "taylor_num_features",
    "taylor_weights",
    "trig_features",
    "trig_from_rff",
    "trig_map",
    "trig_weights",
    "uniform_trig_scale",
]

FAMILIES = ("rff", "orf", "qmc", "gq", "taylor")


def make_feature_map(family: str, input_dim: int, num_features: int,
                     sigma: float,
                     generator: Optional[torch.Generator] = None,
                     dtype=torch.float32, degree: Optional[int] = None,
                     device="cuda") -> FeatureMap:
    """Build a feature map by family name on ``device``.

    The Monte-Carlo families (``rff``, ``orf``) need ``generator`` (where
    ``repro`` takes a key) and raise without one; the deterministic
    families ignore it. ``taylor`` takes ``degree`` (by default the
    largest whose feature count fits ``num_features``), and its actual
    ``num_features`` is ``C(d + degree, degree)``.
    """
    if family in ("rff", "orf"):
        if generator is None:
            raise ValueError(
                f"family {family!r} is Monte-Carlo: pass generator=")
        builder = rff_map if family == "rff" else orf_map
        return builder(generator, input_dim, num_features, sigma, dtype,
                       device=device)
    if family == "qmc":
        return qmc_map(input_dim, num_features, sigma, dtype, device=device)
    if family == "gq":
        return gq_map(input_dim, num_features, sigma, dtype, device=device)
    if family == "taylor":
        if degree is None:
            degree = 1
            while taylor_num_features(input_dim, degree + 1) <= num_features:
                degree += 1
        return taylor_map(input_dim, degree, sigma, dtype, device=device)
    raise ValueError(f"unknown feature family {family!r}; know {FAMILIES}")
