"""The feature-map contract and the affine-trig form the kernels consume.

Counterpart of ``repro/features/base.py``. Every trig family reduces to

    z(x) = scale * cos(x @ omega + bias),   scale per feature (D,),

held as :class:`TrigFeatures`. A :class:`FeatureMap` wraps a family's
params with its pure ``featurize`` and ``weights`` functions, as
``repro``'s does: the Monte-Carlo families (``features/random.py``), qmc
(``features/qmc.py``), gq and taylor (``features/deterministic.py``).
Taylor has no affine-trig form; :func:`as_trig_or_none` returns None for
it and every bank tier routes on that.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional, Union

import torch

from repro_torch.kernels.ref import default_scale

__all__ = [
    "TrigFeatures",
    "FeatureMap",
    "FeatureLike",
    "trig_weights",
    "trig_map",
    "feature_weights",
    "uniform_trig_scale",
    "trig_from_rff",
    "trig_features",
    "featurize",
    "as_trig",
    "as_trig_or_none",
    "num_features",
    "input_dim",
    "feature_dtype",
    "feature_device",
    "map_to",
]


class TrigFeatures(NamedTuple):
    """Canonical affine-trig parameters: ``omega (d, D)``, ``bias (D,)``,
    ``scale (D,)``."""

    omega: torch.Tensor
    bias: torch.Tensor
    scale: torch.Tensor

    @property
    def input_dim(self) -> int:
        return self.omega.shape[0]

    @property
    def num_features(self) -> int:
        return self.omega.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.omega.dtype

    @property
    def device(self) -> torch.device:
        return self.omega.device

    def to(self, device) -> "TrigFeatures":
        """The same map with every tensor on ``device`` (contiguous)."""
        return TrigFeatures(
            *(t.to(device).contiguous() for t in (self.omega, self.bias,
                                                  self.scale))
        )


def trig_weights(params: TrigFeatures) -> torch.Tensor:
    """Per-feature quadrature weights of a trig map: ``scale**2``.

    Module-level (not a closure), as in ``repro``: maps built the same way
    then carry the same ``weights_fn``."""
    return torch.square(params.scale)


@dataclass(frozen=True)
class FeatureMap:
    """A feature family behind one contract: params plus pure featurize.

    Attributes:
      family: registry name (``rff``, ``orf``, ``qmc``, ``gq``,
        ``taylor``).
      params: the family's parameters — :class:`TrigFeatures` for trig
        families; they expose ``num_features`` / ``input_dim`` / ``dtype``.
      featurize_fn: pure ``(params, x) -> (..., D)``.
      weights_fn: pure ``(params,) -> (D,)`` per-feature quadrature weights
        (``scale**2`` for trig families).
      deterministic: True when construction ignores the random generator
        (the zero-seed-variance families).
    """

    family: str
    params: Any
    featurize_fn: Callable[[Any, torch.Tensor], torch.Tensor]
    weights_fn: Callable[[Any], torch.Tensor]
    deterministic: bool

    @property
    def num_features(self) -> int:
        return self.params.num_features

    @property
    def input_dim(self) -> int:
        return self.params.input_dim

    @property
    def dtype(self) -> torch.dtype:
        return self.params.dtype

    @property
    def weights(self) -> torch.Tensor:
        """Per-feature quadrature weights ``a_i`` (``scale**2`` for trig)."""
        return self.weights_fn(self.params)

    @property
    def trig(self) -> Optional[TrigFeatures]:
        """The canonical affine-trig form, or None for non-trig families."""
        return self.params if isinstance(self.params, TrigFeatures) else None

    def featurize(self, x: torch.Tensor) -> torch.Tensor:
        return self.featurize_fn(self.params, x)

    def to(self, device) -> "FeatureMap":
        """The same map with its params on ``device`` (contiguous)."""
        return FeatureMap(self.family, self.params.to(device),
                          self.featurize_fn, self.weights_fn,
                          self.deterministic)


# The third kind is the paper's RFF draw (``core.rff.RFF``, a NamedTuple of
# ``omega`` and ``bias`` with a ``featurize`` method). It is recognised by
# those attributes: ``core``'s learners import this module, so it does not
# import ``core``.
FeatureLike = Union[FeatureMap, TrigFeatures, tuple]


def uniform_trig_scale(num_features: int, dtype=torch.float32,
                       device=None) -> torch.Tensor:
    """The Monte-Carlo ``sqrt(2/D)`` scale as a ``(D,)`` tensor, computed
    exactly like ``repro``'s (f32 ``2/D``, then an f32 root): for about 13%
    of D the f64 root cast to f32 differs by 1 ulp, and canonicalizing an
    :class:`RFF` must change nothing numerically."""
    return default_scale(num_features, dtype, device)


def trig_from_rff(rff) -> TrigFeatures:
    """Canonicalize the paper's RFF struct: uniform ``sqrt(2/D)`` scale."""
    return TrigFeatures(
        omega=rff.omega,
        bias=rff.bias,
        scale=uniform_trig_scale(
            rff.num_features, rff.omega.dtype, rff.omega.device
        ),
    )


def trig_features(tf: TrigFeatures, x: torch.Tensor) -> torch.Tensor:
    """``z(x) = scale * cos(x @ omega + bias)`` — inputs ``(..., d)``."""
    proj = x @ tf.omega + tf.bias
    return tf.scale.to(proj.dtype) * torch.cos(proj)


def trig_map(family: str, params: TrigFeatures,
             deterministic: bool) -> FeatureMap:
    """Wrap canonical trig params as a :class:`FeatureMap`."""
    return FeatureMap(family=family, params=params,
                      featurize_fn=trig_features, weights_fn=trig_weights,
                      deterministic=deterministic)


def featurize(fm: FeatureLike, x: torch.Tensor) -> torch.Tensor:
    """Family-agnostic feature map: ``(..., d) -> (..., D)``."""
    if isinstance(fm, TrigFeatures):
        return trig_features(fm, x)
    if hasattr(fm, "featurize"):  # a FeatureMap or an RFF draw
        return fm.featurize(x)
    raise TypeError(f"not a feature map: {type(fm).__name__}")


def as_trig_or_none(fm: FeatureLike) -> Optional[TrigFeatures]:
    """Canonical ``(W, b, scale)`` form, or None for a non-trig family
    (taylor)."""
    if isinstance(fm, TrigFeatures):
        return fm
    if isinstance(fm, FeatureMap):
        return fm.trig
    if hasattr(fm, "omega") and hasattr(fm, "bias"):  # an RFF draw
        return trig_from_rff(fm)
    raise TypeError(f"not a feature map: {type(fm).__name__}")


def as_trig(fm: FeatureLike) -> TrigFeatures:
    """Canonical trig form; raises for a family without one."""
    tf = as_trig_or_none(fm)
    if tf is None:
        family = fm.family if isinstance(fm, FeatureMap) else type(fm).__name__
        raise TypeError(
            f"feature family {family!r} has no affine-trig canonical form"
        )
    return tf


def feature_weights(fm: FeatureLike) -> torch.Tensor:
    """Per-feature quadrature weights ``a_i`` (``scale**2`` for trig maps)."""
    if isinstance(fm, FeatureMap):
        return fm.weights
    return torch.square(as_trig(fm).scale)


def num_features(fm: FeatureLike) -> int:
    return fm.num_features


def input_dim(fm: FeatureLike) -> int:
    return fm.input_dim


def feature_dtype(fm: FeatureLike) -> torch.dtype:
    """Working dtype of a feature map."""
    if isinstance(fm, FeatureMap):
        return fm.dtype
    return fm.omega.dtype


def feature_device(fm: FeatureLike) -> torch.device:
    """The device a feature map's parameters live on."""
    if isinstance(fm, FeatureMap):
        return fm.params.device
    return fm.omega.device


def map_to(fm: FeatureLike, device) -> FeatureLike:
    """``fm`` with its parameters on ``device``. A :class:`FeatureMap` or
    :class:`TrigFeatures` keeps its type; an RFF draw becomes its
    :class:`TrigFeatures` (the form the kernels take, the same numbers)."""
    if isinstance(fm, (FeatureMap, TrigFeatures)):
        return fm.to(device)
    return as_trig(fm).to(device)
