"""Feature maps: the contract and the affine-trig form (``base``) and the
Monte-Carlo families (``random``)."""
from repro_torch.features.base import (
    FeatureMap,
    TrigFeatures,
    as_trig,
    as_trig_or_none,
    feature_weights,
    featurize,
    trig_features,
    trig_map,
    trig_weights,
    uniform_trig_scale,
)
from repro_torch.features.random import orf_map, rff_map
