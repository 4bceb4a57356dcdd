"""Learned power estimators (linear, MLP, temporal) and their parameter
files, under the JAX package's import names."""

from kepler_tpu_torch.models.estimator import (
    LINEAR,
    MLP,
    RATIO,
    TEMPORAL,
    initializer,
    predictor,
)
from kepler_tpu_torch.models.features import NUM_FEATURES, build_features
from kepler_tpu_torch.models.linear import init_linear, predict_linear
from kepler_tpu_torch.models.mlp import init_mlp, predict_mlp
from kepler_tpu_torch.models.temporal import (
    TemporalEstimator,
    init_temporal,
    predict_temporal,
)

__all__ = [
    "LINEAR",
    "MLP",
    "NUM_FEATURES",
    "RATIO",
    "TEMPORAL",
    "TemporalEstimator",
    "build_features",
    "init_linear",
    "init_mlp",
    "init_temporal",
    "initializer",
    "predict_linear",
    "predict_mlp",
    "predict_temporal",
    "predictor",
]
