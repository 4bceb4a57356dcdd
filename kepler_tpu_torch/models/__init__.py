"""Learned power estimators (linear, MLP, MoE, deep, temporal), their
training and parameter files, under the JAX package's import names."""

from kepler_tpu_torch.models.checkpoint import TrainCheckpointer
from kepler_tpu_torch.models.deep import (DeepEstimator, init_deep,
                                          predict_deep)
from kepler_tpu_torch.models.estimator import (
    DEEP,
    LINEAR,
    MLP,
    MOE,
    RATIO,
    TEMPORAL,
    ModelEstimator,
    initializer,
    predictor,
)
from kepler_tpu_torch.models.features import NUM_FEATURES, build_features
from kepler_tpu_torch.models.linear import init_linear, predict_linear
from kepler_tpu_torch.models.mlp import init_mlp, predict_mlp
from kepler_tpu_torch.models.moe import MoEEstimator, init_moe, predict_moe
from kepler_tpu_torch.models.temporal import (
    TemporalEstimator,
    init_temporal,
    predict_temporal,
)
from kepler_tpu_torch.models.train import (
    TrainState,
    create_train_state,
    fit,
    make_optimizer,
    make_temporal_train_step,
    make_train_step,
    masked_mse,
)

__all__ = [
    "DEEP",
    "DeepEstimator",
    "LINEAR",
    "MLP",
    "MOE",
    "ModelEstimator",
    "MoEEstimator",
    "NUM_FEATURES",
    "RATIO",
    "TEMPORAL",
    "TemporalEstimator",
    "TrainCheckpointer",
    "TrainState",
    "build_features",
    "create_train_state",
    "fit",
    "init_deep",
    "init_linear",
    "init_mlp",
    "init_moe",
    "init_temporal",
    "initializer",
    "make_optimizer",
    "make_temporal_train_step",
    "make_train_step",
    "masked_mse",
    "predict_deep",
    "predict_linear",
    "predict_mlp",
    "predict_moe",
    "predict_temporal",
    "predictor",
]
