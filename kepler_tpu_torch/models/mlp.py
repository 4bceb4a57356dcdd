"""MLP power estimator.

Architecture ``F → H → H → Z`` with GELU plus a wide linear skip path
(``w_skip``), as ``kepler_tpu.models.mlp``. The trunk's three products
take operands rounded to ``compute_dtype`` (bf16 by default, as in JAX)
with f32 results (``nn.acc_matmul``); biases, GELU and the skip path stay
f32. The serial-rung fleet program serves this default unless accuracy
mode asks for f32 (``parallel.aggregator_core.accuracy_mode_predictor``);
the packed programs pass f32, as the JAX packed programs do off the TPU.
GELU is the tanh approximation, which is ``jax.nn.gelu``'s default.
"""

from __future__ import annotations

import torch
from torch import nn

from kepler_tpu_torch.models.features import NUM_FEATURES
from kepler_tpu_torch.models.nn import acc_matmul, gelu_operand, glorot

PARAM_KEYS = ("w0", "b0", "w1", "b1", "w2", "b2", "w_skip")


def init_mlp(n_zones: int, hidden: int = 128,
             n_features: int = NUM_FEATURES, *,
             generator: torch.Generator | None = None,
             device: str | torch.device = "cpu") -> dict[str, torch.Tensor]:
    """→ params: Glorot-normal trunk, zero-initialised output and skip
    (the JAX initialiser's shapes and scales; its random bits differ)."""
    z32 = torch.float32
    params = {
        "w0": glorot((n_features, hidden), generator),
        "b0": torch.zeros(hidden, dtype=z32),
        "w1": glorot((hidden, hidden), generator),
        "b1": torch.zeros(hidden, dtype=z32),
        "w2": torch.zeros((hidden, n_zones), dtype=z32),
        "b2": torch.zeros(n_zones, dtype=z32),
        "w_skip": torch.zeros((n_features, n_zones), dtype=z32),
    }
    return {k: v.to(device) for k, v in params.items()}


def predict_mlp(
    params: dict[str, torch.Tensor],
    features: torch.Tensor,  # [..., W, F]
    workload_valid: torch.Tensor,  # bool [..., W]
    clamp: bool = True,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """→ watts f32 [..., W, Z]: GELU trunk with ``compute_dtype``
    operands and f32 accumulators, plus the f32 linear skip path;
    ``clamp`` floors at 0 W for serving."""
    cd = compute_dtype
    h = gelu_operand(acc_matmul(features, params["w0"], cd), params["b0"],
                     cd)
    h = gelu_operand(acc_matmul(h, params["w1"], cd), params["b1"], cd)
    watts = acc_matmul(h, params["w2"], cd)
    watts = watts + features.to(torch.float32) @ params["w_skip"]
    watts = watts + params["b2"]
    if clamp:
        watts = torch.clamp(watts, min=0.0)
    return torch.where(workload_valid[..., None], watts, 0.0)


class MLPEstimator(nn.Module):
    """The MLP as a module; ``forward`` is :func:`predict_mlp`."""

    def __init__(self, params: dict[str, torch.Tensor]) -> None:
        super().__init__()
        for k in PARAM_KEYS:
            self.register_parameter(
                k, nn.Parameter(params[k], requires_grad=False))

    def forward(self, features: torch.Tensor, workload_valid: torch.Tensor,
                compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        return predict_mlp({k: getattr(self, k) for k in PARAM_KEYS},
                           features, workload_valid,
                           compute_dtype=compute_dtype)
