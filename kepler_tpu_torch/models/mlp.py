"""MLP power estimator.

Architecture ``F → H → H → Z`` with GELU plus a wide linear skip path
(``w_skip``), as ``kepler_tpu.models.mlp``. The port computes it in f32
with TF32 off (``device.resolve_device`` pins that): the JAX package
serves f32 compute off the TPU, and bf16 trunks are a TPU throughput
feature. GELU is the tanh approximation, which is ``jax.nn.gelu``'s
default.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from kepler_tpu_torch.models.features import NUM_FEATURES
from kepler_tpu_torch.models.nn import glorot

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
) -> torch.Tensor:
    """→ watts f32 [..., W, Z]: GELU trunk plus the f32 linear skip path;
    ``clamp`` floors at 0 W for serving."""
    h = F.gelu(features @ params["w0"] + params["b0"], approximate="tanh")
    h = F.gelu(h @ params["w1"] + params["b1"], approximate="tanh")
    watts = h @ params["w2"]
    watts = watts + features @ params["w_skip"]
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

    def forward(self, features: torch.Tensor,
                workload_valid: torch.Tensor) -> torch.Tensor:
        return predict_mlp({k: getattr(self, k) for k in PARAM_KEYS},
                           features, workload_valid)
