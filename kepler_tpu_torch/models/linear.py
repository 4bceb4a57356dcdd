"""Linear-regression power model.

``watts[W, Z] = relu(features[W, F] @ weight[F, Z] + bias[Z])`` — one
matmul; batched over nodes it is ``[N·W, F] @ [F, Z]``. Output is clamped
non-negative (power can't be negative) and masked rows predict zero.
Parameters are the JAX package's ``LinearParams`` keys (``weight``,
``bias``), so its ``.npz`` files load as they are.
"""

from __future__ import annotations

import torch
from torch import nn

from kepler_tpu_torch.models.features import NUM_FEATURES


def init_linear(n_zones: int, n_features: int = NUM_FEATURES, *,
                generator: torch.Generator | None = None,
                device: str | torch.device = "cpu"
                ) -> dict[str, torch.Tensor]:
    """→ params: small normal weights, zero bias."""
    weight = torch.randn((n_features, n_zones), generator=generator,
                         dtype=torch.float32) * 0.01
    return {"weight": weight.to(device),
            "bias": torch.zeros(n_zones, dtype=torch.float32,
                                device=device)}


def predict_linear(
    params: dict[str, torch.Tensor],
    features: torch.Tensor,  # [..., W, F]
    workload_valid: torch.Tensor,  # bool [..., W]
    clamp: bool = True,
) -> torch.Tensor:
    """→ watts f32 [..., W, Z]; ``clamp`` floors predictions at 0 W."""
    watts = features @ params["weight"] + params["bias"]
    if clamp:
        watts = torch.clamp(watts, min=0.0)
    return torch.where(workload_valid[..., None], watts, 0.0)


class LinearEstimator(nn.Module):
    """The linear model as a module; ``forward`` is :func:`predict_linear`."""

    def __init__(self, params: dict[str, torch.Tensor]) -> None:
        super().__init__()
        self.weight = nn.Parameter(params["weight"], requires_grad=False)
        self.bias = nn.Parameter(params["bias"], requires_grad=False)

    def forward(self, features: torch.Tensor,
                workload_valid: torch.Tensor) -> torch.Tensor:
        return predict_linear({"weight": self.weight, "bias": self.bias},
                              features, workload_valid)
