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


def lstsq_min_norm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Minimum-norm least squares ``a [.., R, F] x ≈ b [.., R, K]`` → x
    [.., F, K], batched over leading axes, as ``jnp.linalg.lstsq``: an SVD
    that drops singular values below ``eps(f32) · max(R, F) · s_max`` (and
    zeros). ``torch.linalg.lstsq`` on CUDA offers only the full-rank
    ``gels`` driver, and masked design matrices are rank-deficient by
    construction (a zone with no labels is an all-zero matrix; the bias
    column is a constant)."""
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    rcond = torch.finfo(a.dtype).eps * max(a.shape[-2], a.shape[-1])
    keep = (s > 0) & (s >= rcond * s[..., :1])
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, 1.0), 0.0)
    return vt.mT @ (s_inv[..., None] * (u.mT @ b))


def fit_linear_exact(
    features: torch.Tensor,  # [..., W, F]
    workload_valid: torch.Tensor,  # bool [..., W]
    target_watts: torch.Tensor,  # [..., W, Z]
    label_valid: torch.Tensor | None = None,  # bool [..., W, Z]
) -> dict[str, torch.Tensor]:
    """Closed-form masked least squares → the exact-optimum params.

    The design matrix is the flattened ``[R, F]`` features of every row,
    masked by ``workload_valid``. The bias column is feature 5 (constant
    1), so the learned bias lives inside ``weight`` and ``bias`` stays
    zero. With ``label_valid`` each zone's column solves against only its
    own labelled rows (one batched solve over zones).
    """
    f = features.shape[-1]
    z = target_watts.shape[-1]
    x = features.reshape(-1, f)
    y = target_watts.reshape(-1, z).to(x.dtype)
    m = workload_valid.reshape(-1).to(x.dtype)
    if label_valid is None:
        w = lstsq_min_norm(x * m[:, None], y * m[:, None])
    else:
        lm = label_valid.reshape(-1, z).to(x.dtype) * m[:, None]  # [R, Z]
        xz = x[None] * lm.mT[:, :, None]  # [Z, R, F]
        yz = (y * lm).mT[:, :, None]  # [Z, R, 1]
        w = lstsq_min_norm(xz, yz)[:, :, 0].mT  # [F, Z]
    return {"weight": w.to(torch.float32).contiguous(),
            "bias": torch.zeros(z, dtype=torch.float32, device=x.device)}


def predict_linear(
    params: dict[str, torch.Tensor],
    features: torch.Tensor,  # [..., W, F]
    workload_valid: torch.Tensor,  # bool [..., W]
    clamp: bool = True,
) -> torch.Tensor:
    """→ watts f32 [..., W, Z]; ``clamp`` floors predictions at 0 W
    (training passes ``clamp=False`` so gradients flow through negative
    raw outputs)."""
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
