"""Deep residual power estimator (the pipeline-parallel model family).

As ``kepler_tpu.models.deep``: a stack of S identical pre-LN residual GELU
blocks between a feature embedding and a zone head, plus a wide f32 linear
path (``w_skip``) from the features. The blocks' products take operands
rounded to ``compute_dtype`` (bf16 by default) with f32 results
(``nn.acc_matmul``); layer norms, residuals, the head and the skip path
stay f32. GELU is the tanh approximation, ``jax.nn.gelu``'s default.

Parameters keep the JAX package's layout: ``blocks`` is a nested dict of
stacked ``[S, ...]`` tensors (not a ``ModuleList``), so ``.npz`` files
carry it as ``blocks/w0`` … in both packages.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from kepler_tpu_torch.models.features import NUM_FEATURES
from kepler_tpu_torch.models.nn import acc_matmul, glorot, layer_norm

# DeepParams / BlockParams keys, as the JAX package's TypedDicts name them
PARAM_KEYS = ("in_proj", "in_bias", "w_head", "b_head", "w_skip")
BLOCK_KEYS = ("ln_scale", "ln_bias", "w0", "b0", "w1", "b1")


def init_deep(n_zones: int, n_stages: int = 4, d_model: int = 128,
              n_features: int = NUM_FEATURES, *,
              generator: torch.Generator | None = None,
              device: str | torch.device = "cpu") -> dict[str, Any]:
    """→ params with the JAX initialiser's shapes and scales (its random
    bits differ): Glorot-normal projections, unit layer norms, zero
    biases, zero-initialised head and skip path."""
    d4 = 4 * d_model
    f32 = torch.float32
    in_proj = glorot((n_features, d_model), generator)
    w0 = glorot((n_stages, d_model, d4), generator)
    w1 = glorot((n_stages, d4, d_model), generator)
    blocks = {
        "ln_scale": torch.ones((n_stages, d_model), dtype=f32),
        "ln_bias": torch.zeros((n_stages, d_model), dtype=f32),
        "w0": w0, "b0": torch.zeros((n_stages, d4), dtype=f32),
        "w1": w1, "b1": torch.zeros((n_stages, d_model), dtype=f32),
    }
    return {
        "in_proj": in_proj.to(device),
        "in_bias": torch.zeros(d_model, dtype=f32, device=device),
        "blocks": {k: v.to(device) for k, v in blocks.items()},
        "w_head": torch.zeros((d_model, n_zones), dtype=f32, device=device),
        "b_head": torch.zeros(n_zones, dtype=f32, device=device),
        "w_skip": torch.zeros((n_features, n_zones), dtype=f32,
                              device=device),
    }


def block_fn(block: dict[str, torch.Tensor], x: torch.Tensor,
             compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """One residual block: x [.., D] → [.., D]. ``block`` has no stage
    axis: it is the uniform stage function a pipeline applies per
    device."""
    y = layer_norm(x, block["ln_scale"], block["ln_bias"])
    y = F.gelu(acc_matmul(y, block["w0"], compute_dtype) + block["b0"],
               approximate="tanh")
    return x + acc_matmul(y, block["w1"], compute_dtype) + block["b1"]


def embed(params: dict[str, Any], features: torch.Tensor,
          compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """[.., F] → [.., D]."""
    x = acc_matmul(features, params["in_proj"], compute_dtype)
    return x + params["in_bias"]


def head(params: dict[str, Any], x: torch.Tensor,
         workload_valid: torch.Tensor, clamp: bool = True,
         features: torch.Tensor | None = None) -> torch.Tensor:
    """[.., D] → watts [.., Z] in f32; ``features`` feeds the wide f32
    skip path."""
    watts = x @ params["w_head"] + params["b_head"]
    if features is not None:
        watts = watts + features.to(torch.float32) @ params["w_skip"]
    if clamp:
        watts = torch.clamp(watts, min=0.0)
    return torch.where(workload_valid[..., None], watts, 0.0)


def predict_deep(
    params: dict[str, Any],
    features: torch.Tensor,  # f32 [..., W, F]
    workload_valid: torch.Tensor,  # bool [..., W]
    clamp: bool = True,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """→ watts f32 [..., W, Z]: the block stack applied in order (the
    JAX package's ``lax.scan`` over the leading stage axis)."""
    x = embed(params, features, compute_dtype)
    blocks = params["blocks"]
    for s in range(blocks["w0"].shape[0]):
        x = block_fn({k: v[s] for k, v in blocks.items()}, x,
                     compute_dtype)
    return head(params, x, workload_valid, clamp, features=features)


class DeepEstimator(nn.Module):
    """The deep model as a module; ``forward`` is :func:`predict_deep`.
    The stacked block tensors are parameters named ``blocks_<key>``."""

    def __init__(self, params: dict[str, Any]) -> None:
        super().__init__()
        for k in PARAM_KEYS:
            self.register_parameter(
                k, nn.Parameter(params[k], requires_grad=False))
        for k in BLOCK_KEYS:
            self.register_parameter(
                f"blocks_{k}",
                nn.Parameter(params["blocks"][k], requires_grad=False))

    def params(self) -> dict[str, Any]:
        out: dict[str, Any] = {k: getattr(self, k) for k in PARAM_KEYS}
        out["blocks"] = {k: getattr(self, f"blocks_{k}")
                         for k in BLOCK_KEYS}
        return out

    def forward(self, features: torch.Tensor, workload_valid: torch.Tensor,
                compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        return predict_deep(self.params(), features, workload_valid,
                            compute_dtype=compute_dtype)
