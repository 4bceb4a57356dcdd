"""Mixture-of-experts power estimator (one expert per node type).

As ``kepler_tpu.models.moe``: a heterogeneous fleet needs a different
power model per platform, evaluated in one device program — a mixture of
experts. Expert ``e`` is the power model of node type ``e``; routing is
explicit (``expert_id``, the node's type) or learned from the features (a
softmax gate) when the type is unknown.

Each expert is a small ``F → H → Z`` GELU MLP plus a wide f32 linear path
(``w_skip``); expert weights stack on a leading ``E`` axis, so the whole
mixture is three batched products. The trunk's two products take operands
rounded to ``compute_dtype`` (bf16 by default) with f32 results
(``nn.acc_matmul``); the skip path (``acc_matmul`` at f32) and the gate
stay f32. GELU is the tanh approximation, ``jax.nn.gelu``'s default.
Parameters are a dict with the JAX package's keys and stacked ``[E, ...]``
tensors, so ``.npz`` files load across packages.

The mixture opens three telemetry spans (profiler ranges while a profiler
records, nested under the caller's: ``train.forward`` in a refit,
``fleet.estimator`` in the served window), one after another:
``moe.experts`` (:func:`expert_forward`, which the expert-parallel step
opens too), ``moe.gate`` (the router's logits and softmax, or the one-hot
of ``expert_id``) and ``moe.combine`` (the gate-weighted sum over
experts, the clamp and the mask).
"""

from __future__ import annotations

import torch
from torch import nn

from kepler_tpu_torch import telemetry
from kepler_tpu_torch.models.features import NUM_FEATURES
from kepler_tpu_torch.models.nn import acc_matmul, gelu_operand, glorot

# MoEParams keys, as the JAX package's TypedDict names them
PARAM_KEYS = ("gate_w", "w0", "b0", "w1", "b1", "w_skip")


def init_moe(n_zones: int, n_experts: int = 8, hidden: int = 128,
             n_features: int = NUM_FEATURES, *,
             generator: torch.Generator | None = None,
             device: str | torch.device = "cpu") -> dict[str, torch.Tensor]:
    """→ params with the JAX initialiser's shapes and scales (its random
    bits differ): Glorot-normal gate and first layer, zero-initialised
    output layer and skip path."""
    f32 = torch.float32
    params = {
        "gate_w": glorot((n_features, n_experts), generator),
        "w0": glorot((n_experts, n_features, hidden), generator),
        "b0": torch.zeros((n_experts, hidden), dtype=f32),
        "w1": torch.zeros((n_experts, hidden, n_zones), dtype=f32),
        "b1": torch.zeros((n_experts, n_zones), dtype=f32),
        "w_skip": torch.zeros((n_experts, n_features, n_zones), dtype=f32),
    }
    return {k: v.to(device) for k, v in params.items()}


def expert_forward(params: dict[str, torch.Tensor],
                   x: torch.Tensor,  # [E, C, F] rows grouped per expert
                   compute_dtype: torch.dtype = torch.bfloat16
                   ) -> torch.Tensor:
    """Batched per-expert MLP → f32 [E, C, Z]: the GELU trunk with
    ``compute_dtype`` operands, plus each expert's f32 linear path."""
    cd = compute_dtype
    with telemetry.span("moe.experts"):
        h = gelu_operand(acc_matmul(x, params["w0"], cd), params["b0"], cd)
        return (acc_matmul(h, params["w1"], cd)
                + acc_matmul(x.to(torch.float32), params["w_skip"],
                             torch.float32)
                + params["b1"][:, None, :])


def gate_logits(params: dict[str, torch.Tensor],
                features: torch.Tensor) -> torch.Tensor:
    """[..., F] → router logits [..., E] (f32: routing wants full
    precision)."""
    return features.to(torch.float32) @ params["gate_w"]


def predict_moe(
    params: dict[str, torch.Tensor],
    features: torch.Tensor,  # f32 [..., W, F]
    workload_valid: torch.Tensor,  # bool [..., W]
    clamp: bool = True,
    compute_dtype: torch.dtype = torch.bfloat16,
    expert_id: torch.Tensor | None = None,  # int [...] explicit node type
) -> torch.Tensor:
    """Dense MoE → watts f32 [..., W, Z].

    With ``expert_id`` (one type per node, broadcast over the workload
    axes) routing is a hard one-hot (an id outside ``[0, E)`` selects no
    expert, as ``jax.nn.one_hot``); otherwise the learned gate soft-mixes
    the experts. Every expert runs on every row.
    """
    lead = features.shape[:-1]
    x = features.reshape(1, -1, features.shape[-1])  # [1, N, F]
    e = params["w0"].shape[0]
    per_expert = expert_forward(params, x.expand(e, *x.shape[1:]),
                                compute_dtype)
    with telemetry.span("moe.gate"):
        if expert_id is not None:
            wl = features.ndim - expert_id.ndim - 1  # workload axes
            ids = expert_id.reshape(*expert_id.shape, *([1] * wl))
            gates = (ids[..., None] == torch.arange(e, device=ids.device)
                     ).to(torch.float32)
            gates = gates.expand(*lead, e)
        else:
            gates = torch.softmax(gate_logits(params, features), dim=-1)
    with telemetry.span("moe.combine"):
        # Σ_e gates_e · y_e as one broadcast product and a sum over E:
        # an einsum runs it as N batched [Z, E] · [E, 1] products
        weights = gates.reshape(-1, e).t()[..., None]  # [E, N, 1]
        watts = (per_expert * weights).sum(dim=0).reshape(*lead, -1)
        if clamp:
            watts = torch.clamp(watts, min=0.0)
        return torch.where(workload_valid[..., None], watts, 0.0)


class MoEEstimator(nn.Module):
    """The mixture as a module; ``forward`` is :func:`predict_moe`."""

    def __init__(self, params: dict[str, torch.Tensor]) -> None:
        super().__init__()
        for k in PARAM_KEYS:
            self.register_parameter(
                k, nn.Parameter(params[k], requires_grad=False))

    def forward(self, features: torch.Tensor, workload_valid: torch.Tensor,
                compute_dtype: torch.dtype = torch.bfloat16,
                expert_id: torch.Tensor | None = None) -> torch.Tensor:
        return predict_moe({k: getattr(self, k) for k in PARAM_KEYS},
                           features, workload_valid,
                           compute_dtype=compute_dtype, expert_id=expert_id)
