"""Training for the learned power models.

As ``kepler_tpu.models.train``: the models train against RAPL-ratio
ground truth. On RAPL-capable nodes the ratio attribution gives
per-workload watts "labels"; the estimator learns to reproduce them from
features alone, then serves nodes without RAPL.

The step keeps the JAX package's functional signature, ``(state, features,
valid, targets, label_valid) → (state, loss)``, with plain autograd in
place of ``jax.value_and_grad`` (no kernel of the JAX package has a
backward, and its training reaches none). The loss is the masked MSE in
watts on the unclamped output. ``optax.adamw`` becomes
``torch.optim.AdamW`` with optax's defaults (betas 0.9/0.999, eps 1e-8)
over every leaf, biases included, as optax decays them all. Unlike the
JAX step, the PyTorch step updates the state's tensors in place: the state
it returns shares them with the one it was given.

Each step opens the telemetry spans ``train.step`` and, inside it,
``train.forward``, ``train.loss`` and ``train.backward`` (with remat the
recomputed forward falls under ``train.backward``; AdamW's step is
torch's own ``Optimizer.step#AdamW.step`` range): profiler ranges while a
profiler records, stage histograms where a recorder is installed,
nothing otherwise.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Mapping, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from kepler_tpu_torch import telemetry
from kepler_tpu_torch.models.estimator import map_params, param_leaves

Params = Any  # dict of tensors; deep's ``blocks`` one level nested
Optimizer = Callable[[list[torch.Tensor]], torch.optim.Optimizer]


class TrainState(NamedTuple):
    params: Params  # f32 leaves that require grad
    opt_state: torch.optim.Optimizer  # AdamW over every leaf
    step: int


def detached(params: Mapping[str, Any]) -> dict:
    """A state's params as plain tensors (no autograd), nesting kept."""
    return map_params(lambda v: v.detach(), params)


def masked_mse(
    pred_watts: torch.Tensor,  # [..., W, Z]
    target_watts: torch.Tensor,  # [..., W, Z]
    workload_valid: torch.Tensor,  # bool [..., W]
    label_valid: torch.Tensor | None = None,  # bool [..., W, Z]
) -> torch.Tensor:
    """``label_valid`` excludes zones a node never reported: the
    aggregator writes 0 W there (absence, not a measurement)."""
    err = (pred_watts - target_watts) ** 2
    mask = workload_valid[..., None].to(err.dtype)
    if label_valid is not None:
        mask = mask * label_valid.to(err.dtype)
    total = torch.sum(err * mask)
    count = torch.clamp(torch.sum(mask), min=1.0)
    return total / count


def masked_relative_mse(
    pred_watts: torch.Tensor,  # [..., W, Z]
    target_watts: torch.Tensor,  # [..., W, Z]
    workload_valid: torch.Tensor,  # bool [..., W]
    label_valid: torch.Tensor | None = None,  # bool [..., W, Z]
    floor_watts: float = 0.1,
) -> torch.Tensor:
    """MSE of (pred − target) / max(|target|, floor): the error relative
    to the ground truth, so small workloads count as much as big ones;
    below ``floor_watts`` errors count absolutely in floor units."""
    scale = torch.clamp(torch.abs(target_watts), min=floor_watts)
    err = ((pred_watts - target_watts) / scale) ** 2
    mask = workload_valid[..., None].to(err.dtype)
    if label_valid is not None:
        mask = mask * label_valid.to(err.dtype)
    total = torch.sum(err * mask)
    count = torch.clamp(torch.sum(mask), min=1.0)
    return total / count


def warm_start_wide(params: Params, features: torch.Tensor,
                    workload_valid: torch.Tensor, target_watts: torch.Tensor,
                    label_valid: torch.Tensor | None = None) -> Params:
    """Solve the wide path (``w_skip [F, Z]``) in closed form against the
    labels, so gradient training starts from the exact linear optimum and
    the trunk learns only the nonlinear correction (mlp, temporal — with
    the current tick's features — and deep)."""
    from kepler_tpu_torch.models.linear import fit_linear_exact

    sol = fit_linear_exact(features, workload_valid, target_watts,
                           label_valid)
    return {**params, "w_skip": sol["weight"]}


def warm_start_moe(params: Params, features: torch.Tensor,
                   workload_valid: torch.Tensor, target_watts: torch.Tensor,
                   expert_id: torch.Tensor) -> Params:
    """Per-expert closed-form warm start of the MoE's ``w_skip [E, F, Z]``:
    each expert solves against only the rows routed to it."""
    from kepler_tpu_torch.models.linear import fit_linear_exact

    n_experts = int(params["w0"].shape[0])
    sols = []
    for e in range(n_experts):
        mask = workload_valid & (expert_id == e)[..., None]
        sols.append(fit_linear_exact(features, mask, target_watts)["weight"])
    return {**params, "w_skip": torch.stack(sols)}


def make_optimizer(learning_rate: float = 1e-3,
                   weight_decay: float = 1e-4) -> Optimizer:
    """→ a factory of ``torch.optim.AdamW`` over a list of leaves, with
    ``optax.adamw``'s defaults."""
    return functools.partial(torch.optim.AdamW, lr=learning_rate,
                             betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def create_train_state(params: Params, optimizer: Optimizer) -> TrainState:
    """Own f32 copies of ``params`` that require grad, and the optimizer
    over them."""
    own = map_params(
        lambda v: v.detach().to(torch.float32).clone().requires_grad_(True),
        params)
    return TrainState(own, optimizer(param_leaves(own)), 0)


def _step(state: TrainState, forward: Callable[[Params], torch.Tensor],
          workload_valid: torch.Tensor, target_watts: torch.Tensor,
          label_valid: torch.Tensor | None
          ) -> tuple[TrainState, torch.Tensor]:
    """One AdamW step on the masked MSE of ``forward(params)`` → (state,
    detached loss)."""
    opt = state.opt_state
    with telemetry.span("train.step"):
        opt.zero_grad(set_to_none=True)
        with telemetry.span("train.forward"):
            pred = forward(state.params)
        with telemetry.span("train.loss"):
            loss = masked_mse(pred, target_watts, workload_valid,
                              label_valid)
        del pred  # the backward does not read it: free it before
        with telemetry.span("train.backward"):
            loss.backward()
        opt.step()
    return TrainState(state.params, opt, state.step + 1), loss.detach()


def make_train_step(predict_fn: Callable[..., torch.Tensor]) -> Callable:
    """→ ``(state, features, valid, targets, label_valid=None) → (state,
    loss)``. ``predict_fn`` must accept ``clamp=``: the loss runs on
    unclamped outputs so the serve-time floor cannot zero the gradients.
    The state carries its optimizer (``create_train_state``)."""

    def train_step(state: TrainState, features: torch.Tensor,
                   workload_valid: torch.Tensor, target_watts: torch.Tensor,
                   label_valid: torch.Tensor | None = None
                   ) -> tuple[TrainState, torch.Tensor]:
        return _step(state, lambda params: predict_fn(
            params, features, workload_valid, clamp=False),
            workload_valid, target_watts, label_valid)

    return train_step


def make_temporal_train_step(compute_dtype: torch.dtype | None = None,
                             attention_fn: Callable | None = None,
                             remat: bool = False) -> Callable:
    """Train step of the TEMPORAL estimator: ``(state, feat_hist [.., W,
    T, F], workload_valid [.., W], t_valid [.., W, T], target_watts [..,
    W, Z], label_valid=None) → (state, loss)``; the targets are the
    current tick's RAPL-ratio watts.

    ``compute_dtype`` defaults to bf16. ``attention_fn`` None takes the
    single-query path (as the JAX step does; no kernel). ``remat``
    recomputes the forward's activations in the backward
    (``torch.utils.checkpoint``, non-reentrant).
    """
    from kepler_tpu_torch.models.temporal import predict_temporal

    forward = functools.partial(
        predict_temporal, clamp=False,
        compute_dtype=torch.bfloat16 if compute_dtype is None
        else compute_dtype, attention_fn=attention_fn)
    run = (functools.partial(checkpoint, forward, use_reentrant=False)
           if remat else forward)

    def train_step(state: TrainState, feat_hist: torch.Tensor,
                   workload_valid: torch.Tensor, t_valid: torch.Tensor,
                   target_watts: torch.Tensor,
                   label_valid: torch.Tensor | None = None
                   ) -> tuple[TrainState, torch.Tensor]:
        return _step(state, lambda params: run(
            params, feat_hist, workload_valid, t_valid),
            workload_valid, target_watts, label_valid)

    return train_step


def fit(predict_fn: Callable, params: Params, features: torch.Tensor,
        workload_valid: torch.Tensor, target_watts: torch.Tensor,
        steps: int = 200, learning_rate: float = 1e-2
        ) -> tuple[Params, float]:
    """Small full-batch fit loop → (params, final loss)."""
    state = create_train_state(params, make_optimizer(learning_rate))
    step_fn = make_train_step(predict_fn)
    loss = torch.tensor(float("inf"))
    for _ in range(steps):
        state, loss = step_fn(state, features, workload_valid, target_watts)
    return detached(state.params), float(loss)
