"""Temporal power estimator: causal attention over feature history.

As ``kepler_tpu.models.temporal``: the model conditions on a **history
window** of the last T ticks per workload (``monitor.history`` keeps the
window) and predicts the current tick's watts from the whole trajectory.

    [.., T, F] → in-proj F→D → +learned positional embedding
               → pre-LN causal self-attention (H heads) + residual
               → pre-LN GELU MLP (D→4D→D) + residual
               → LN → head D→Z on the LAST valid timestep → watts [.., Z]

Every product in the trunk takes operands rounded to ``compute_dtype``
(bf16 by default) with an f32 result (``nn.acc_matmul``); residuals,
biases and softmax stay f32. Dense serving (no ``attention_fn``) takes the
single-query fast path; ``attention_fn`` (``ops.cuda_attention.
pallas_attention_fn``, kernel B3) runs the full-sequence trunk. GELU is
the tanh approximation, ``jax.nn.gelu``'s default.

Both trunks open two telemetry spans (profiler ranges while a profiler
records, nested under the caller's: ``train.forward`` in a refit,
``fleet.estimator`` in the served window): ``temporal.ticks``, the work
done at every tick (in-projection, positions, LN1, the K and V
projections; the full trunk's q too), and ``temporal.attention``, the
attention over the window (the single-query path's query included).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from kepler_tpu_torch import telemetry
from kepler_tpu_torch.models.features import NUM_FEATURES
from kepler_tpu_torch.models.nn import (acc_matmul, gelu_operand, glorot,
                                        half_product, layer_norm,
                                        tensor_cores)
from kepler_tpu_torch.ops.attention import full_attention, round_to

# TemporalParams keys, as the JAX package's TypedDict names them
PARAM_KEYS = ("in_proj", "pos_emb", "ln1_scale", "ln1_bias", "wq", "wk",
              "wv", "wo", "ln2_scale", "ln2_bias", "w_mlp0", "b_mlp0",
              "w_mlp1", "b_mlp1", "ln_f_scale", "ln_f_bias", "w_head",
              "b_head", "w_skip")

N_HEADS = 4


def init_temporal(n_zones: int, d_model: int = 128, t_max: int = 128,
                  n_features: int = NUM_FEATURES, *,
                  generator: torch.Generator | None = None,
                  device: str | torch.device = "cpu"
                  ) -> dict[str, torch.Tensor]:
    """→ params with the JAX initialiser's shapes and scales (its random
    bits differ): Glorot-normal projections, N(0, 0.02²) positions, unit
    layer norms, zero biases, zero-initialised head and skip."""
    d4 = 4 * d_model
    f32 = torch.float32
    params = {
        "in_proj": glorot((n_features, d_model), generator),
        "pos_emb": torch.randn((t_max, d_model), generator=generator,
                               dtype=f32) * 0.02,
        "ln1_scale": torch.ones(d_model, dtype=f32),
        "ln1_bias": torch.zeros(d_model, dtype=f32),
        "wq": glorot((d_model, d_model), generator),
        "wk": glorot((d_model, d_model), generator),
        "wv": glorot((d_model, d_model), generator),
        "wo": glorot((d_model, d_model), generator),
        "ln2_scale": torch.ones(d_model, dtype=f32),
        "ln2_bias": torch.zeros(d_model, dtype=f32),
        "w_mlp0": glorot((d_model, d4), generator),
        "b_mlp0": torch.zeros(d4, dtype=f32),
        "w_mlp1": glorot((d4, d_model), generator),
        "b_mlp1": torch.zeros(d_model, dtype=f32),
        "ln_f_scale": torch.ones(d_model, dtype=f32),
        "ln_f_bias": torch.zeros(d_model, dtype=f32),
        "w_head": torch.zeros((d_model, n_zones), dtype=f32),
        "b_head": torch.zeros(n_zones, dtype=f32),
        "w_skip": torch.zeros((n_features, n_zones), dtype=f32),
    }
    return {k: v.to(device) for k, v in params.items()}


def _take_last(x: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """[B, T, C] at each row's position ``last`` [B] → [B, C]."""
    idx = last[:, None, None].expand(x.shape[0], 1, x.shape[2])
    return torch.gather(x, 1, idx)[:, 0]


def _embed(params: dict[str, torch.Tensor], feat_hist: torch.Tensor,
           t_valid: torch.Tensor, cd: torch.dtype, t0: int = 0
           ) -> torch.Tensor:
    """In-projection plus positions ``t0 … t0 + T - 1``, zeroed at
    invalid ticks → [B, T, D]."""
    t = feat_hist.shape[1]
    x = acc_matmul(feat_hist, params["in_proj"], cd)
    x = x + params["pos_emb"][t0:t0 + t]
    return torch.where(t_valid[..., None], x, 0.0)


def _mlp_block(params: dict[str, torch.Tensor], x: torch.Tensor,
               cd: torch.dtype) -> torch.Tensor:
    """Pre-LN GELU MLP with its residual."""
    y = layer_norm(x, params["ln2_scale"], params["ln2_bias"])
    y = gelu_operand(acc_matmul(y, params["w_mlp0"], cd), params["b_mlp0"],
                     cd)
    return x + acc_matmul(y, params["w_mlp1"], cd) + params["b_mlp1"]


def trunk_qkv(
    params: dict[str, torch.Tensor],
    feat_hist: torch.Tensor,  # f32 [B, T, F]
    t_valid: torch.Tensor,  # bool [B, T]
    compute_dtype: torch.dtype = torch.bfloat16,
    t0: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The trunk before attention → (residual x f32 [B, T, D], q, k, v
    f32 [B, T, H, D/H]): in-projection, positions, LN1 and the q/k/v
    projections. Every op is per timestep, so a block of ticks
    ``t0 … t0 + T - 1`` of a longer window runs alone."""
    b, t, _ = feat_hist.shape
    d = params["in_proj"].shape[1]
    h = N_HEADS
    cd = compute_dtype

    x = _embed(params, feat_hist, t_valid, cd, t0)
    y = layer_norm(x, params["ln1_scale"], params["ln1_bias"])
    q = acc_matmul(y, params["wq"], cd).reshape(b, t, h, d // h)
    k = acc_matmul(y, params["wk"], cd).reshape(b, t, h, d // h)
    v = acc_matmul(y, params["wv"], cd).reshape(b, t, h, d // h)
    return x, q, k, v


def trunk_out(
    params: dict[str, torch.Tensor],
    x: torch.Tensor,  # f32 [B, T, D], the residual of trunk_qkv
    attn: torch.Tensor,  # [B, T, H, D/H], attention's output
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """The trunk after attention → hidden states f32 [B, T, D]: the
    out-projection and its residual, the MLP block and LN_f, all per
    timestep."""
    b, t, d = x.shape
    cd = compute_dtype
    x = x + acc_matmul(attn.reshape(b, t, d), params["wo"], cd)
    x = _mlp_block(params, x, cd)
    return layer_norm(x, params["ln_f_scale"], params["ln_f_bias"])


def temporal_trunk(
    params: dict[str, torch.Tensor],
    feat_hist: torch.Tensor,  # f32 [B, T, F]
    t_valid: torch.Tensor,  # bool [B, T]
    attention_fn: Callable | None = None,  # (q, k, v, t_valid) → out
    compute_dtype: torch.dtype = torch.bfloat16,
) -> torch.Tensor:
    """Shared trunk → hidden states f32 [B, T, D]: :func:`trunk_qkv`,
    attention, :func:`trunk_out` over the whole window.

    ``attention_fn`` is the seam where kernel B3 (and the whole-tensor
    ring) plugs in; without it the trunk runs dense causal attention in
    plain PyTorch. The sequence-parallel programs call the two halves
    per shard instead (``parallel.sequence``).
    """
    with telemetry.span("temporal.ticks"):
        x, q, k, v = trunk_qkv(params, feat_hist, t_valid, compute_dtype)
    with telemetry.span("temporal.attention"):
        if attention_fn is None:
            attn = full_attention(q, k, v, causal=True, t_valid=t_valid,
                                  compute_dtype=compute_dtype)
        else:
            attn = attention_fn(q, k, v, t_valid)
    return trunk_out(params, x, attn, compute_dtype)


def _query_scores(q: torch.Tensor, k: torch.Tensor,
                  cd: torch.dtype) -> torch.Tensor:
    """q [B, H, Dh] · k [B, T, H, Dh] → unscaled scores [B, H, T].

    On tensor cores (``nn.tensor_cores``) K stays in its projection's
    layout [B, T, H·Dh] and meets q laid out block-diagonally, [H·Dh, H]
    with head h's query in rows h·Dh … (h+1)·Dh − 1 of column h: one
    product per sequence, whose other terms are exact zeros."""
    b, t, h, dh = k.shape
    keys = k.reshape(b, t, h * dh)
    if not tensor_cores(keys, cd):
        return torch.einsum("bhd,bthd->bht", round_to(q, cd),
                            round_to(k, cd))
    blocks = q.unsqueeze(2) * torch.eye(h, dtype=q.dtype,
                                        device=q.device)[:, :, None]
    scores = half_product(keys, blocks.reshape(b, h, h * dh).transpose(1, 2),
                          cd)
    return scores.transpose(1, 2)


def _weighted_values(probs: torch.Tensor, v: torch.Tensor,
                     cd: torch.dtype) -> torch.Tensor:
    """probs [B, H, T] × v [B, T, H, Dh] → attention's output [B, H·Dh].

    On tensor cores V stays in its projection's layout [B, T, H·Dh]:
    each head's weights meet every head's values in one product per
    sequence, and head h's output is the block of row h at columns
    h·Dh … (h+1)·Dh − 1."""
    b, t, h, dh = v.shape
    if not tensor_cores(probs, cd):  # K = T, the history's ticks
        return torch.einsum("bht,bthd->bhd", round_to(probs, cd),
                            round_to(v, cd)).reshape(b, h * dh)
    out = half_product(probs, v.reshape(b, t, h * dh), cd)
    return out.view(b, h, h, dh).diagonal(dim1=1, dim2=2).transpose(
        1, 2).reshape(b, h * dh)


def _last_query_trunk(
    params: dict[str, torch.Tensor],
    feat_hist: torch.Tensor,  # f32 [B, T, F]
    t_valid: torch.Tensor,  # bool [B, T]
    compute_dtype: torch.dtype,
) -> torch.Tensor:
    """Dense-serving fast path → pooled hidden f32 [B, D].

    Only the LAST valid timestep feeds the head, so the attention block
    needs one query row per sequence (K/V still span the window); the
    causal constraint ``position ≤ last`` keeps it the same math as
    ``temporal_trunk`` + gather on gapped ``t_valid`` masks too, as long
    as some valid tick lies at or before ``last`` (always, for the
    right-padded windows ``monitor.history`` gives; as in JAX, a window
    valid only after ``last`` spreads its attention evenly here).
    """
    b, t, _ = feat_hist.shape
    d = params["in_proj"].shape[1]
    h = N_HEADS
    dh = d // h
    cd = compute_dtype

    with telemetry.span("temporal.ticks"):
        x = _embed(params, feat_hist, t_valid, cd)
        y = layer_norm(x, params["ln1_scale"], params["ln1_bias"])
        k = acc_matmul(y, params["wk"], cd).reshape(b, t, h, dh)
        v = acc_matmul(y, params["wv"], cd).reshape(b, t, h, dh)

    with telemetry.span("temporal.attention"):
        last = torch.clamp(t_valid.sum(dim=-1) - 1, min=0)
        q = acc_matmul(_take_last(y, last), params["wq"],
                       cd).reshape(b, h, dh)
        scores = _query_scores(q, k, cd)
        scores = scores / torch.sqrt(torch.tensor(
            dh, dtype=torch.float32, device=scores.device))
        # finite mask value: an all-invalid window yields 0 attention,
        # not softmax(-inf…) = NaN
        causal = (torch.arange(t, device=last.device)[None, :]
                  <= last[:, None])
        scores = torch.where((t_valid & causal)[:, None, :], scores, -1e30)
        probs = torch.softmax(scores, dim=-1)
        any_valid = t_valid.any(dim=-1)
        probs = torch.where(any_valid[:, None, None], probs, 0.0)
        attn = _weighted_values(probs, v, cd)

    x_last = _take_last(x, last) + acc_matmul(attn, params["wo"], cd)
    x_last = _mlp_block(params, x_last, cd)
    return layer_norm(x_last, params["ln_f_scale"], params["ln_f_bias"])


def predict_temporal(
    params: dict[str, torch.Tensor],
    feat_hist: torch.Tensor,  # f32 [..., W, T, F]
    workload_valid: torch.Tensor,  # bool [..., W]
    t_valid: torch.Tensor | None = None,  # bool [..., W, T]
    clamp: bool = True,
    compute_dtype: torch.dtype = torch.bfloat16,
    attention_fn: Callable | None = None,
) -> torch.Tensor:
    """→ watts f32 [..., W, Z] predicted from each workload's history.

    Leading axes flatten into the attention batch; the LAST valid
    timestep's hidden state feeds the head (position 0 when the window is
    empty). Without ``attention_fn`` the single-query fast path serves;
    with one the full-sequence trunk runs through it.
    """
    lead = feat_hist.shape[:-2]
    t, f = feat_hist.shape[-2:]
    x = feat_hist.reshape(-1, t, f)
    tv = (torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
          if t_valid is None else t_valid.reshape(-1, t))
    last = torch.clamp(tv.sum(dim=-1) - 1, min=0)
    if attention_fn is None:
        pooled = _last_query_trunk(params, x, tv, compute_dtype)
    else:
        hidden = temporal_trunk(params, x, tv, attention_fn=attention_fn,
                                compute_dtype=compute_dtype)
        pooled = _take_last(hidden, last)
    # wide-and-deep: the current (= last valid) tick's raw features carry
    # the first-order linear power signal in f32
    feat_last = _take_last(x, last)
    watts = (pooled @ params["w_head"]
             + feat_last.to(torch.float32) @ params["w_skip"]
             + params["b_head"])
    watts = watts.reshape(*lead, -1)
    if clamp:
        watts = torch.clamp(watts, min=0.0)
    return torch.where(workload_valid[..., None], watts, 0.0)


class TemporalEstimator(nn.Module):
    """The temporal model as a module; ``forward`` is
    :func:`predict_temporal` on the dense-serving fast path."""

    def __init__(self, params: dict[str, torch.Tensor]) -> None:
        super().__init__()
        for k in PARAM_KEYS:
            self.register_parameter(
                k, nn.Parameter(params[k], requires_grad=False))

    def forward(self, feat_hist: torch.Tensor, workload_valid: torch.Tensor,
                t_valid: torch.Tensor | None = None) -> torch.Tensor:
        return predict_temporal({k: getattr(self, k) for k in PARAM_KEYS},
                                feat_hist, workload_valid, t_valid)
