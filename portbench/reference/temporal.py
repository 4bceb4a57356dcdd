"""The temporal power estimator's served output, plainly.

The estimator (``models/temporal.py`` of the port, ``kepler_tpu``'s
before it) reads each workload's last T feature rows, oldest first,
valid from the front (``t_valid``):

    x   = feat · W_in + pos[t]            (zero at invalid ticks)
    y   = LN1(x); k, v = y · W_k, y · W_v     (H heads of D/H)
    q   = LN1(x)[last] · W_q              (last = the last valid tick)
    a   = softmax over valid ticks ≤ last of q·k / √(D/H), then · v
    h   = x[last] + a · W_o;  h += GELU(LN2(h) · W_0 + b_0) · W_1 + b_1
    out = LN_f(h) · W_head + feat[last] · W_skip + b_head, floored at 0

Layer norms use the population variance and ε = 1e-6; GELU is the tanh
form. Every product's operands go through ``rnd`` (the stated
``compute_dtype``), sums in f32; the head and the skip path are f32. A
window with no valid tick attends to nothing.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.precision import Rounding

LN_EPS = 1e-6
N_HEADS = 4


def layer_norm(x: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + LN_EPS) * scale + bias


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    c = math.sqrt(2.0 / math.pi)
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x ** 3)))


def watts(p: dict[str, torch.Tensor],
          feat: torch.Tensor,  # [B, T, F]
          t_valid: torch.Tensor,  # bool [B, T]
          valid: torch.Tensor,  # bool [B]
          rnd: Rounding) -> torch.Tensor:
    """→ watts [B, Z] of each sequence (0 for invalid workloads)."""
    b, t, _ = feat.shape
    d = p["in_proj"].shape[1]
    dh = d // N_HEADS

    def mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return rnd(a) @ rnd(w)

    x = mm(feat, p["in_proj"]) + p["pos_emb"][:t]
    x = torch.where(t_valid[..., None], x, 0.0)
    last = (t_valid.sum(dim=-1) - 1).clamp(min=0)
    rows = torch.arange(b, device=feat.device)
    y = layer_norm(x, p["ln1_scale"], p["ln1_bias"])
    q = mm(y[rows, last], p["wq"]).reshape(b, N_HEADS, dh)
    k = mm(y, p["wk"]).reshape(b, t, N_HEADS, dh)
    v = mm(y, p["wv"]).reshape(b, t, N_HEADS, dh)
    scores = torch.einsum("bhd,bthd->bht", rnd(q), rnd(k)) / math.sqrt(dh)
    seen = t_valid & (torch.arange(t, device=feat.device)[None] <= last[:, None])
    scores = torch.where(seen[:, None, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(t_valid.any(dim=-1)[:, None, None], probs, 0.0)
    attn = torch.einsum("bht,bthd->bhd", rnd(probs), rnd(v)).reshape(b, d)
    h = x[rows, last] + mm(attn, p["wo"])
    z = gelu_tanh(mm(layer_norm(h, p["ln2_scale"], p["ln2_bias"]),
                     p["w_mlp0"]) + p["b_mlp0"])
    h = h + mm(z, p["w_mlp1"]) + p["b_mlp1"]
    h = layer_norm(h, p["ln_f_scale"], p["ln_f_bias"])
    out = h @ p["w_head"] + feat[rows, last] @ p["w_skip"] + p["b_head"]
    return torch.where(valid[:, None], out.clamp(min=0.0), 0.0)
