"""The mixture-of-experts family's plain refit, as the refit driver finds
it for a configuration whose ``model`` is ``moe`` (the three names
``refit_mlp`` sets out).

The estimator (the reference package's ``kepler_tpu/models/moe.py``,
``predict_moe`` with the learned gate: the dumps carry no node type):
E experts, each ``F → H → Z`` with tanh-GELU and a linear skip path,
mixed by a softmax gate. Per row ``x``::

    gates = softmax(x·W_g)
    y_e   = GELU(x·W0_e + b0_e)·W1_e + x·Wskip_e + b1_e
    watts = Σ_e gates_e · y_e

Each expert's two trunk products round their operands with ``rnd`` (the
stated ``compute_dtype``) and sum in f32; the gate, the skip path and the
combine are f32. The loss is the mean squared error in watts over the
labelled (workload, zone) entries; its gradient is autograd's over these
plain ops, with TF32 off. Departures from ``predict_moe``, all of them
the refit's: the loss reads the **unclamped** output (``cmd.train``'s
loss does, so that the serve-time floor cannot zero the gradients); the
rows are the labelled slots alone, gathered from the padded dumps (the
others add nothing to the loss or its gradient, so there is no ``valid``
mask on the output); and the combine is a plain sum over experts, in
expert order, where ``predict_moe`` contracts the expert axis in one
product.

The start is ``cmd.train``'s, ``init_moe``'s draws in its order from a
CPU ``torch.Generator`` seeded with the job's seed: Glorot-normal (N(0,
2 / (fan_in + fan_out)), the fans of the last two axes) ``gate_w`` [F, E]
then ``w0`` [E, F, H]; ``b0``, ``w1``, ``b1`` and ``w_skip`` start at
zero. E and H are the configuration's ``estimator``'s (``cmd.train``
builds ``init_moe``'s defaults, which the configuration states).
"""

from __future__ import annotations

import math
from typing import Any, Mapping

import torch

from portbench.reference import refit_mlp
from portbench.reference.adamw import Params
from portbench.reference.precision import Rounding, exact_f32
from portbench.reference.temporal import gelu_tanh

# rows a block of the loss and its gradient takes at a time: the
# reference's memory, not its result (each row's output reads only its
# own features, so the blocks' sums add up to the whole batch's)
BLOCK_ROWS = 65536

inputs = refit_mlp.inputs


def start(seed: int, config: Mapping[str, Any]) -> Params:
    """The refit's starting params (CPU, f32) for ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    est = config["estimator"]
    e, h, f = est["n_experts"], est["hidden"], est["n_features"]
    z = len(config["zones"])

    def glorot(shape: tuple[int, ...]) -> torch.Tensor:
        return (torch.randn(shape, generator=gen, dtype=torch.float32)
                * math.sqrt(2.0 / (shape[-2] + shape[-1])))

    gate_w = glorot((f, e))
    w0 = glorot((e, f, h))
    zeros = torch.zeros
    return {"gate_w": gate_w, "w0": w0, "b0": zeros((e, h)),
            "w1": zeros((e, h, z)), "b1": zeros((e, z)),
            "w_skip": zeros((e, f, z))}


def forward(p: Mapping[str, torch.Tensor], x: torch.Tensor,
            rnd: Rounding) -> torch.Tensor:
    """Unclamped watts [B, Z] of feature rows ``x`` [B, F]."""
    gates = torch.softmax(x @ p["gate_w"], dim=-1)
    out = torch.zeros((x.shape[0], p["b1"].shape[-1]), device=x.device)
    for e in range(p["w0"].shape[0]):
        h = gelu_tanh(rnd(x) @ rnd(p["w0"][e]) + p["b0"][e])
        y = rnd(h) @ rnd(p["w1"][e]) + x @ p["w_skip"][e] + p["b1"][e]
        out = out + gates[:, e:e + 1] * y
    return out


def loss_and_grad(p: Params, feats: torch.Tensor,  # [R, W, F]
                  valid: torch.Tensor,  # bool [R, W]
                  targets: torch.Tensor,  # [R, W, Z]
                  label_valid: torch.Tensor,  # bool [R, W, Z]
                  rnd: Rounding) -> tuple[float, Params]:
    """The masked MSE and its gradient over the labelled rows,
    ``BLOCK_ROWS`` rows at a time."""
    mask = valid[..., None] & label_valid
    count = mask.sum().to(torch.float32).clamp(min=1.0)
    keep = mask.any(-1)
    x, targets, mask = feats[keep], targets[keep], mask[keep]
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in p.items()}
    total = 0.0
    with exact_f32():
        for lo in range(0, x.shape[0], BLOCK_ROWS):
            sl = slice(lo, lo + BLOCK_ROWS)
            err = (forward(leaves, x[sl], rnd) - targets[sl]) ** 2
            part = torch.where(mask[sl], err, 0.0).sum() / count
            part.backward()
            total += float(part.detach())
    return total, {k: v.grad.detach() for k, v in leaves.items()}
