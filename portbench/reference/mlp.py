"""The MLP estimator, plainly: its start, forward, loss and gradient.

The estimator (kepler-model-server's MLP, ``models/mlp.py`` of the
port): ``F → H → H → Z`` with tanh-GELU after the first two products
and a linear skip path, ``watts = GELU(GELU(x·W0 + b0)·W1 + b1)·W2 +
x·W_skip + b2``. The three trunk products round their operands with
``rnd`` (the stated ``compute_dtype``) and sum in f32; the skip path is
f32. The loss is the mean squared error in watts over the labelled
(workload, zone) entries, on the unclamped output.

The refit's start (``cmd.train``): a CPU ``torch.Generator`` seeded with
the job's seed draws W0 then W1, Glorot-normal (N(0, 2 / (fan_in +
fan_out))); every other leaf starts at zero. The refit steps it with
``adamw`` (``refit_mlp`` is the family's entry).
"""

from __future__ import annotations

import math
from typing import Mapping

import torch

from portbench.reference.adamw import Params
from portbench.reference.precision import Rounding, exact_f32
from portbench.reference.temporal import gelu_tanh

# rows a block of the loss and its gradient takes at a time: the
# reference's memory, not its result (the blocks' sums add up)
BLOCK_ROWS = 4096


def init(seed: int, n_zones: int, hidden: int, n_features: int) -> Params:
    """The refit's starting params (CPU, f32) for ``seed``."""
    gen = torch.Generator().manual_seed(seed)

    def glorot(shape: tuple[int, int]) -> torch.Tensor:
        return (torch.randn(shape, generator=gen, dtype=torch.float32)
                * math.sqrt(2.0 / (shape[0] + shape[1])))

    w0 = glorot((n_features, hidden))
    w1 = glorot((hidden, hidden))
    zeros = torch.zeros
    return {"w0": w0, "b0": zeros(hidden), "w1": w1, "b1": zeros(hidden),
            "w2": zeros((hidden, n_zones)), "b2": zeros(n_zones),
            "w_skip": zeros((n_features, n_zones))}


def forward(p: Mapping[str, torch.Tensor], x: torch.Tensor,
            rnd: Rounding) -> torch.Tensor:
    """Unclamped watts [..., Z] of feature rows ``x`` [..., F]."""
    h = gelu_tanh(rnd(x) @ rnd(p["w0"]) + p["b0"])
    h = gelu_tanh(rnd(h) @ rnd(p["w1"]) + p["b1"])
    return rnd(h) @ rnd(p["w2"]) + x @ p["w_skip"] + p["b2"]


def loss_and_grad(p: Params, feats: torch.Tensor,  # [R, W, F]
                  valid: torch.Tensor,  # bool [R, W]
                  targets: torch.Tensor,  # [R, W, Z]
                  label_valid: torch.Tensor,  # bool [R, W, Z]
                  rnd: Rounding) -> tuple[float, Params]:
    """The masked MSE and its gradient over every row, ``BLOCK_ROWS``
    rows at a time (the blocks' sums add up to the whole batch's)."""
    mask = valid[..., None] & label_valid
    count = mask.sum().to(torch.float32).clamp(min=1.0)
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in p.items()}
    total = 0.0
    with exact_f32():
        for lo in range(0, feats.shape[0], BLOCK_ROWS):
            sl = slice(lo, lo + BLOCK_ROWS)
            err = (forward(leaves, feats[sl], rnd) - targets[sl]) ** 2
            part = torch.where(mask[sl], err, 0.0).sum() / count
            part.backward()
            total += float(part.detach())
    return total, {k: v.grad.detach() for k, v in leaves.items()}
