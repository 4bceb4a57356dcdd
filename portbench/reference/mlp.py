"""The MLP estimator's refit, plainly: forward, loss, gradient, AdamW.

The estimator (kepler-model-server's MLP, ``models/mlp.py`` of the
port): ``F → H → H → Z`` with tanh-GELU after the first two products
and a linear skip path, ``watts = GELU(GELU(x·W0 + b0)·W1 + b1)·W2 +
x·W_skip + b2``. The three trunk products round their operands with
``rnd`` (the stated ``compute_dtype``) and sum in f32; the skip path is
f32. The loss is the mean squared error in watts over the labelled
(workload, zone) entries, on the unclamped output.

The refit's start (``cmd.train``): a CPU ``torch.Generator`` seeded with
the job's seed draws W0 then W1, Glorot-normal (N(0, 2 / (fan_in +
fan_out))); every other leaf starts at zero. The optimizer is AdamW
(Loshchilov & Hutter) with optax's defaults: β = (0.9, 0.999), ε = 1e-8,
decoupled weight decay on every leaf, biases included.
"""

from __future__ import annotations

import math
from typing import Mapping, NamedTuple

import torch

from portbench.reference.precision import Rounding, exact_f32
from portbench.reference.temporal import gelu_tanh

Params = dict[str, torch.Tensor]

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


class AdamW(NamedTuple):
    lr: float
    weight_decay: float = 1e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def step(self, p: Params, g: Params, m: Params, v: Params,
             t: int) -> None:
        """Step ``t`` (from 1) in place over every leaf."""
        for k in p:
            p[k] = p[k] * (1.0 - self.lr * self.weight_decay)
            m[k] = self.b1 * m[k] + (1.0 - self.b1) * g[k]
            v[k] = self.b2 * v[k] + (1.0 - self.b2) * g[k] ** 2
            m_hat = m[k] / (1.0 - self.b1 ** t)
            v_hat = v[k] / (1.0 - self.b2 ** t)
            p[k] = p[k] - self.lr * m_hat / (torch.sqrt(v_hat) + self.eps)


class Refit(NamedTuple):
    """The first steps of a refit: each step's loss and gradient (before
    it updates), the params it started from and those after the last."""

    losses: list[float]
    grads: list[Params]
    start: Params
    end: Params


def refit(start: Params, feats: torch.Tensor, valid: torch.Tensor,
          targets: torch.Tensor, label_valid: torch.Tensor,
          opt: AdamW, steps: int, rnd: Rounding) -> Refit:
    """``steps`` full-batch AdamW steps from ``start`` (moved to the
    data's device)."""
    dev = feats.device
    p = {k: v.to(dev) for k, v in start.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v = {k: torch.zeros_like(x) for k, x in p.items()}
    losses, grads = [], []
    for t in range(1, steps + 1):
        loss, g = loss_and_grad(p, feats, valid, targets, label_valid, rnd)
        losses.append(loss)
        grads.append(g)
        with torch.no_grad(), exact_f32():
            opt.step(p, g, m, v, t)
    return Refit(losses, grads, {k: x.to(dev) for k, x in start.items()}, p)


class Step(NamedTuple):
    """One step from a given state: its loss and gradient (before it
    updates) and the params after it."""

    loss: float
    grad: Params
    end: Params


def step_from(p: Params, m: Params, v: Params, t: int,
              feats: torch.Tensor, valid: torch.Tensor,
              targets: torch.Tensor, label_valid: torch.Tensor,
              opt: AdamW, rnd: Rounding) -> Step:
    """Step ``t`` (from 1) of a refit whose params were ``p`` and whose
    moments were ``m`` and ``v`` after step t − 1 (none is changed)."""
    p, m, v = dict(p), dict(m), dict(v)  # the step rebinds each leaf
    loss, g = loss_and_grad(p, feats, valid, targets, label_valid, rnd)
    with torch.no_grad(), exact_f32():
        opt.step(p, g, m, v, t)
    return Step(loss, g, p)
