"""A full-batch refit with AdamW, plainly, for any estimator family.

``cmd.train`` steps every family with the same optimizer, so the loop
and AdamW live here and a family gives only its loss and gradient
(``loss_and_grad(params, *inputs, rnd) → (loss, grads)``, as
``reference/refit_<model>.py`` names it). AdamW (Loshchilov & Hutter)
with optax's defaults: β = (0.9, 0.999), ε = 1e-8, decoupled weight
decay on every leaf, biases included.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from portbench.reference.precision import Rounding, exact_f32

Params = dict[str, torch.Tensor]
LossAndGrad = Callable[..., tuple[float, Params]]


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


def refit(loss_and_grad: LossAndGrad, start: Params,
          inputs: tuple[torch.Tensor, ...], opt: AdamW, steps: int,
          rnd: Rounding) -> Refit:
    """``steps`` full-batch AdamW steps from ``start`` (moved to the
    inputs' device)."""
    dev = inputs[0].device
    p = {k: v.to(dev) for k, v in start.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v = {k: torch.zeros_like(x) for k, x in p.items()}
    losses, grads = [], []
    for t in range(1, steps + 1):
        loss, g = loss_and_grad(p, *inputs, rnd)
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


def step_from(loss_and_grad: LossAndGrad, p: Params, m: Params, v: Params,
              t: int, inputs: tuple[torch.Tensor, ...], opt: AdamW,
              rnd: Rounding) -> Step:
    """Step ``t`` (from 1) of a refit whose params were ``p`` and whose
    moments were ``m`` and ``v`` after step t − 1 (none is changed)."""
    p, m, v = dict(p), dict(m), dict(v)  # the step rebinds each leaf
    loss, g = loss_and_grad(p, *inputs, rnd)
    with torch.no_grad(), exact_f32():
        opt.step(p, g, m, v, t)
    return Step(loss, g, p)
