"""Shared NN building blocks for the estimator families.

One definition of weight init, layer norm and the half-operand matmul, as
``kepler_tpu.models.nn``, so the families cannot drift apart on fan
conventions, epsilons or where half precision enters.
"""

from __future__ import annotations

import math

import torch

from kepler_tpu_torch.ops.attention import round_to

LN_EPS = 1e-6


def glorot(shape: tuple[int, ...],
           generator: torch.Generator | None = None,
           device: str | torch.device = "cpu") -> torch.Tensor:
    """Glorot-normal over the LAST two dims (leading dims = stacked experts
    or stages, which share the per-matrix fan)."""
    scale = math.sqrt(2.0 / (shape[-2] + shape[-1]))
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=device) * scale


def layer_norm(x: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """Layer norm over the last axis with the POPULATION variance (as
    ``jnp.var``; ``torch.var`` defaults to the unbiased one)."""
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + LN_EPS) * scale + bias


def acc_matmul(a: torch.Tensor, b: torch.Tensor,
               compute_dtype: torch.dtype) -> torch.Tensor:
    """Half-operand, f32-accumulator matmul → f32.

    The JAX package casts the operands to ``compute_dtype`` and pins an f32
    result (``preferred_element_type``). ``torch.matmul`` on bf16 tensors
    would round the result to bf16 instead, so the operands are rounded to
    ``compute_dtype`` and multiplied as f32 (TF32 off: ``device``). A
    product of two bf16 values is exact in f32, so only the summation
    order can differ from the JAX result.
    """
    return torch.matmul(round_to(a, compute_dtype),
                        round_to(b, compute_dtype))
