"""Roundings of a product's operands, by name.

A configuration states the precision of its products' operands
(``compute_dtype``); the reference rounds to it and multiplies in f32.
The control of a comparison rounds to the next precision below:
``bfloat16`` → ``float8_e4m3`` (scaled per tensor by its largest
magnitude, as fp8 training and serving scale), ``float32`` →
``bfloat16``. A rounding is an autograd function whose backward rounds
the gradient the same way, as a cast to a narrower dtype and back does.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator

import torch

Rounding = Callable[[torch.Tensor], torch.Tensor]

E4M3_MAX = 448.0


def _round_plain(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.to(dtype).to(torch.float32)


def _round_e4m3(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax()
    scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
    y = (x / scale).clamp(-E4M3_MAX, E4M3_MAX)
    return y.to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, fn: Callable) -> torch.Tensor:
        ctx.fn = fn
        return fn(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> tuple:
        return ctx.fn(g), None


def _differentiable(fn: Callable) -> Rounding:
    def rounding(x: torch.Tensor) -> torch.Tensor:
        if x.requires_grad and torch.is_grad_enabled():
            return _Round.apply(x, fn)
        return fn(x)

    return rounding


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


ROUNDINGS: dict[str, Rounding] = {
    "float32": _identity,
    "bfloat16": _differentiable(lambda x: _round_plain(x, torch.bfloat16)),
    "float8_e4m3": _differentiable(_round_e4m3),
}

# the control of each stated precision: the next one below it
BELOW = {"float32": "bfloat16", "bfloat16": "float8_e4m3"}


def rounding(name: str) -> Rounding:
    """The rounding of the precision ``name`` (a key of ``ROUNDINGS``)."""
    return ROUNDINGS[name]


@contextlib.contextmanager
def exact_f32() -> Iterator[None]:
    """f32 products in full f32: TF32 off for the block, as it was after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
