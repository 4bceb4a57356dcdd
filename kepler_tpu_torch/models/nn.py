"""Shared NN building blocks for the estimator families.

One definition of weight init, layer norm and the half-operand matmul, as
``kepler_tpu.models.nn``, so the families cannot drift apart on fan
conventions, epsilons or where half precision enters.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Iterator

import torch
import torch.nn.functional as F

from kepler_tpu_torch.ops import gelu_operand as boundary
from kepler_tpu_torch.ops.attention import round_to
from kepler_tpu_torch.ops.hi_lo import hi_lo

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


def _cuda_product(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x @ y`` of half tensors (2-D, or 3-D with one batch axis) on
    tensor cores with an f32 accumulator and an f32 result."""
    if x.dim() == 2:
        return torch.mm(x, y, out_dtype=torch.float32)
    return torch.bmm(x, y, out_dtype=torch.float32)


def _gradient_product(mul: Callable, x: torch.Tensor,
                      y: torch.Tensor) -> torch.Tensor:
    """``mul(x, y)`` of ``x`` [..., K, M] and ``y`` [..., M, N], the
    gradient of a product's right operand, which contracts the M rows
    of its left one. A batched product loops over a matrix's M in one
    thread block, unsplit: where M outnumbers the matrices (a mixture's
    experts over millions of rows), a few dozen blocks hold the card,
    and on tensor cores the f32 accumulator drifts with the loop's
    length (3.0% of the norm at [8, 4.9 M] × [4.9 M, 128 · 8] on an
    H100, against 4.4e-4 as 2-D products). There each matrix is its own
    2-D product, which cuBLAS splits along M."""
    if x.dim() == 2 or x.shape[-1] <= x.shape[0]:
        return mul(x, y)
    return torch.stack([mul(a, b) for a, b in zip(x, y)])


_CPU_PRODUCTS: list[torch.library.Library] = []  # registered once


def _register_cpu_products() -> None:
    """CPU kernels for ``aten::mm.dtype`` and ``aten::bmm.dtype``, which
    the CPU backend lacks: the f32 product of the half operands' values
    (exact products, f32 sums), as the card's tensor cores give it. Each
    call dispatches as one ``mm`` or ``bmm``, as on the card."""
    if _CPU_PRODUCTS or torch._C._dispatch_has_kernel_for_dispatch_key(
            "aten::mm.dtype", "CPU"):
        return
    lib = torch.library.Library("aten", "IMPL")
    for name, op in (("mm", torch.mm), ("bmm", torch.bmm)):
        lib.impl(f"{name}.dtype",
                 lambda a, b, out_dtype, op=op: op(a.to(out_dtype),
                                                   b.to(out_dtype)),
                 "CPU")
    _CPU_PRODUCTS.append(lib)


class HalfProduct(torch.autograd.Function):
    """``a @ b`` on half operands with an f32 result: ``a`` [..., M, K]
    and ``b`` [..., K, N] (2-D, or 3-D with one batch axis), each cast
    once to ``half`` and saved so for the backward. Every product is
    ``_cuda_product``: half operands, f32 accumulator, f32 result. The
    backward feeds the incoming f32 gradient ``g`` as its hi/lo pair
    (``ops.hi_lo``: ``[hi | lo]`` [..., M, 2N]), so no product rounds
    ``g``. For M ≥ N, ``g @ bᵀ`` is ``[hi | lo] @ [bᵀ; bᵀ]``, one product
    over 2N, and ``aᵀ @ g`` is ``aᵀ @ [hi | lo]`` with its two halves
    summed in f32; for M < N the pair is read as 2M rows (hi and lo of
    each row in turn), so ``g @ bᵀ`` gives 2M rows summed in pairs and
    ``aᵀ @ g`` takes each row of ``a`` twice. Either way the duplicated
    operand is the smaller one. ``b``'s gradient is taken by
    :func:`_gradient_product`. Each operand's gradient is then rounded
    to ``half`` and returned in its own dtype, as the backward of
    ``round_to`` does.
    """

    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor,
                half: torch.dtype) -> torch.Tensor:
        a_h, b_h = a.to(half), b.to(half)
        ctx.save_for_backward(a_h, b_h)
        ctx.dtypes = (a.dtype, b.dtype)
        return _cuda_product(a_h, b_h)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> tuple:
        a_h, b_h = ctx.saved_tensors
        mul, half = _cuda_product, a_h.dtype
        *lead, m, n = g.shape
        k = a_h.shape[-1]
        pair = hi_lo(g, half)  # [..., M, 2N]: hi | lo
        grad_a = grad_b = None
        if m >= n:
            if ctx.needs_input_grad[0]:
                bt = b_h.transpose(-1, -2)
                grad_a = mul(pair, torch.cat((bt, bt), dim=-2)).to(half)
            if ctx.needs_input_grad[1]:
                halves = _gradient_product(mul, a_h.transpose(-1, -2), pair)
                grad_b = (halves[..., :n] + halves[..., n:]).to(half)
        else:
            rows = pair.view(*lead, 2 * m, n)  # row 2i hi[i], 2i + 1 lo[i]
            if ctx.needs_input_grad[0]:
                grad_a = mul(rows, b_h.transpose(-1, -2)).view(
                    *lead, m, 2, k).sum(dim=-2).to(half)
            if ctx.needs_input_grad[1]:
                a2 = a_h.unsqueeze(-2).expand(*lead, m, 2, k)
                grad_b = _gradient_product(
                    mul, a2.reshape(*lead, 2 * m, k).transpose(-1, -2),
                    rows).to(half)
        del pair  # before the f32 copies of the gradients
        if grad_a is not None:
            grad_a = grad_a.to(ctx.dtypes[0])
        if grad_b is not None:
            grad_b = grad_b.to(ctx.dtypes[1])
        return grad_a, grad_b, None


class BatchedProduct(torch.autograd.Function):
    """``a @ b`` of f32 ``a`` [E, M, K] and ``b`` [E, K, N] as one
    ``torch.bmm``, whose backward takes ``b``'s gradient by
    :func:`_gradient_product`: as E 2-D products ``a[e]ᵀ @ g[e]`` where
    M outnumbers the E matrices (≈ 150 ms a step as one batched product
    for each of the mixture's two 7-wide products at 4.9 M rows on an
    H100, ≈ 3-8 ms as 2-D ones). ``a``'s gradient stays one batched
    product, its contraction N wide."""

    @staticmethod
    def forward(ctx, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> tuple:
        a, b = ctx.saved_tensors
        grad_a = grad_b = None
        if ctx.needs_input_grad[0]:
            grad_a = torch.bmm(g, b.transpose(1, 2))
        if ctx.needs_input_grad[1]:
            grad_b = _gradient_product(torch.matmul, a.transpose(1, 2), g)
        return grad_a, grad_b


def half_product(a: torch.Tensor, b: torch.Tensor,
                 half: torch.dtype) -> torch.Tensor:
    """:class:`HalfProduct` of ``a`` [..., K] and ``b`` [K, N] (the
    leading axes of ``a`` flattened into M), or of ``a`` [E, M, K] and
    ``b`` [E, K, N] → f32 [..., N]."""
    if b.dim() == 2:
        out = HalfProduct.apply(a.reshape(-1, a.shape[-1]), b, half)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    return HalfProduct.apply(a, b, half)


#: the device types whose bf16 products take :class:`HalfProduct`: the
#: card's, and the CPU's under :func:`card_route`
_route_devices: tuple[str, ...] = ("cuda",)


@contextlib.contextmanager
def card_route(dev: torch.device) -> Iterator[None]:
    """Under it, bf16 products of tensors on ``dev`` take the card's
    route: :class:`HalfProduct`, with its products on the CPU kernels of
    ``aten::mm.dtype`` and ``aten::bmm.dtype`` registered here and the
    hi/lo split's plain version. On the card, nothing changes."""
    global _route_devices
    if dev.type == "cuda":
        yield
        return
    _register_cpu_products()
    saved = _route_devices
    _route_devices = (*saved, dev.type)
    try:
        yield
    finally:
        _route_devices = saved


def tensor_cores(x: torch.Tensor, compute_dtype: torch.dtype) -> bool:
    """Whether a product whose left operand is ``x`` [..., K], laid out
    as the product takes it, with ``compute_dtype`` operands runs
    :class:`HalfProduct` on tensor cores: bf16 on the card (or under
    :func:`card_route`), with K a multiple of 8. An f16 pair cannot carry
    an f32 gradient's exponent range; the CPU keeps the plain product,
    which the tests hold to the JAX package; and a K such as the 7
    features leaves bf16 rows that are not 16-byte aligned, whose weight
    gradient the card computes faster in f32."""
    return (x.device.type in _route_devices
            and compute_dtype == torch.bfloat16 and x.shape[-1] % 8 == 0)


def acc_matmul(a: torch.Tensor, b: torch.Tensor,
               compute_dtype: torch.dtype) -> torch.Tensor:
    """Half-operand, f32-accumulator matmul → f32: ``a`` [..., K] with
    ``b`` [K, N], or ``a`` [E, M, K] with ``b`` [E, K, N].

    The JAX package casts the operands to ``compute_dtype`` and pins an f32
    result (``preferred_element_type``). Two routes give that result:

    - on the card at bf16 (:func:`tensor_cores`), :class:`HalfProduct`:
      the operands cast once to bf16 and multiplied on tensor cores into
      f32; the backward carries the incoming gradient as a bf16 hi/lo
      pair, so it keeps 16 significant bits in every product, and rounds
      each operand's gradient to bf16 as ``round_to``'s backward does;
    - elsewhere (the CPU, f16, f32 accuracy mode, and a contracted
      width that is no multiple of 8, such as the 7 features), the
      plain product: the operands rounded to ``compute_dtype``
      (``round_to``, a no-op at f32) and multiplied as f32 (TF32 off:
      ``device``), a batched pair as :class:`BatchedProduct`.

    A product of two bf16 values is exact in f32, so the routes differ
    from each other and from the JAX result in summation order only.
    """
    if tensor_cores(a, compute_dtype) and (b.dim() == 2
                                           or a.dim() == b.dim() == 3):
        return half_product(a, b, compute_dtype)
    a, b = round_to(a, compute_dtype), round_to(b, compute_dtype)
    if a.dim() == b.dim() == 3:
        return BatchedProduct.apply(a, b)
    return torch.matmul(a, b)


class GeluOperand(torch.autograd.Function):
    """``bf16(tanh-GELU(z + bias))`` of f32 ``z`` [E, M, H] and ``bias``
    [E, H], in one pass each way (``ops.gelu_operand``). It saves ``z``
    and ``bias``, as many bytes as the unfused GELU's saved input. Its
    output is the bf16 operand that :class:`HalfProduct` saves as it is,
    so the incoming gradient is that product's bf16 operand gradient,
    and the backward returns ``z``'s and the bias's f32 gradients."""

    @staticmethod
    def forward(ctx, z: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(z, bias)
        return boundary.gelu_operand(z, bias)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> tuple:
        z, bias = ctx.saved_tensors
        return boundary.gelu_operand_backward(g, z, bias)


def gelu_operand(z: torch.Tensor, bias: torch.Tensor,
                 compute_dtype: torch.dtype) -> torch.Tensor:
    """A hidden layer's boundary: tanh-GELU of its f32 product ``z``
    plus its bias, as the next product's left operand. ``z`` [..., H]
    with ``bias`` [H], or the mixture's ``z`` [E, M, H] with a bias an
    expert, [E, H].

    Where the next product takes :class:`HalfProduct`
    (:func:`tensor_cores` of ``z``: the card at bf16, or the CPU under
    :func:`card_route`, over a width that is a multiple of 8) → the bf16
    operand that product casts to, by :class:`GeluOperand`, which saves
    nothing where no gradient is wanted. Elsewhere → the f32
    ``F.gelu(z + bias, approximate="tanh")`` that the plain route rounds.
    """
    per_expert = bias.dim() == 2
    if not tensor_cores(z, compute_dtype):
        return F.gelu(z + (bias[:, None, :] if per_expert else bias),
                      approximate="tanh")
    z3 = z if per_expert else z.reshape(1, -1, z.shape[-1])
    b2 = bias if per_expert else bias.reshape(1, -1)
    return GeluOperand.apply(z3, b2).reshape(z.shape)
