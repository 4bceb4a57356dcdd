"""The hi/lo split of an f32 gradient into a bf16 pair: its CUDA kernel
and its plain version.

A half-operand product's backward (``models.nn.HalfProduct``) feeds the
incoming f32 gradient ``g`` [..., N] to the tensor cores as two bf16
halves, ``hi = bf16(g)`` and ``lo = bf16(g - hi)``, side by side in each
row of the pair [..., 2N], so that one product over 2N sums both in f32.
``g - hi`` is exact in f32, so ``hi + lo`` is ``g`` to 2⁻¹⁷ relative.

The kernel (``csrc/hi_lo.cu``, built and loaded by ``ops.build``) replaces
no TPU kernel: there the transpose of a dot with an f32 result takes the
f32 cotangent as it is, and the card's tensor cores take no f32 operand.
It reads ``g`` once and writes the pair once, 8 bytes an element, so HBM
bounds it. The plain version, which CPU tensors take, is two passes of
PyTorch's own with strided, mixed-dtype writes, about 2.8× the kernel's
time at the refits' shapes (``chip_smoke.py``'s ``hi_lo`` row).
``LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from kepler_tpu_torch.ops import build, recorder

# kernel launches since import (or since the caller last zeroed them)
LAUNCHES: dict[str, int] = {"hi_lo": 0}

_SOURCE = "hi_lo"


def _lib() -> ctypes.CDLL:
    lib = build.load(_SOURCE)
    if not getattr(lib, "_kt_bound", False):
        lib.kt_hi_lo.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_int64, ctypes.c_int64,
                                 ctypes.c_void_p]
        lib.kt_hi_lo.restype = ctypes.c_int
        lib._kt_bound = True
    return lib


def hi_lo_ref(g: torch.Tensor, half: torch.dtype) -> torch.Tensor:
    """The plain version: f32 ``g`` [..., N] → the pair [..., 2N] in
    ``half``, ``hi`` in the first N columns and ``lo`` in the last."""
    pair = torch.empty((*g.shape[:-1], 2, g.shape[-1]), dtype=half,
                       device=g.device)
    hi, lo = pair.unbind(-2)
    hi.copy_(g)
    torch.sub(g, hi, out=lo)
    return pair.flatten(-2)


@recorder.records_kernel("hi_lo")
def hi_lo(g: torch.Tensor, half: torch.dtype) -> torch.Tensor:
    """f32 ``g`` [..., N] → its pair [..., 2N] in ``half``: the kernel for
    a CUDA tensor at bf16, the plain version on the CPU."""
    if g.device.type == "cpu":
        return hi_lo_ref(g, half)
    if g.device.type != "cuda" or half != torch.bfloat16 \
            or g.dtype != torch.float32:
        raise ValueError(f"hi_lo takes f32 to bf16 on the card, not "
                         f"{g.dtype} to {half} on {g.device}")
    g = g.contiguous()
    if g.data_ptr() % 16:
        g = g.clone()  # the kernel loads four elements at once
    n = g.shape[-1]
    pair = torch.empty((*g.shape[:-1], 2 * n), dtype=half, device=g.device)
    total = g.numel()
    if total:
        lib = _lib()
        with torch.cuda.device(g.device):
            stream = torch.cuda.current_stream(g.device).cuda_stream
            rc = lib.kt_hi_lo(g.data_ptr(), pair.data_ptr(), total, n,
                              stream)
        if rc != 0:
            raise RuntimeError(f"CUDA kernel hi_lo failed to launch: "
                               f"cudaError {rc}")
        LAUNCHES["hi_lo"] += 1
    return pair
