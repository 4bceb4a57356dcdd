"""The hidden layer's boundary in one pass each way: the bias add, the
tanh GELU and the bf16 cast of the next product's operand, and their
backward. Its CUDA kernels and its plain version.

A hidden layer's f32 product ``z`` [E, M, H] (E = 1 but for the
mixture's experts) meets its bias [E, H], the tanh GELU and the bf16 cast
that the next half-operand product (``models.nn.HalfProduct``) takes of
its operand. ``kt_gelu_operand`` (``csrc/gelu_operand.cu``, built and
loaded by ``ops.build``) reads ``z`` once and writes ``h =
bf16(gelu(z + bias))`` once, 6 bytes an element, in PyTorch's own f32
formula and order. ``kt_gelu_operand_backward`` reads the bf16 operand
gradient ``g`` and ``z`` once and writes ``dz = f32(g) · gelu'(z + bias)``
once, 10 bytes an element, with the bias gradient from per-tile partial
sums summed in a fixed order (no atomics: it repeats bit for bit).
Unfused, the same boundary is three passes forward (the add, GELU, the
cast) and three backward (the gradient's f32 copy, GELU's backward, the
bias gradient's sum). Neither kernel replaces a TPU kernel: XLA fuses
these passes there.

The plain versions, which CPU tensors take, are those unfused passes.
``LAUNCHES`` counts each kernel's launches (the backward's call, which
launches the tile sums and their reduction, counts once).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from kepler_tpu_torch.ops import build, recorder

# kernel launches since import (or since the caller last zeroed them)
LAUNCHES: dict[str, int] = {"gelu_operand": 0, "gelu_operand_backward": 0}

_SOURCE = "gelu_operand"
_P, _I = ctypes.c_void_p, ctypes.c_int64


def _lib() -> ctypes.CDLL:
    lib = build.load(_SOURCE)
    if not getattr(lib, "_kt_bound", False):
        lib.kt_gelu_operand.argtypes = [_P, _P, _P, _I, _I, _I, _P]
        lib.kt_gelu_operand.restype = ctypes.c_int
        lib.kt_gelu_operand_backward.argtypes = [_P, _P, _P, _P, _P, _P,
                                                 _I, _I, _I, _P]
        lib.kt_gelu_operand_backward.restype = ctypes.c_int
        lib.kt_gelu_operand_tiles.argtypes = [_I, _I]
        lib.kt_gelu_operand_tiles.restype = ctypes.c_int64
        lib._kt_bound = True
    return lib


def gelu_operand_ref(z: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The plain version: f32 ``z`` [E, M, H] and ``bias`` [E, H] → ``h``
    = bf16(tanh-GELU(z + bias)) [E, M, H]."""
    return F.gelu(z + bias[:, None, :], approximate="tanh").to(
        torch.bfloat16)


def gelu_operand_backward_ref(g: torch.Tensor, z: torch.Tensor,
                              bias: torch.Tensor
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the backward: bf16 ``g`` [E, M, H], f32 ``z``
    and ``bias`` [E, H] → (``dz`` [E, M, H], the bias gradient [E, H]),
    both f32."""
    dz = torch.ops.aten.gelu_backward(g.float(), z + bias[:, None, :],
                                      approximate="tanh")
    return dz, dz.sum(dim=1)


def _check(z: torch.Tensor, bias: torch.Tensor) -> None:
    if z.device.type != "cuda" or z.dtype != torch.float32 \
            or bias.dtype != torch.float32 or bias.device != z.device:
        raise ValueError(f"gelu_operand takes f32 on the card, not "
                         f"{z.dtype} on {z.device} with {bias.dtype} on "
                         f"{bias.device}")
    if z.dim() != 3 or bias.shape != (z.shape[0], z.shape[2]) \
            or z.shape[2] % 8:
        raise ValueError(f"gelu_operand takes z [E, M, H] with H % 8 == 0 "
                         f"and bias [E, H], not {tuple(z.shape)} and "
                         f"{tuple(bias.shape)}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte address: the kernels load 16 bytes at
    once."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")


@recorder.records_kernel("gelu_operand")
def gelu_operand(z: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """f32 ``z`` [E, M, H] and ``bias`` [E, H] → ``h`` bf16 [E, M, H]:
    the kernel for CUDA tensors, the plain version on the CPU."""
    if z.device.type == "cpu":
        return gelu_operand_ref(z, bias)
    _check(z, bias)
    z, bias = _aligned(z), _aligned(bias)
    e, m, h = z.shape
    out = torch.empty(z.shape, dtype=torch.bfloat16, device=z.device)
    if z.numel():
        with torch.cuda.device(z.device):
            stream = torch.cuda.current_stream(z.device).cuda_stream
            rc = _lib().kt_gelu_operand(z.data_ptr(), bias.data_ptr(),
                                        out.data_ptr(), e, m, h, stream)
        _raise_on(rc, "gelu_operand")
        LAUNCHES["gelu_operand"] += 1
    return out


@recorder.records_kernel("gelu_operand_backward")
def gelu_operand_backward(g: torch.Tensor, z: torch.Tensor,
                          bias: torch.Tensor
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """bf16 ``g`` [E, M, H], f32 ``z`` and ``bias`` [E, H] → (``dz``, the
    bias gradient), both f32: the kernels for CUDA tensors, the plain
    version on the CPU."""
    if z.device.type == "cpu":
        return gelu_operand_backward_ref(g, z, bias)
    _check(z, bias)
    if g.dtype != torch.bfloat16 or g.shape != z.shape \
            or g.device != z.device:
        raise ValueError(f"gelu_operand_backward takes a bf16 gradient of "
                         f"z's shape {tuple(z.shape)}, not {g.dtype} "
                         f"{tuple(g.shape)} on {g.device}")
    g, z, bias = _aligned(g), _aligned(z), _aligned(bias)
    e, m, h = z.shape
    dz = torch.empty_like(z)
    if not z.numel():
        return dz, torch.zeros_like(bias)
    lib = _lib()
    tiles = lib.kt_gelu_operand_tiles(m, h)
    if tiles <= 0:
        raise ValueError(f"gelu_operand_backward: no tiling for "
                         f"{tuple(z.shape)}")
    partial = torch.empty((e, tiles, h), dtype=torch.float32,
                          device=z.device)
    dbias = torch.empty_like(bias)
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        rc = lib.kt_gelu_operand_backward(
            g.data_ptr(), z.data_ptr(), bias.data_ptr(), dz.data_ptr(),
            partial.data_ptr(), dbias.data_ptr(), e, m, h, stream)
    _raise_on(rc, "gelu_operand_backward")
    LAUNCHES["gelu_operand_backward"] += 1
    return dz, dbias
