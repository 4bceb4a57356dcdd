"""Device resolution for the port's entry points.

The engines and program builders take an explicit ``device``. The
default is ``"cuda"``, and a missing CUDA device is an error, never a
silent move to the CPU: the CPU runs only when a caller passes
``device="cpu"`` (the tests do).

Numerics: the JAX package computes its estimators in f32 off the TPU
(``parallel/packed.py``), so the port keeps f32 matmuls in full f32 and
turns TF32 off for both matmuls and cuDNN.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """→ ``torch.device`` for ``device``; raises when it names CUDA and no
    CUDA device is present. Pins f32 matmul precision (TF32 off)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}: cuda or cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
