"""The yardstick's frozen counts: the chip's peaks, the bytes a kernel
must move and the operations a model step needs, from shapes alone.

Peaks: NVIDIA's H100 SXM data sheet, dense rates at its 700 W limit.
A roofline share is the least time the chip could take (bytes over the
memory rate, or operations over their type's rate, whichever is larger)
over the measured time.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12


def b1_cost(n: int, w: int, z: int) -> tuple[int, int]:
    """Kernel B1 (``outer_product_attribution``: energy and power =
    share ⊗ active, over [N, W, Z]) → (bytes, f32 operations): the share
    plane and both zone planes read once, both outputs written once; one
    multiply an output."""
    return 4 * (n * w + 2 * n * z + 2 * n * w * z), 2 * n * w * z


def bound_s(nbytes: int, ops: int, ops_per_s: float = F32_FLOP_PER_S
            ) -> float:
    """The least seconds an H100 SXM takes to move ``nbytes`` and do
    ``ops`` operations at ``ops_per_s``."""
    return max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s)


def temporal_forward_flops(sequences: int, t: int, f: int, d: int,
                           mlp: int, z: int) -> int:
    """FLOPs (2 a multiply-add) of the temporal estimator's single-query
    forward over ``sequences`` windows of ``t`` ticks: the in-projection
    and K, V at every tick; q, the attention of the last tick over ``t``
    keys, W_o, the MLP (``d → mlp → d``), the head and the skip path once
    a sequence. Layer norms, softmax and GELU are not counted."""
    per_tick = 2 * (f * d + 2 * d * d)
    per_sequence = 2 * (2 * d * d + 2 * t * d + 2 * d * mlp + d * z + f * z)
    return sequences * (t * per_tick + per_sequence)


def mlp_train_flops(rows: int, f: int, h: int, z: int) -> int:
    """FLOPs of one full-batch step of the MLP estimator (``f → h → h →
    z`` plus the ``f → z`` skip path) over ``rows`` feature rows: the
    forward's four products, and the backward's gradient of every weight
    and of the activations of the two hidden layers (the features need
    none)."""
    forward = 2 * (f * h + h * h + h * z + f * z)
    backward = 2 * (f * h + 2 * h * h + 2 * h * z + f * z)
    return rows * (forward + backward)
