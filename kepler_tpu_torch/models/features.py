"""Feature engineering for learned power models.

The kepler-model-server predicts workload power from resource-usage
counters when RAPL isn't available (VMs, non-Intel nodes). The feature
pipeline is a pure function from per-workload cpu deltas (+ node context)
to a dense ``[W, F]`` matrix, so the model evaluation runs beside ratio
attribution in one window program.

Feature vector (F = 7), as in ``kepler_tpu.models.features``:
    0: cpu_time_delta       seconds of CPU in the window
    1: cpu_share            workload delta / node delta (the ratio feature)
    2: node_usage_ratio     broadcast node active/total ratio
    3: dt                   window length (s)
    4: cpu_rate             cpu_time_delta / dt (cores actively used)
    5: bias                 constant 1.0
    6: node_cpu_log         broadcast log1p(node cpu delta)
"""

from __future__ import annotations

import torch

from kepler_tpu_torch.ops.attribution import _workload_ratios

NUM_FEATURES = 7


def build_features(
    cpu_deltas: torch.Tensor,  # f32 [..., W]
    workload_valid: torch.Tensor,  # bool [..., W]
    node_cpu_delta: torch.Tensor,  # f32 [...]
    usage_ratio: torch.Tensor,  # f32 [...]
    dt_s: torch.Tensor,  # f32 [...]
) -> torch.Tensor:
    """→ f32 [..., W, F]; masked rows are all-zero (bias included)."""
    deltas = torch.where(workload_valid, cpu_deltas, 0.0)
    # the exact ratio the attribution uses — the model's share feature
    # must match the labels it is trained to reproduce
    share = _workload_ratios(cpu_deltas, workload_valid, node_cpu_delta)
    dt = torch.clamp(dt_s[..., None], min=1e-30)
    rate = torch.where(dt_s[..., None] > 0, deltas / dt, 0.0)
    w_shape = deltas.shape
    node_log = torch.log1p(torch.clamp(node_cpu_delta, min=0.0))
    feats = torch.stack(
        [
            deltas,
            share,
            usage_ratio[..., None].expand(w_shape),
            dt_s[..., None].expand(w_shape),
            rate,
            torch.ones_like(deltas),
            node_log[..., None].expand(w_shape),
        ],
        dim=-1,
    )
    return torch.where(workload_valid[..., None], feats, 0.0)
