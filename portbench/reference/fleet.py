"""A mixed fleet's window, plainly: what the Aggregator publishes.

RAPL nodes (mode 0) publish Kepler's ratio split. Model nodes (mode 1)
have no meter: each workload publishes the estimator's watts (µW =
W · 1e6, energy = power · window seconds), and the node the sum of its
workloads'. The four published tensors are node power and energy
``[N, Z]`` and workload power and energy ``[N, W, Z]``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from portbench.reference import attribution, temporal
from portbench.reference.precision import Rounding, exact_f32, rounding

MODE_MODEL = 1
PUBLISHED = ("node_power_uw", "node_energy_uj", "workload_power_uw",
             "workload_energy_uj")


def mix(ratio: dict[str, torch.Tensor], model_watts: torch.Tensor,
        mode: torch.Tensor, dt_s: torch.Tensor) -> dict[str, torch.Tensor]:
    """Per node: the ratio split, or for model nodes the estimator's."""
    power = model_watts * 1e6
    energy = power * dt_s[:, None, None]
    model = (mode == MODE_MODEL)
    return {
        "node_power_uw": torch.where(model[:, None], power.sum(dim=1),
                                     ratio["power_uw"]),
        "node_energy_uj": torch.where(model[:, None], energy.sum(dim=1),
                                      ratio["energy_uj"]),
        "workload_power_uw": torch.where(model[:, None, None], power,
                                         ratio["wl_power_uw"]),
        "workload_energy_uj": torch.where(model[:, None, None], energy,
                                          ratio["wl_energy_uj"]),
    }


def temporal_window(params: Mapping[str, torch.Tensor],
                    arrays: Mapping[str, np.ndarray],
                    device: torch.device, model_precision: str,
                    ratio_precision: str = "float32",
                    block: int = 64) -> dict[str, np.ndarray]:
    """The four published tensors of one temporal-fleet window from its
    host arrays (``fleetgen.BATCH_KEYS`` + ``feat_hist``, ``t_valid``),
    ``block`` nodes at a time on ``device``."""
    p = {k: v.to(device=device, dtype=torch.float32)
         for k, v in params.items()}
    rnd_model = rounding(model_precision)
    rnd_ratio = rounding(ratio_precision)
    n = arrays["cpu_deltas"].shape[0]
    out = {k: [] for k in PUBLISHED}
    with torch.no_grad(), exact_f32():
        for lo in range(0, n, block):
            a = {k: torch.from_numpy(np.ascontiguousarray(v[lo:lo + block])
                                     ).to(device)
                 for k, v in arrays.items()}
            res = _block(p, a, rnd_model, rnd_ratio)
            for k in PUBLISHED:
                out[k].append(res[k].cpu().numpy())
    return {k: np.concatenate(v) for k, v in out.items()}


def _block(p: Mapping[str, torch.Tensor], a: Mapping[str, torch.Tensor],
           rnd_model: Rounding, rnd_ratio: Rounding
           ) -> dict[str, torch.Tensor]:
    ratio = attribution.ratio_split(
        a["zone_deltas_uj"], a["zone_valid"], a["usage_ratio"],
        a["cpu_deltas"], a["workload_valid"], a["node_cpu_delta"],
        a["dt_s"], rnd_ratio)
    nb, w, t, f = a["feat_hist"].shape
    model_watts = temporal.watts(
        p, a["feat_hist"].reshape(nb * w, t, f),
        a["t_valid"].reshape(nb * w, t),
        a["workload_valid"].reshape(nb * w), rnd_model).reshape(nb, w, -1)
    return mix(ratio, model_watts, a["mode"], a["dt_s"])


def published_of(result: tuple[np.ndarray, ...]) -> dict[str, np.ndarray]:
    """The program's four host tensors, in the order the Aggregator
    copies them (node power, node energy, workload power, workload
    energy), by name."""
    return dict(zip(PUBLISHED, result))

