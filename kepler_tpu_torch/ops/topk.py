"""Top-K selection for terminated-workload tracking.

Reference parity: ``internal/monitor/terminated_resource_tracker.go`` keeps a
min-heap of terminated workloads ranked by primary-zone energy with a minimum
energy threshold. The batched equivalent is one masked top-k over the
energy column — one call replaces the heap's per-item push/evict.

Selection rule (the reference package's ``lax.top_k``): energies compare
in f32, so f64 energies that round to the same f32 tie; among equal
values the lower index wins. ``torch.topk`` promises no order among equal
values (on the CPU it already picks other indices at a tied boundary), so
the selection is a stable descending sort: equal values keep their index
order.
"""

from __future__ import annotations

import numpy as np
import torch

from kepler_tpu_torch.device import resolve_device


def top_k_by_energy(
    energies: np.ndarray,
    k: int,
    min_energy: float = 0.0,
    device: str | torch.device = "cuda",
) -> np.ndarray:
    """Indices of the top-k energies above ``min_energy``, descending.

    ``k <= 0`` returns an empty selection (tracking disabled); ``k`` larger
    than the candidate count returns all qualifying indices. The sort runs
    on ``device``: one copy of the masked f32 column in, one of the ``k``
    chosen indices out.
    """
    energies = np.asarray(energies)
    n = energies.shape[0]
    if k <= 0 or n == 0:
        return np.empty(0, dtype=np.int64)
    dev = resolve_device(device)
    k_eff = min(k, n)
    masked = np.where(energies >= min_energy,
                      energies.astype(np.float32), np.float32(-np.inf))
    order = torch.sort(torch.from_numpy(masked).to(dev), descending=True,
                       stable=True).indices[:k_eff]
    indices = order.cpu().numpy().astype(np.int64)
    return indices[masked[indices] > -np.inf]
