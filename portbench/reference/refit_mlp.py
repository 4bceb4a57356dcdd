"""The MLP family's plain refit, as the refit driver finds it for a
configuration whose ``model`` is ``mlp``.

A family's module (``refit_<model>.py``) gives three things:
``start(seed, config)``, the params ``cmd.train`` starts from;
``inputs(dumps, device)``, the reference's inputs worked out again from
the dumps; and ``loss_and_grad(params, *inputs, rnd)``, which
``adamw.refit`` and ``adamw.step_from`` step.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

from portbench.reference import attribution, mlp
from portbench.reference.adamw import Params

loss_and_grad = mlp.loss_and_grad


def start(seed: int, config: Mapping[str, Any]) -> Params:
    est = config["estimator"]
    return mlp.init(seed, len(config["zones"]), est["hidden"],
                    est["n_features"])


def inputs(dumps: Mapping[str, Any], device: torch.device
           ) -> tuple[torch.Tensor, ...]:
    """(features [R, W, F], workload_valid, target_watts, label_valid):
    the features built again from the dumps' raw counters."""

    def put(key: str) -> torch.Tensor:
        return torch.from_numpy(dumps[key]).to(device)

    valid = put("workload_valid")
    feats = attribution.window_features(
        put("cpu_deltas"), valid, put("node_cpu_delta"), put("usage_ratio"),
        put("dt_s"))
    return feats, valid, put("target_watts"), put("label_valid")
