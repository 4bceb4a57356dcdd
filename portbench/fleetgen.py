"""The general generator: a fleet's windows from a configuration, a
traffic mix and a seed.

A configuration (``configs/*.json``) fixes the deployment: nodes, pods a
node, RAPL zones, the share of nodes with RAPL, the interval, the
history window and the buckets. A traffic mix (``traffic/*.json``)
fixes the readings' ranges (``cpu_s``, ``zone_uj``, ``usage_ratio``)
and how many pods a node are new (``new_pods_per_node``: their history
holds 1 … T−1 ticks, right-padded). Every count is fixed by the two
files; the seed draws only the values, on the device, in a few large
calls of a ``torch.Generator``.

Host arrays come in the layout the Aggregator hands its programs: a
padded batch ``[N, W]`` (nodes and pods rounded up to their buckets,
padding masked) and, with history, ``feat_hist [N, W, T, 7]`` and
``t_valid [N, W, T]``. A node is a model node (no RAPL) where
``floor((i + 1)·m) > floor(i·m)``, ``m`` the share without RAPL: every
odd node at one half.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Mapping

import numpy as np
import torch

from portbench.reference.attribution import ratio_split, tick_features

BATCH_KEYS = ("zone_deltas_uj", "zone_valid", "usage_ratio", "cpu_deltas",
              "workload_valid", "node_cpu_delta", "dt_s", "mode")
N_FEATURES = 7


def pad_to(n: int, bucket: int) -> int:
    """The smallest multiple of ``bucket`` ≥ max(n, 1)."""
    return -(-max(n, 1) // bucket) * bucket


@dataclass(frozen=True)
class Fleet:
    """A configuration's shapes."""

    nodes: int
    pods: int
    zones: int
    node_bucket: int
    workload_bucket: int
    history: int
    rapl_share: float
    interval_s: float

    @classmethod
    def of(cls, config: Mapping[str, Any]) -> "Fleet":
        return cls(nodes=config["nodes"], pods=config["pods_per_node"],
                   zones=len(config["zones"]),
                   node_bucket=config["node_bucket"],
                   workload_bucket=config["workload_bucket"],
                   history=config.get("history_window", 1),
                   rapl_share=config["rapl_share"],
                   interval_s=config["interval_s"])

    @property
    def n(self) -> int:
        return pad_to(self.nodes, self.node_bucket)

    @property
    def w(self) -> int:
        return pad_to(self.pods, self.workload_bucket)

    def model_nodes(self) -> np.ndarray:
        """bool [nodes]: the nodes without RAPL."""
        m = 1.0 - self.rapl_share
        i = np.arange(self.nodes)
        return np.floor((i + 1) * m) > np.floor(i * m)


def _uniform(gen: torch.Generator, shape: tuple[int, ...],
             lo_hi: tuple[float, float], device: torch.device
             ) -> torch.Tensor:
    lo, hi = lo_hi
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def windows(fleet: Fleet, traffic: Mapping[str, Any], gen: torch.Generator,
            device: torch.device, count: int,
            history: bool) -> dict[str, torch.Tensor]:
    """``count`` windows on ``device``: the batch keys with a leading
    ``[count]`` axis, and with ``history`` the feature windows."""
    c, n, p, z = count, fleet.nodes, fleet.pods, fleet.zones
    t = fleet.history if history else 1
    cpu = _uniform(gen, (c, n, t, p), traffic["cpu_s"], device)
    usage = _uniform(gen, (c, n, t), traffic["usage_ratio"], device)
    zone = _uniform(gen, (c, n, z), traffic["zone_uj"], device)
    node_cpu = cpu.sum(dim=-1)
    big_n, big_w = fleet.n, fleet.w
    f32 = torch.float32

    def padded(x: torch.Tensor, shape: tuple[int, ...],
               dtype: torch.dtype = f32) -> torch.Tensor:
        out = torch.zeros(shape, dtype=dtype, device=device)
        out[tuple(slice(0, s) for s in x.shape)] = x
        return out

    now = (slice(None), slice(None), t - 1)
    out = {
        "zone_deltas_uj": padded(zone, (c, big_n, z)),
        "zone_valid": padded(torch.ones((c, n, z), dtype=torch.bool,
                                        device=device),
                             (c, big_n, z), torch.bool),
        "usage_ratio": padded(usage[now], (c, big_n)),
        "cpu_deltas": padded(cpu[now], (c, big_n, big_w)),
        "workload_valid": padded(torch.ones((c, n, p), dtype=torch.bool,
                                            device=device),
                                 (c, big_n, big_w), torch.bool),
        "node_cpu_delta": padded(node_cpu[now], (c, big_n)),
        "dt_s": padded(torch.full((c, n), fleet.interval_s, device=device),
                       (c, big_n)),
        "mode": padded(torch.as_tensor(fleet.model_nodes(), device=device)
                       .to(torch.int32).expand(c, n), (c, big_n),
                       torch.int32),
    }
    if history:
        feat, valid = _history(fleet, traffic, gen, cpu, node_cpu, usage)
        out["feat_hist"] = padded(feat, (c, big_n, big_w, t, N_FEATURES))
        out["t_valid"] = padded(valid, (c, big_n, big_w, t), torch.bool)
    return out


def _history(fleet: Fleet, traffic: Mapping[str, Any], gen: torch.Generator,
             cpu: torch.Tensor,  # [C, n, T, p]
             node_cpu: torch.Tensor,  # [C, n, T]
             usage: torch.Tensor,  # [C, n, T]
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """→ (feat [C, n, p, T, 7], t_valid [C, n, p, T]): each pod's ticks
    oldest first; a new pod holds only its last ``k`` ticks, from the
    front. A node's ``j``-th new pod (slots drawn from the seed) holds
    ``k = 1 + j mod (T − 1)`` ticks."""
    c, n, t, p = cpu.shape
    dev = cpu.device
    feat = tick_features(cpu, node_cpu, usage, fleet.interval_s)
    feat = feat.permute(0, 1, 3, 2, 4)  # [C, n, p, T, F]
    ticks = torch.full((c, n, p), t, dtype=torch.int64, device=dev)
    fresh = int(traffic.get("new_pods_per_node", 0))
    if fresh and t > 1:
        order = torch.rand((c, n, p), generator=gen, device=dev).argsort(-1)
        k = 1 + torch.arange(fresh, device=dev) % (t - 1)
        ticks.scatter_(-1, order[..., :fresh], k.expand(c, n, fresh))
    pos = torch.arange(t, device=dev)
    valid = pos < ticks[..., None]  # [C, n, p, T]
    src = (t - ticks)[..., None] + pos  # a new pod's last k ticks first
    src = torch.where(valid, src, 0)
    feat = torch.gather(feat, 3, src[..., None].expand(*src.shape, N_FEATURES))
    return torch.where(valid[..., None], feat, 0.0), valid


def to_host(arrays: Mapping[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Device tensors → numpy arrays in memory numpy allocated, as the
    Aggregator's own arrays are (numpy advises huge pages for large
    arrays; PyTorch's host allocator does not)."""
    out = {}
    for k, v in arrays.items():
        host = np.empty(tuple(v.shape), dtype=torch.empty(
            (), dtype=v.dtype).numpy().dtype)
        torch.from_numpy(host).copy_(v)
        out[k] = host
    return out


def training_dump(config: Mapping[str, Any], traffic: Mapping[str, Any],
                  gen: torch.Generator, device: torch.device
                  ) -> dict[str, Any]:
    """The Aggregator's training dumps of the configuration's
    ``dump_windows`` windows, joined as ``cmd.train.load_windows`` joins
    them: each window's RAPL rows, their inputs and their ratio-split
    watts as labels (``label_valid`` where the workload and the zone are
    valid). Where the configuration's ``model`` is ``temporal`` they
    carry the rows' histories too (``feat_hist [R, W, T, F]``,
    ``t_valid [R, W, T]``, T its ``history_window``), as the Aggregator
    dumps them in temporal mode; every other family's draws no history."""
    fleet = Fleet.of(config)
    count = int(config["dump_windows"])
    win = windows(fleet, traffic, gen, device, count,
                  history=config["model"] == "temporal")
    rapl = np.zeros(fleet.n, bool)
    rapl[:fleet.nodes] = ~fleet.model_nodes()
    rapl = torch.as_tensor(rapl, device=device)
    flat = {k: v.reshape(count * fleet.n, *v.shape[2:])
            for k, v in win.items()}
    rows = rapl.repeat(count)
    flat = {k: v[rows] for k, v in flat.items()}
    split = ratio_split(flat["zone_deltas_uj"], flat["zone_valid"],
                        flat["usage_ratio"], flat["cpu_deltas"],
                        flat["workload_valid"], flat["node_cpu_delta"],
                        flat["dt_s"])
    data = to_host({
        "cpu_deltas": flat["cpu_deltas"],
        "workload_valid": flat["workload_valid"],
        "node_cpu_delta": flat["node_cpu_delta"],
        "usage_ratio": flat["usage_ratio"],
        "dt_s": flat["dt_s"],
        "target_watts": split["wl_power_uw"] / 1e6,
        "label_valid": (flat["workload_valid"][..., None]
                        & flat["zone_valid"][:, None, :]),
        **{k: flat[k] for k in ("feat_hist", "t_valid") if k in flat},
    })
    data["zone_names"] = list(config["zones"])
    return data


def temporal_params(estimator: Mapping[str, Any], n_zones: int,
                    gen: torch.Generator, device: torch.device
                    ) -> dict[str, torch.Tensor]:
    """Served temporal params with every leaf non-zero, from one draw at
    the initialiser's scales: Glorot-normal matrices (the head and the
    skip path too, which the initialiser zeroes; the skip path's
    magnitudes, so that power rises with every feature as a fitted skip
    path's does), N(0, 0.02²) positions and biases, layer-norm scales
    1 + N(0, 0.02²)."""
    d, f = estimator["d_model"], estimator["n_features"]
    d4 = estimator["mlp_ratio"] * d
    shapes = {
        "in_proj": (f, d), "pos_emb": (estimator["t_max"], d),
        "ln1_scale": (d,), "ln1_bias": (d,), "wq": (d, d), "wk": (d, d),
        "wv": (d, d), "wo": (d, d), "ln2_scale": (d,), "ln2_bias": (d,),
        "w_mlp0": (d, d4), "b_mlp0": (d4,), "w_mlp1": (d4, d),
        "b_mlp1": (d,), "ln_f_scale": (d,), "ln_f_bias": (d,),
        "w_head": (d, n_zones), "b_head": (n_zones,),
        "w_skip": (f, n_zones),
    }
    sizes = [math.prod(s) for s in shapes.values()]
    draw = torch.randn(sum(sizes), generator=gen, device=device)
    params, at = {}, 0
    for (name, shape), size in zip(shapes.items(), sizes):
        x = draw[at:at + size].reshape(shape)
        at += size
        if len(shape) == 2 and name != "pos_emb":
            x = x * math.sqrt(2.0 / (shape[0] + shape[1]))
            if name == "w_skip":
                x = x.abs()
        elif name.endswith("_scale"):
            x = 1.0 + 0.02 * x
        else:
            x = 0.02 * x
        params[name] = x.contiguous()
    return params
