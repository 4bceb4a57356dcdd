"""Kepler's ratio attribution and the estimators' features, plainly.

Kepler (``internal/monitor/node.go``, ``process.go``): a node's zone
energy delta splits into ``active = Δ · usage_ratio`` (the ratio clamped
to [0, 1]) and ``idle = Δ − active``; power is energy over the window's
seconds (0 where the window has none); workload ``w`` takes the share
``Δcpu_w / Δcpu_node`` of the active energy and power of every zone.
Invalid zones and workload slots contribute zero. ``rnd`` rounds every
intermediate (the identity for the stated f32; ``bfloat16`` for a
control).
"""

from __future__ import annotations

import torch

from portbench.reference.precision import Rounding, rounding

F32 = rounding("float32")


def ratio_split(zone_uj: torch.Tensor,  # [N, Z]
                zone_valid: torch.Tensor,  # bool [N, Z]
                usage_ratio: torch.Tensor,  # [N]
                cpu: torch.Tensor,  # [N, W]
                valid: torch.Tensor,  # bool [N, W]
                node_cpu: torch.Tensor,  # [N]
                dt_s: torch.Tensor,  # [N]
                rnd: Rounding = F32) -> dict[str, torch.Tensor]:
    """→ node ``energy_uj``/``power_uw`` [N, Z] and workload
    ``wl_energy_uj``/``wl_power_uw`` [N, W, Z] (µJ and µW)."""
    delta = rnd(torch.where(zone_valid, zone_uj, 0.0))
    active = rnd(delta * rnd(usage_ratio.clamp(0.0, 1.0))[:, None])
    has_dt = (dt_s > 0)[:, None]
    seconds = torch.where(has_dt, dt_s[:, None], 1.0)
    power = rnd(torch.where(has_dt, delta / seconds, 0.0))
    active_power = rnd(torch.where(has_dt, active / seconds, 0.0))
    share = rnd(workload_share(cpu, valid, node_cpu))
    return {
        "energy_uj": delta,
        "power_uw": power,
        "wl_energy_uj": rnd(share[:, :, None] * active[:, None, :]),
        "wl_power_uw": rnd(share[:, :, None] * active_power[:, None, :]),
    }


def workload_share(cpu: torch.Tensor, valid: torch.Tensor,
                   node_cpu: torch.Tensor) -> torch.Tensor:
    """Δcpu_w / Δcpu_node over valid slots; 0 where the node ran nothing."""
    used = torch.where(valid, cpu, 0.0)
    node = node_cpu[..., None]
    return torch.where(node > 0, used / node.clamp(min=1e-30), 0.0)


def tick_features(cpu: torch.Tensor,  # [..., W] one tick's cpu seconds
                  node_cpu: torch.Tensor,  # [...]
                  usage_ratio: torch.Tensor,  # [...]
                  dt_s: float | torch.Tensor) -> torch.Tensor:
    """One tick's feature rows [..., W, 7], as a node's history records
    them: cpu seconds, share of the node's, node usage ratio, window
    seconds, cpu rate, a constant 1, log1p of the node's cpu seconds."""
    dt = torch.as_tensor(dt_s, dtype=torch.float32, device=cpu.device)
    dt = dt.expand(node_cpu.shape)[..., None].expand(cpu.shape)
    share = torch.where(node_cpu[..., None] > 0,
                        cpu / node_cpu[..., None].clamp(min=1e-30), 0.0)
    rate = torch.where(dt > 0, cpu / dt.clamp(min=1e-30), 0.0)
    log_node = torch.log1p(node_cpu.clamp(min=0.0))[..., None]
    return torch.stack([cpu, share, usage_ratio[..., None].expand(cpu.shape),
                        dt, rate, torch.ones_like(cpu),
                        log_node.expand(cpu.shape)], dim=-1)


def window_features(cpu: torch.Tensor,  # [N, W]
                    valid: torch.Tensor,  # bool [N, W]
                    node_cpu: torch.Tensor,  # [N]
                    usage_ratio: torch.Tensor,  # [N]
                    dt_s: torch.Tensor) -> torch.Tensor:  # [N]
    """A window's feature rows [N, W, 7] for the single-tick estimators:
    the tick features of the valid slots (share and rate over valid
    slots only, 0 without window seconds), zero rows elsewhere."""
    used = torch.where(valid, cpu, 0.0)
    dt = dt_s[:, None].expand(used.shape)
    rate = torch.where(dt > 0, used / dt.clamp(min=1e-30), 0.0)
    feats = torch.stack(
        [used, workload_share(cpu, valid, node_cpu),
         usage_ratio[:, None].expand(used.shape), dt, rate,
         torch.ones_like(used),
         torch.log1p(node_cpu.clamp(min=0.0))[:, None].expand(used.shape)],
        dim=-1)
    return torch.where(valid[..., None], feats, 0.0)
