"""Expert parallelism: all_to_all dispatch for the MoE estimator.

As ``kepler_tpu.parallel.expert``: the expert axis shards over the
``expert`` mesh axis and rows move to their expert:

    rows [B, F], experts sharded E/n a shard
    → top-1 route (explicit node-type id, or the learned gate)
    → capacity positions (per expert, in local row order)
    → all_to_all: each shard receives the rows routed to ITS experts
    → batched expert MLP on the local experts only
    → all_to_all back, combine with the gate weight

The JAX program dispatches and combines with dense one-hot einsums over
``[B_loc, E, C]``; here a row is written to, and read from, its capacity
slot by index. Each one-hot einsum sums exactly one non-zero term, so the
values are the same for finite rows (at 262,144 rows on 8 shards the
one-hot tensor alone would take 34 GB a shard). A NaN feature row stays
in its own row, where the one-hot einsums' ``0 · NaN`` spread it over
its shard.

Capacity is ``max(1, ceil(B_loc · capacity_factor))``; the default 1.0
never drops a row. Rows past their expert's capacity, and rows whose
expert id is outside ``[0, E)``, get zero watts.

On a mesh of several processes each rank routes, dispatches and runs
the experts of its own shards, the two all-to-alls cross ranks, and the
rows come home sharded as JAX's ``out_specs=P(axis)``: one
``all_gather`` of the row blocks gives every rank the whole output.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from kepler_tpu_torch.models.moe import expert_forward, gate_logits
from kepler_tpu_torch.parallel.collectives import (all_to_all, axis_devices,
                                                   gather_whole, local_map)
from kepler_tpu_torch.parallel.mesh import Mesh

EXPERT_AXIS = "expert"
EXPERT_KEYS = ("w0", "b0", "w1", "b1", "w_skip")


def _slots(expert_id: torch.Tensor, n_experts: int, capacity: int
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """→ (each row's slot ``e · C + position`` among the ``E · C``
    capacity slots, or ``E · C`` when dropped; whether it is kept).
    Positions count the earlier local rows routed to the same expert."""
    e = torch.arange(n_experts, device=expert_id.device)
    onehot = (expert_id.to(torch.int64)[:, None] == e).to(torch.int64)
    pos = (torch.cumsum(onehot, dim=0) * onehot).sum(dim=1) - 1
    keep = (pos >= 0) & (pos < capacity)
    slot = torch.where(keep, expert_id.to(torch.int64) * capacity + pos,
                       n_experts * capacity)
    return slot, keep


def _dispatch(x: torch.Tensor, slot: torch.Tensor, slots: int
              ) -> torch.Tensor:
    """Rows into their slots → ``[slots, F]`` (empty slots zero)."""
    buf = torch.zeros((slots + 1, x.shape[-1]), dtype=x.dtype,
                      device=x.device)
    buf[slot] = x  # dropped rows all land in the spare last slot
    return buf[:slots]


def make_expert_parallel_moe(
    mesh: Mesh,
    *,
    axis_name: str = EXPERT_AXIS,
    capacity_factor: float = 1.0,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> Callable:
    """→ ``(params, features [B, F], expert_id [B], gate_prob [B]) →
    watts [B, Z]``.

    ``B`` and the expert count must divide by the ``axis_name`` mesh
    size (rows and experts split evenly over the shards).
    ``expert_id`` is each row's routing (node type, or
    :func:`top1_route`'s argmax) and ``gate_prob`` its combine weight
    (1.0 for explicit routing). The output lies on the first shard's
    device (on a mesh of several processes, every rank passes the same
    whole inputs and gets the whole output on its first shard's device).
    """
    devices = axis_devices(mesh, axis_name)
    n = len(devices)

    def fn(params, features, expert_id, gate_prob):
        b, e = features.shape[0], params["w0"].shape[0]
        if b % n or e % n:
            raise ValueError(f"rows ({b}) and experts ({e}) must divide by "
                             f"the '{axis_name}' mesh size ({n})")
        b_loc, e_loc = b // n, e // n
        c = max(1, math.ceil(b_loc * capacity_factor))
        rows = [slice(i * b_loc, (i + 1) * b_loc) for i in range(n)]
        routes = local_map(devices, lambda i: _slots(
            expert_id[rows[i]].to(devices[i]), e, c))
        # rows grouped per global expert: axis 0 = destination shard
        ex_in = local_map(devices, lambda i: _dispatch(
            features[rows[i]].to(devices[i]), routes[i][0], e * c).reshape(
            n, e_loc, c, -1))
        ex_in = all_to_all(ex_in, devices, split_axis=0, concat_axis=0,
                           tiled=False)  # [n (source), E_loc, C, F]

        def experts(i):
            p = {k: params[k][i * e_loc:(i + 1) * e_loc].to(devices[i])
                 for k in EXPERT_KEYS}
            x = ex_in[i].transpose(0, 1).reshape(e_loc, n * c, -1)
            y = expert_forward(p, x, compute_dtype)  # [E_loc, n·C, Z]
            return y.reshape(e_loc, n, c, -1).transpose(0, 1)

        ex_out = all_to_all(local_map(devices, experts), devices,
                            split_axis=0, concat_axis=0,
                            tiled=False)  # [n (expert shard), E_loc, C, Z]

        def combine(i):
            slot, keep = routes[i]
            picked = ex_out[i].reshape(e * c, -1)[
                torch.clamp(slot, max=e * c - 1)]
            gate = gate_prob[rows[i]].to(devices[i]).to(torch.float32)
            return torch.where(keep[:, None], gate[:, None] * picked, 0.0)

        return gather_whole(local_map(devices, combine), devices)

    return fn


def top1_route(params: dict[str, torch.Tensor], features: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Learned routing → (expert_id int32 [B], gate_prob f32 [B]):
    Switch-style argmax expert, weighted by its softmax probability."""
    logits = gate_logits(params, features)
    probs = torch.softmax(logits, dim=-1)
    idx = torch.argmax(logits, dim=-1)
    return (idx.to(torch.int32),
            torch.gather(probs, -1, idx[..., None])[..., 0])
