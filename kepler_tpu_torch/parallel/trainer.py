"""Distributed estimator training: data parallel × tensor parallel.

As ``kepler_tpu.parallel.trainer``: the MLP's whole train step (forward,
masked-MSE loss, backward, AdamW) over a 2-D ``node × model`` mesh.

- **DP** (``node``): each node row of shards holds its own replica and
  its rows of the batch. The masked-MSE numerator and denominator are
  summed over ``node`` before the division (the mean of per-shard losses
  is not the loss), and gradients are all-reduced over ``node``.
- **TP** (``model``, Megatron): ``w0``/``b0`` split by columns and ``w1``
  by rows, so the forward's one collective is a ``psum`` of layer 1's
  partial products over ``model``; ``b1``, ``w2``, ``b2`` and ``w_skip``
  are replicated, and every model shard computes the replicated rest.

JAX derives both collectives from sharding annotations (GSPMD); here one
process drives the shards and writes them out. Every model shard
computes the same loss, and the backward runs on their mean, so a
replicated parameter's copies take 1/m of its gradient each and the
all-reduce over ``node`` and ``model`` sums them back; a split parameter
takes its own slice's gradient and is all-reduced over ``node`` only.
Each shard's AdamW holds the moments of the slice it updates, so
optimizer memory splits over ``model`` too. :func:`gather_params` joins
the slices into whole params for serving (the train → serve hand-off).

On a mesh of several processes, as on JAX's global mesh, any shard may
belong to any rank, a node row (a tensor-parallel group) included.
Each rank holds and steps its own shards (the others' entries of the
state's grids are None); layer 1's ``psum`` over ``model``, the loss's
two sums over ``node`` and the gradient all-reduce cross ranks where
their shards do (``parallel.collectives``), so every rank gets the same
loss and every replica the same gradients. A sum that every rank must
read is taken over the first row or column of each rank
(:func:`_firsts`): every model shard computes the same loss terms, and
every node row the same whole params.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from kepler_tpu_torch.models.nn import acc_matmul, gelu_operand
from kepler_tpu_torch.models.train import TrainState
from kepler_tpu_torch.parallel.collectives import (AxisDevices, gather_whole,
                                                   grid_devices,
                                                   local_indices, local_map,
                                                   psum, ranks_of)
from kepler_tpu_torch.parallel.mesh import MODEL_AXIS, NODE_AXIS, Mesh

AXES = (NODE_AXIS, MODEL_AXIS)

Spec = tuple  # per dimension: an axis name it splits over, or None


class ShardedTrainState(NamedTuple):
    """Each shard's params (leaves that require grad) and AdamW, as
    ``[node][model]`` grids (None at other ranks' shards), the step, and
    the mesh."""

    params: list[list[dict[str, torch.Tensor]]]
    opt_state: list[list[torch.optim.Optimizer]]
    step: int
    mesh: Mesh


def mlp_param_shardings() -> dict[str, Spec]:
    """Megatron TP layout of the MLP params: per dimension, the mesh axis
    it is split over (None: whole)."""
    return {
        "w0": (None, MODEL_AXIS),  # column-parallel
        "b0": (MODEL_AXIS,),
        "w1": (MODEL_AXIS, None),  # row-parallel (psum after)
        "b1": (None,),
        "w2": (None, None),
        "b2": (None,),
        "w_skip": (None, None),  # wide path: [F, Z] is tiny, replicated
    }


def _split_dim(spec: Spec) -> int | None:
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


def _slice(x: torch.Tensor, spec: Spec, j: int, m: int) -> torch.Tensor:
    dim = _split_dim(spec)
    return x if dim is None else torch.chunk(x, m, dim=dim)[j]


def _grid(mesh: Mesh) -> tuple[list[AxisDevices], list[int]]:
    """The mesh's rows of devices and this rank's rows (those where it
    owns a shard)."""
    grid = grid_devices(mesh, AXES)
    return grid, [i for i, row in enumerate(grid) if local_indices(row)]


def _firsts(axes: list[AxisDevices]) -> list[int]:
    """The positions among ``axes`` of each rank's first axis holding one
    of its shards, in order: the axes whose collective gives every rank
    a result (in one process, the first)."""
    seen: set[int] = set()
    firsts = []
    for k, axis in enumerate(axes):
        if set(ranks_of(axis)) - seen:
            firsts.append(k)
        seen |= set(ranks_of(axis))
    return firsts


def shard_train_state(state: TrainState, mesh: Mesh) -> ShardedTrainState:
    """Place a (single-device) MLP train state on the mesh: each of this
    rank's shards gets its own f32 copy of its slice of every param, and
    an optimizer of the state's kind over them holding its slice of the
    moments."""
    grid, _ = _grid(mesh)
    m = len(grid[0])
    layout = mlp_param_shardings()
    opt = state.opt_state

    def place(row: AxisDevices, j: int) -> tuple[dict, torch.optim.Optimizer]:
        dev = row[j]
        own = {k: _slice(v.detach(), layout[k], j, m).to(
            dev, dtype=torch.float32, copy=True).requires_grad_(True)
            for k, v in state.params.items()}
        shard_opt = type(opt)([own[k] for k in sorted(own)])
        shard_opt.param_groups[0].update(
            {k: v for k, v in opt.param_groups[0].items() if k != "params"})
        for k, full in state.params.items():
            for name, val in opt.state.get(full, {}).items():
                if torch.is_tensor(val) and val.shape == full.shape:
                    val = _slice(val, layout[k], j, m).to(dev, copy=True)
                elif torch.is_tensor(val):
                    val = val.clone()
                shard_opt.state[own[k]][name] = val
        return own, shard_opt

    cells = [local_map(row, lambda j, row=row: place(row, j))
             for row in grid]
    params = [[None if c is None else c[0] for c in row] for row in cells]
    opts = [[None if c is None else c[1] for c in row] for row in cells]
    return ShardedTrainState(params, opts, state.step, mesh)


def gather_params(state: ShardedTrainState,
                  device: str | torch.device | None = None
                  ) -> dict[str, torch.Tensor]:
    """Whole params (detached) from this rank's first node row (the
    mesh's first in one process), on ``device`` (default: this rank's
    first shard of that row): what serving takes. A split param's
    ``model`` slices join by an ``all_gather`` where the row spans
    ranks, so every rank gets whole params."""
    grid, _ = _grid(state.mesh)
    layout = mlp_param_shardings()
    out: dict[str, torch.Tensor] = {}
    for r in _firsts(grid):  # every rank joins each row it has a shard of
        row, cells = grid[r], state.params[r]
        mine = local_indices(row)
        if not mine:
            continue
        dev = torch.device(device) if device is not None else row[mine[0]]
        whole = {}
        for k in cells[mine[0]]:
            dim = _split_dim(layout[k])
            whole[k] = (cells[mine[0]][k].detach().to(dev, copy=True)
                        if dim is None else gather_whole(
                            [None if c is None else c[k].detach()
                             for c in cells], row, dim).to(dev))
        out = out or whole
    return out


def _axis(grid: list[AxisDevices], cells: list[tuple[int, int]]
          ) -> AxisDevices:
    """The shards ``cells`` of the grid as one axis, with their ranks."""
    return AxisDevices([grid[i][j] for i, j in cells],
                       [ranks_of(grid[i])[j] for i, j in cells])


def make_distributed_train_step(
    mesh: Mesh,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> Callable:
    """→ ``(state, features [B, W, F], valid [B, W], targets [B, W, Z])
    → (state, loss)`` over a :class:`ShardedTrainState` of ``mesh``.

    The leading batch axis splits over ``node`` (B must divide by its
    size). The MLP trunk computes in ``compute_dtype`` (bf16, as JAX's
    ``predict_mlp`` default) on the unclamped output. The state carries
    its optimizers. The state's tensors are updated in place, as the
    port's other train steps do.
    """
    grid, mine = _grid(mesh)
    n, m = len(grid), len(grid[0])
    layout = mlp_param_shardings()
    cd = compute_dtype

    def step(state: ShardedTrainState, features: torch.Tensor,
             workload_valid: torch.Tensor, targets: torch.Tensor
             ) -> tuple[ShardedTrainState, torch.Tensor]:
        b = features.shape[0]
        if b % n:
            raise ValueError(f"batch {b} does not divide over the "
                             f"{n} '{NODE_AXIS}' shards")
        rows = [slice(i * (b // n), (i + 1) * (b // n)) for i in range(n)]
        opts = [o for row in state.opt_state for o in row if o is not None]
        for opt in opts:
            opt.zero_grad(set_to_none=True)
        nums: list = [[None] * m for _ in range(n)]
        dens: list = [[None] * m for _ in range(n)]
        for i in mine:
            row, p_row = grid[i], state.params[i]
            x = local_map(row, lambda j: features[rows[i]].to(row[j]))
            valid = local_map(row, lambda j: workload_valid[rows[i]].to(
                row[j]))
            tgt = local_map(row, lambda j: targets[rows[i]].to(row[j]))

            def partial(j):
                h = gelu_operand(acc_matmul(x[j], p_row[j]["w0"], cd),
                                 p_row[j]["b0"], cd)
                return acc_matmul(h, p_row[j]["w1"], cd)

            # layer 1, over ``model``
            summed = psum(local_map(row, partial), row)
            for j in local_indices(row):
                p = p_row[j]
                h = gelu_operand(summed[j], p["b1"], cd)
                watts = acc_matmul(h, p["w2"], cd)
                watts = watts + x[j].to(torch.float32) @ p["w_skip"]
                watts = watts + p["b2"]
                watts = torch.where(valid[j][..., None], watts, 0.0)
                mask = valid[j][..., None].to(torch.float32)
                nums[i][j] = torch.sum((watts - tgt[j]) ** 2 * mask)
                dens[i][j] = torch.sum(mask)
        # numerator and denominator summed over ``node``, then divided;
        # every column holds the same terms, so a rank reads any of its own
        cols = [_axis(grid, [(i, j) for i in range(n)]) for j in range(m)]
        sums = []
        for j in _firsts(cols):
            own = local_indices(cols[j])
            if own:
                sums.append([psum([r[j] for r in terms], cols[j])[own[0]]
                             for terms in (nums, dens)])
        total, count = sums[0]
        count = torch.clamp(count, min=1.0)
        loss = (total / count).detach()
        # the mean over the model shards' identical losses
        objective = [nums[i][j] / (m * count.detach().to(grid[i][j]))
                     for i in mine for j in local_indices(grid[i])]
        torch.autograd.backward(objective)
        # gradient all-reduce: split leaves over ``node``, replicated ones
        # over ``node`` and ``model``
        for k, spec in layout.items():
            groups = ([[(i, j) for i in range(n)] for j in range(m)]
                      if _split_dim(spec) is not None else
                      [[(i, j) for i in range(n) for j in range(m)]])
            for group in groups:
                axis = _axis(grid, group)
                if not local_indices(axis):
                    continue  # no shard of this rank: no part in it
                reduced = psum([None if state.params[i][j] is None
                                else state.params[i][j][k].grad
                                for i, j in group], axis)
                for (i, j), g in zip(group, reduced):
                    if g is not None:
                        state.params[i][j][k].grad = g
        for opt in opts:
            opt.step()
        return state._replace(step=state.step + 1), loss

    return step
