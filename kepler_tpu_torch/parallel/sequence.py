"""Sequence/context parallelism for the temporal estimator.

As ``kepler_tpu.parallel.sequence``: long feature-history windows
(``models.temporal``) shard their time axis over the ``seq`` mesh axis.
JAX states the layout with sharding annotations and GSPMD partitions the
per-timestep trunk ops (in-projection, layer norms, MLP) along T; here
one process drives each shard's block in turn (virtual shards may share
a device), so no op of the trunk sees more than one shard's ``T/n``
ticks and no shard holds the whole sequence:

1. ``feat_hist [W, T, F]`` and ``t_valid [W, T]`` are cut once into
   contiguous ``T/n`` blocks on the shards' devices (JAX's
   ``in_shardings``);
2. each shard runs the trunk's pre-attention half on its block
   (``models.temporal.trunk_qkv``, positions from its block's start);
3. attention, the only cross-timestep op, runs as a block core — the
   ring (``ring.ring_blocks``) or Ulysses (``ulysses.ulysses_blocks``);
4. each shard runs the post-attention half (``trunk_out``);
5. pooling: each workload's last valid position lies in exactly one
   block. Each shard takes the hidden row and the raw feature row of the
   workloads whose position it holds, zeros elsewhere, and one ``psum``
   adds the shards' rows: one pooled row per workload crosses shards, and
   a row plus zeros is exact in f32. The per-shard valid counts that
   locate ``last`` are summed by a ``psum`` too;
6. the head, the skip path, the clamp and the validity mask run once on
   the pooled ``[W, ·]`` rows, on the first shard's device, where the
   watts ``[W, Z]`` are returned (JAX's replicated ``out_shardings``).

Params are replicated (the model is small: the memory is in the
sequence): each distinct shard device holds one copy per call, and
virtual shards of one device share it. The train step gives each shard
its own autograd leaves over that copy, so that each shard's gradient is
its own, and sums them in shard order with an explicit ``psum`` (the
all-reduce GSPMD inserts in JAX) into the state's params.

On a mesh of several processes every rank passes the same whole inputs
(and its own copy of the params or the state), runs steps 2-5 for its
own shards, and the collectives carry the ring's hops and the ``psum`` s
between ranks. Every rank gets the pooled rows, so each computes the
watts on its first shard's device (the first shard's rank: as in one
process). In the train step every rank computes the loss; the first
shard's rank backpropagates it and the others a zero seed, so each rank
runs the collectives' transposes, and the gradient ``psum`` gives every
rank the same gradients and the same AdamW step.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from kepler_tpu_torch.models.temporal import _take_last, trunk_out, trunk_qkv
from kepler_tpu_torch.models.train import TrainState, masked_mse
from kepler_tpu_torch.parallel.collectives import (axis_devices,
                                                   local_indices, local_map,
                                                   psum)
from kepler_tpu_torch.parallel.mesh import Mesh
from kepler_tpu_torch.parallel.ring import SEQ_AXIS, ring_blocks, split_blocks

Params = dict[str, torch.Tensor]
# (qs, ks, vs, t_valid blocks) → output blocks, one per shard
BlockCore = Callable[[list, list, list, list], list]


def replicate(params: Params, devices: list[torch.device]) -> list[Params]:
    """One copy of ``params`` per distinct device of this rank's shards
    (none where they lie already), listed per shard: virtual shards of
    one device share it."""
    by_device: dict[torch.device, Params] = {}

    def copy_on(i: int) -> Params:
        dev = devices[i]
        if dev not in by_device:
            by_device[dev] = {k: v.to(dev) for k, v in params.items()}
        return by_device[dev]

    return local_map(devices, copy_on)


def sharded_predict(
    replicas: list[Params],
    hist_blocks: list[torch.Tensor],  # f32 [B, T/n, F] per shard
    tv_blocks: list[torch.Tensor],  # bool [B, T/n] per shard
    workload_valid: torch.Tensor,  # bool [B], any device
    *,
    devices: list[torch.device],
    core: BlockCore,
    clamp: bool,
    compute_dtype: torch.dtype,
) -> torch.Tensor:
    """The temporal estimator over per-shard blocks (steps 2-6 of the
    module docstring) → watts f32 [B, Z] on this rank's first shard's
    device (``devices[0]`` in one process)."""
    cd = compute_dtype
    first = local_indices(devices)[0]
    t_loc = hist_blocks[first].shape[1]
    pre = local_map(devices, lambda i: trunk_qkv(
        replicas[i], hist_blocks[i], tv_blocks[i], cd, t0=i * t_loc))
    xs, qs, ks, vs = ([None if p is None else p[j] for p in pre]
                      for j in range(4))
    attn = core(qs, ks, vs, tv_blocks)
    # the last valid position: the shards' valid counts, summed
    counts = psum(local_map(devices, lambda i: tv_blocks[i].sum(dim=-1)),
                  devices)

    def pooled_row(i: int) -> torch.Tensor:
        hidden = trunk_out(replicas[i], xs[i], attn[i], cd)
        local = torch.clamp(counts[i] - 1, min=0) - i * t_loc
        here = ((local >= 0) & (local < t_loc))[:, None]
        at = torch.clamp(local, 0, t_loc - 1)
        row = torch.cat([_take_last(hidden, at),
                         _take_last(hist_blocks[i], at).to(torch.float32)],
                        dim=1)
        return torch.where(here, row, 0.0)

    pooled = psum(local_map(devices, pooled_row), devices)[first]
    p0 = replicas[first]
    d = p0["w_head"].shape[0]
    # wide-and-deep: the last valid tick's raw features in f32
    watts = (pooled[:, :d] @ p0["w_head"] + pooled[:, d:] @ p0["w_skip"]
             + p0["b_head"])
    if clamp:
        watts = torch.clamp(watts, min=0.0)
    return torch.where(workload_valid.to(devices[first])[:, None], watts,
                       0.0)


def _blocks(feat_hist: torch.Tensor, workload_valid: torch.Tensor,
            t_valid: torch.Tensor | None, devices: list[torch.device]
            ) -> tuple[list, list, torch.Tensor, tuple]:
    """Leading axes flattened into the batch (as ``predict_temporal``),
    then T cut into the shards' blocks → (history blocks, validity
    blocks, flat workload validity, the watts' leading shape)."""
    lead = feat_hist.shape[:-2]
    t, f = feat_hist.shape[-2:]
    x = feat_hist.reshape(-1, t, f)
    tv = (torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
          if t_valid is None else t_valid.reshape(-1, t))
    return (split_blocks(x, devices), split_blocks(tv, devices),
            workload_valid.reshape(-1), lead)


def make_sharded_temporal_program(
    devices: list[torch.device],
    core: BlockCore,
    *,
    clamp: bool,
    compute_dtype: torch.dtype,
) -> Callable:
    """→ ``(params, feat_hist [W, T, F], workload_valid [W], t_valid
    [W, T]) → watts [W, Z]`` over ``devices`` with ``core`` as the
    attention block core (the ring's or Ulysses'); the watts lie on this
    rank's first shard's device."""

    def fn(params, feat_hist, workload_valid, t_valid=None):
        hist, tv, wv, lead = _blocks(feat_hist, workload_valid, t_valid,
                                     devices)
        watts = sharded_predict(replicate(params, devices), hist, tv, wv,
                                devices=devices, core=core, clamp=clamp,
                                compute_dtype=compute_dtype)
        return watts.reshape(*lead, -1)

    return fn


def ring_core(devices: list[torch.device], compute_dtype: torch.dtype
              ) -> BlockCore:
    """The causal einsum ring over the shards' blocks (JAX's default
    backend for these programs)."""
    return functools.partial(ring_blocks, devices=devices, causal=True,
                             compute_dtype=compute_dtype)


def make_temporal_program(
    mesh: Mesh,
    *,
    axis_name: str = SEQ_AXIS,
    clamp: bool = True,
    compute_dtype: torch.dtype = torch.bfloat16,
) -> Callable:
    """→ ``(params, feat_hist [W, T, F], workload_valid [W],
    t_valid [W, T]) → watts [W, Z]`` with T sharded over ``axis_name``
    (T must divide by its size): the trunk per shard block, attention as
    the einsum ring, the watts on the first shard's device."""
    devices = axis_devices(mesh, axis_name)
    return make_sharded_temporal_program(
        devices, ring_core(devices, compute_dtype), clamp=clamp,
        compute_dtype=compute_dtype)


def make_sequence_parallel_train_step(
    mesh: Mesh,
    *,
    axis_name: str = SEQ_AXIS,
    compute_dtype: torch.dtype = torch.float32,
    remat: bool = False,
) -> Callable:
    """Long-context training: gradients flow back through the ring.

    → ``(state, feat_hist [W, T, F], workload_valid [W], t_valid [W, T],
    target_watts [W, Z], label_valid=None) → (state, loss)``. The forward
    is the serving program's, per shard block, unclamped; the loss is
    ``models.train.masked_mse`` on the first shard's device. Autograd
    reverses the KV ring (the transpose of a ring shift is the opposite
    shift) into each shard's own copy of the params, and one ``psum`` of
    the shards' flattened gradients, in shard order, becomes the state's
    gradients before the AdamW step. ``remat=True`` recomputes the
    forward's activations in the backward (``torch.utils.checkpoint``,
    non-reentrant, over the whole sharded forward). As the port's other
    train steps, the step updates the state's tensors in place (JAX
    donates the state); the state's params also keep the summed
    gradients in ``.grad``.
    """
    devices = axis_devices(mesh, axis_name)
    core = ring_core(devices, compute_dtype)
    forward = functools.partial(sharded_predict, devices=devices, core=core,
                                clamp=False, compute_dtype=compute_dtype)
    run = (functools.partial(checkpoint, forward, use_reentrant=False)
           if remat else forward)

    def train_step(state: TrainState, feat_hist: torch.Tensor,
                   workload_valid: torch.Tensor, t_valid: torch.Tensor,
                   target_watts: torch.Tensor,
                   label_valid: torch.Tensor | None = None
                   ) -> tuple[TrainState, torch.Tensor]:
        hist, tv, wv, lead = _blocks(feat_hist, workload_valid, t_valid,
                                     devices)
        keys = list(state.params)
        # each shard its own autograd leaves over its device's copy (on
        # the params' own device, their storage: nothing is copied)
        replicas = [None if r is None else
                    {k: v.detach().requires_grad_(True)
                     for k, v in r.items()}
                    for r in replicate(state.params, devices)]
        pred = run(replicas, hist, tv, wv).reshape(*lead, -1)
        first = local_indices(devices)[0]
        dev0 = devices[first]
        loss = masked_mse(
            pred, target_watts.to(dev0), workload_valid.to(dev0),
            None if label_valid is None else label_valid.to(dev0))
        # the first shard's rank seeds the backward; any other rank seeds
        # zeros, to run the collectives' transposes beside it
        loss.backward(None if first == 0 else torch.zeros_like(loss))
        # the gradient all-reduce: each shard's gradients flattened, one
        # psum in shard order (a leaf a shard never used adds zeros)
        flat = local_map(devices, lambda i: torch.cat([
            (replicas[i][k].grad if replicas[i][k].grad is not None
             else torch.zeros_like(replicas[i][k])).reshape(-1)
            for k in keys]))
        total = psum(flat, devices)[first]
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        offset = 0
        for k in keys:
            p = state.params[k]
            p.grad = total[offset:offset + p.numel()].view_as(p).to(
                p.device)
            offset += p.numel()
        opt.step()
        return TrainState(state.params, opt, state.step + 1), loss.detach()

    return train_step
