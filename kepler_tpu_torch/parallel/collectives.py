"""Collectives over the shards of one mesh axis, in one process.

The counterpart of the ``lax`` collectives that the JAX package's parallel
families call inside ``shard_map`` (``ppermute``, ``all_to_all``,
``all_gather``, ``psum``). The JAX families are single-controller
programs over one process's devices; so are these. A family holds one
tensor per shard of an axis, in axis order, and each collective takes
that list and the shards' devices and returns the list each shard
receives, every result on its destination shard's device.

Every result is a copy, also between two virtual shards of one device:
a receiving shard never aliases a tensor its sender holds. The
collectives are built from indexing, ``cat``, ``sum`` and ``.to``, so
autograd differentiates them; the transpose of a ring shift is the
reverse shift, as in JAX.

A mesh whose shards belong to other processes has no counterpart here:
:func:`axis_devices` and :func:`grid_devices` refuse it (the families'
cross-process collectives are not ported).
"""

from __future__ import annotations

from typing import Sequence

import torch

from kepler_tpu_torch.parallel.mesh import Mesh, process_index

Tensors = Sequence[torch.Tensor]
Devices = Sequence[torch.device]


def _local(mesh: Mesh) -> None:
    me = process_index()
    if any(p != me for p in mesh.processes):
        raise ValueError(
            "the parallel families run over this process's shards only: "
            f"mesh processes {sorted(set(mesh.processes))}, this process "
            f"{me} (cross-process collectives for the families are not "
            "ported)")


def axis_devices(mesh: Mesh, axis: str) -> list[torch.device]:
    """The devices of a 1-D mesh over ``axis``, in axis order. Raises
    ValueError for another axis, more axes, or shards of another
    process."""
    if mesh.axes != (axis,):
        raise ValueError(f"a 1-D mesh over {axis!r} is needed, got axes "
                         f"{mesh.axes}")
    _local(mesh)
    return list(mesh.devices)


def grid_devices(mesh: Mesh, axes: tuple[str, str]) -> list[list[torch.device]]:
    """The devices of a 2-D mesh over ``axes`` as rows over the first
    axis, each row in order over the second (the mesh's row-major
    order). Raises ValueError as :func:`axis_devices`."""
    if mesh.axes != axes:
        raise ValueError(f"a 2-D mesh over {axes} is needed, got axes "
                         f"{mesh.axes}")
    _local(mesh)
    rows, cols = mesh.shape
    return [list(mesh.devices[r * cols:(r + 1) * cols]) for r in range(rows)]


def _put(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    return x.to(device, copy=True)


def ppermute(xs: Sequence[torch.Tensor | None], devices: Devices,
             shift: int = 1) -> list[torch.Tensor | None]:
    """Ring shift: shard ``i`` sends to shard ``(i + shift) % n`` →
    what each shard receives. A shard with nothing to send holds None
    (its receiver gets None)."""
    n = len(xs)
    return [None if xs[(j - shift) % n] is None
            else _put(xs[(j - shift) % n], devices[j]) for j in range(n)]


def all_to_all(xs: Tensors, devices: Devices, split_axis: int,
               concat_axis: int, tiled: bool = True) -> list[torch.Tensor]:
    """Shard ``i`` splits its tensor into n chunks along ``split_axis``
    and sends chunk ``j`` to shard ``j``; shard ``j`` joins what it
    receives in source order along ``concat_axis`` (``tiled=True``), or
    stacks it on a new ``concat_axis`` after dropping ``split_axis``,
    whose size must be n (``tiled=False``): ``lax.all_to_all``'s two
    forms."""
    n = len(xs)
    if tiled:
        parts = [torch.chunk(x, n, dim=split_axis) for x in xs]
        return [torch.cat([_put(parts[i][j], devices[j]) for i in range(n)],
                          dim=concat_axis) for j in range(n)]
    return [torch.stack([_put(x.select(split_axis, j), devices[j])
                         for x in xs], dim=concat_axis) for j in range(n)]


def all_gather(xs: Tensors, devices: Devices, axis: int = 0
               ) -> list[torch.Tensor]:
    """Every shard receives all shards' tensors joined along ``axis`` in
    shard order (``lax.all_gather(..., tiled=True)``)."""
    return [torch.cat([_put(x, d) for x in xs], dim=axis) for d in devices]


def psum(xs: Tensors, devices: Devices) -> list[torch.Tensor]:
    """Every shard receives the sum of all shards' tensors, added in
    shard order."""
    out = []
    for d in devices:
        total = _put(xs[0], d)
        for x in xs[1:]:
            total = total + _put(x, d)
        out.append(total)
    return out
