"""Collectives over the shards of one mesh axis, in one process or across
processes.

The counterpart of the ``lax`` collectives that the JAX package's parallel
families call inside ``shard_map`` (``ppermute``, ``all_to_all``,
``all_gather``, ``psum``), and ``broadcast``: one shard's tensor to
every shard, where JAX masks every other shard's buffer and takes a
``psum`` (the same values, without n slots of traffic). A family holds
one tensor per shard of an axis, in axis order, and each collective
takes that list and the shards' devices and returns the list each shard
receives, every result on its destination shard's device. Each reports
its name to an active program recorder (``ops.recorder``), as a ``lax``
collective shows in a jaxpr, whichever way its tensors travel.

**In one process** every result is a copy, also between two virtual
shards of one device: a receiving shard never aliases a tensor its
sender holds. The collectives are built from indexing, ``cat``, ``sum``
and ``.to``, so autograd differentiates them; the transpose of a ring
shift is the reverse shift, as in JAX.

**Across processes.** A mesh built after ``mesh.initialize_multihost``
may hold the shards of several ranks, as JAX's global mesh holds every
host's devices. :func:`axis_devices` and :func:`grid_devices` then
return :class:`AxisDevices`: the devices with the rank that launches
each shard. Each rank runs a family's body for its own shards only
(:func:`local_indices`, :func:`local_map`): a list it passes holds its
shards' tensors and None at the slots of other ranks' shards, and so
does the list it gets back. What stays in the process takes the copy
path above; what crosses goes through ``torch.distributed``:

- ``ppermute``: ``batch_isend_irecv`` between the ranks of each
  crossing source/target pair, a small header first (a tensor or None,
  its dtype and shape), so a receiver learns what arrives;
- ``all_to_all``: one ``all_to_all_single`` over the axis' ranks;
- ``all_gather``: one ``all_gather_into_tensor`` of each rank's shards;
- ``psum``: one ``all_reduce(SUM)`` over a stack with a slot per shard,
  filled by the shard's rank and ``-0.0`` elsewhere (``x + -0.0 == x``
  for every x, a ``-0.0`` included), then the one-process sum in shard
  order: the result is bit-equal to the one-process result, at the cost
  of n slots of traffic.
- ``broadcast``: a header, then one ``broadcast`` from the source
  shard's rank over the axis' ranks.

CPU tensors travel over gloo and CUDA tensors over NCCL, the two
backends of the group ``initialize_multihost(device=...)`` joins. A CUDA
tensor in a group without NCCL raises: nothing falls back to the host.
gloo takes bf16 as f32 and NCCL and gloo take bools as uint8, both
exact. Each crossing collective is one autograd node whose backward is
the transposed collective (the reverse shift, the reverse all_to_all, a
psum then a slice for all_gather, a psum for psum), so every rank of an
axis runs the same backward: a rank whose outputs feed no loss
backpropagates a zero seed. Every rank calls an axis' collectives in the
same order, with the same shapes and dtypes on every shard (SPMD, as JAX
requires); otherwise they wait on each other until the group's timeout
raises. A rank that owns no shard of an axis does not call its
collectives. :data:`CROSSING` counts the calls that crossed and the
bytes each rank handed to ``torch.distributed`` to send.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.distributed as dist

from kepler_tpu_torch.ops import recorder
from kepler_tpu_torch.parallel.mesh import Mesh, process_index

Tensors = Sequence[torch.Tensor]
Devices = Sequence[torch.device]

#: per collective: the calls that crossed processes and the bytes this
#: rank handed to ``torch.distributed`` for them (headers included)
CROSSING: dict[str, dict[str, int]] = {
    name: {"calls": 0, "bytes": 0}
    for name in ("ppermute", "all_to_all", "all_gather", "psum",
                 "broadcast")}


def reset_crossing() -> None:
    """Zero :data:`CROSSING`."""
    for row in CROSSING.values():
        row.update(calls=0, bytes=0)


class AxisDevices(list):
    """An axis' devices in axis order (a list of ``torch.device``) and,
    in ``ranks``, the rank that launches each shard. A plain list of
    devices is an axis of this process's shards."""

    def __init__(self, devices: Devices, ranks: Sequence[int]) -> None:
        super().__init__(devices)
        self.ranks = tuple(int(r) for r in ranks)


def ranks_of(devices: Devices) -> tuple[int, ...]:
    """The rank of each shard of the axis ``devices``."""
    ranks = getattr(devices, "ranks", None)
    return ranks if ranks is not None else (process_index(),) * len(devices)


def local_indices(devices: Devices) -> list[int]:
    """The axis positions of the shards this rank launches, in order."""
    me = process_index()
    return [i for i, r in enumerate(ranks_of(devices)) if r == me]


def local_map(devices: Devices, fn: Callable[[int], object]) -> list:
    """``fn(i)`` at each of this rank's axis positions, None at the
    others': a list of the families' per-shard form."""
    mine = set(local_indices(devices))
    return [fn(i) if i in mine else None for i in range(len(devices))]


def crosses(devices: Devices) -> bool:
    """True when shards of the axis belong to another rank."""
    me = process_index()
    return any(r != me for r in ranks_of(devices))


def _joined(mesh: Mesh) -> None:
    procs, me = sorted(set(mesh.processes)), process_index()
    if procs == [me]:
        return
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world == 1 or procs[-1] >= world:
        raise ValueError(
            f"mesh processes {procs} need cross-process collectives over "
            "a joined torch.distributed group holding them "
            "(mesh.initialize_multihost); this process "
            + (f"joined a group of {world}" if world > 1 else "joined none"))
    if me not in procs:
        raise ValueError(f"rank {me} owns no shard of the mesh (ranks "
                         f"{procs}): it has nothing to run")


def axis_devices(mesh: Mesh, axis: str) -> AxisDevices:
    """The devices of a 1-D mesh over ``axis``, in axis order, with each
    shard's rank. Raises ValueError for another axis, more axes, or
    shards of processes this one has not joined."""
    if mesh.axes != (axis,):
        raise ValueError(f"a 1-D mesh over {axis!r} is needed, got axes "
                         f"{mesh.axes}")
    _joined(mesh)
    return AxisDevices(mesh.devices, mesh.processes)


def grid_devices(mesh: Mesh, axes: tuple[str, str]) -> list[AxisDevices]:
    """The devices of a 2-D mesh over ``axes`` as rows over the first
    axis, each row in order over the second (the mesh's row-major
    order). Raises ValueError as :func:`axis_devices`."""
    if mesh.axes != axes:
        raise ValueError(f"a 2-D mesh over {axes} is needed, got axes "
                         f"{mesh.axes}")
    _joined(mesh)
    rows, cols = mesh.shape
    return [AxisDevices(mesh.devices[r * cols:(r + 1) * cols],
                        mesh.processes[r * cols:(r + 1) * cols])
            for r in range(rows)]


def _put(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    return x.to(device, copy=True)


# -- the wire ------------------------------------------------------------------

_GROUPS: dict = {}


def _group(ranks: Sequence[int]):
    """The process group of the ranks ``ranks`` (the world's default
    group when they are all of it), made once by its members."""
    members = tuple(sorted(set(ranks)))
    if len(members) == dist.get_world_size():
        return None
    world = dist.group.WORLD
    if _GROUPS.get("world") is not world:
        _GROUPS.clear()
        _GROUPS["world"] = world
    if members not in _GROUPS:
        _GROUPS[members] = dist.new_group(list(members),
                                          use_local_synchronization=True)
    return _GROUPS[members]


def _wire_dtype(dtype: torch.dtype, device: torch.device) -> torch.dtype:
    """What a ``dtype`` tensor on ``device`` travels as: bools as uint8,
    bf16 over gloo (a CPU tensor) as f32, the rest as they are."""
    if dtype == torch.bool:
        return torch.uint8
    if dtype == torch.bfloat16 and device.type == "cpu":
        return torch.float32
    return dtype


def _wire(x: torch.Tensor) -> torch.Tensor:
    """``x`` as it travels: CPU over gloo, CUDA over NCCL (raises when
    the group has no NCCL)."""
    if x.device.type == "cuda" and "nccl" not in str(dist.get_backend()):
        raise RuntimeError(
            f"a CUDA tensor crosses processes over NCCL, and this process "
            f"group ({dist.get_backend()}) has none: join with "
            "initialize_multihost(device='cuda')")
    return x.to(_wire_dtype(x.dtype, x.device)).contiguous()


def _count(name: str, *sent: torch.Tensor) -> None:
    CROSSING[name]["calls"] += 1
    CROSSING[name]["bytes"] += sum(t.numel() * t.element_size()
                                   for t in sent)


_DTYPES = (torch.float32, torch.float64, torch.float16, torch.bfloat16,
           torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
           torch.bool)
_HEAD = 12  # present, dtype index, ndim, up to 9 dims


def _header(x: torch.Tensor | None) -> torch.Tensor:
    head = torch.zeros(_HEAD, dtype=torch.int64)
    if x is not None:
        head[:3] = torch.tensor([1, _DTYPES.index(x.dtype), x.dim()])
        head[3:3 + x.dim()] = torch.tensor(x.shape, dtype=torch.int64)
    return head


def _p2p(sends: list, recvs: list, group) -> None:
    """Post every ``(peer, tensor)`` send and receive at once, then wait
    for all of them."""
    ops = ([dist.P2POp(dist.isend, t, peer, group) for peer, t in sends]
           + [dist.P2POp(dist.irecv, t, peer, group) for peer, t in recvs])
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()


class _Crossing(torch.autograd.Function):
    """A crossing collective as one autograd node: ``run`` maps the
    per-shard list forward, ``transpose`` maps the gradients back; a
    recorder sees each as one ``crossing:<name>`` op."""

    @staticmethod
    def forward(ctx, name, run, transpose, *slots):
        ctx.name, ctx.transpose = name, transpose
        ctx.set_materialize_grads(False)
        with recorder.crossing(name):
            return tuple(run(list(slots)))

    @staticmethod
    def backward(ctx, *grads):
        with recorder.crossing(ctx.name):
            return (None, None, None, *ctx.transpose(list(grads)))


def _crossing(name: str, run, transpose, slots) -> list:
    return list(_Crossing.apply(name, run, transpose, *slots))


def _blank(xs: list, devices: Devices, blank: tuple | None) -> list:
    """``xs`` with this rank's missing gradients as zeros of ``blank``
    (shape, dtype): a rank whose outputs fed nothing still joins the
    transpose."""
    if blank is None:
        return xs
    shape, dtype = blank
    return local_map(devices, lambda i: xs[i] if xs[i] is not None else
                     torch.zeros(shape, dtype=dtype, device=devices[i]))


# -- ppermute -------------------------------------------------------------------


def _ppermute_wire(xs: list, devices: Devices, shift: int) -> list:
    n = len(devices)
    ranks, me = ranks_of(devices), process_index()
    mine = local_indices(devices)
    out: list = [None] * n
    sends, recvs = [], []  # ordered by receiving shard on both sides
    for j in mine:
        i = (j - shift) % n
        if ranks[i] == me:
            out[j] = None if xs[i] is None else _put(xs[i], devices[j])
        else:
            recvs.append((j, ranks[i]))
    for i in mine:
        j = (i + shift) % n
        if ranks[j] != me:
            sends.append((j, ranks[j], xs[i]))
    sends.sort(key=lambda s: s[0])
    recvs.sort()
    group = _group(ranks)
    heads = [torch.empty(_HEAD, dtype=torch.int64) for _ in recvs]
    sent_heads = [(peer, _header(x)) for _, peer, x in sends]
    _p2p(sent_heads, [(peer, h) for (_, peer), h in zip(recvs, heads)], group)
    payload = [(peer, _wire(x)) for _, peer, x in sends if x is not None]
    bufs = []
    for (j, peer), head in zip(recvs, heads):
        if head[0]:
            dtype = _DTYPES[int(head[1])]
            shape = head[3:3 + int(head[2])].tolist()
            dev = devices[j]
            bufs.append((j, peer, torch.empty(
                shape, dtype=_wire_dtype(dtype, dev), device=dev), dtype))
    _p2p(payload, [(peer, buf) for _, peer, buf, _ in bufs], group)
    for j, _, buf, dtype in bufs:
        out[j] = buf.to(dtype)
    _count("ppermute", *(h for _, h in sent_heads), *(t for _, t in payload))
    return out


def ppermute(xs: Sequence[torch.Tensor | None], devices: Devices,
             shift: int = 1) -> list[torch.Tensor | None]:
    """Ring shift: shard ``i`` sends to shard ``(i + shift) % n`` →
    what each shard receives. A shard with nothing to send holds None
    (its receiver gets None)."""
    n = len(xs)
    recorder.collective("ppermute", n)
    if crosses(devices):
        return _crossing(
            "ppermute", lambda s: _ppermute_wire(s, devices, shift),
            lambda g: _ppermute_wire(g, devices, -shift), xs)
    return [None if xs[(j - shift) % n] is None
            else _put(xs[(j - shift) % n], devices[j]) for j in range(n)]


# -- all_to_all -----------------------------------------------------------------


def _all_to_all_wire(xs: list, devices: Devices, split_axis: int,
                     concat_axis: int, tiled: bool) -> list:
    n = len(devices)
    ranks, me = ranks_of(devices), process_index()
    mine = local_indices(devices)
    members = sorted(set(ranks))
    owned = {r: [i for i in range(n) if ranks[i] == r] for r in members}
    parts = {i: (torch.chunk(xs[i], n, dim=split_axis) if tiled else
                 [xs[i].select(split_axis, j) for j in range(n)])
             for i in mine}
    chunk = parts[mine[0]][0]
    # to rank q: for each of my shards i, for each of q's shards j, chunk
    # (i, j); from q the same order with the roles swapped
    send, in_splits, out_splits = [], [], []
    for q in members:
        seg = ([] if q == me else
               [_wire(parts[i][j]).reshape(-1) for i in mine
                for j in owned[q]])
        send += seg
        in_splits.append(sum(s.numel() for s in seg))
        out_splits.append(0 if q == me else
                          len(owned[q]) * len(mine) * chunk.numel())
    dev, wdt = chunk.device, _wire_dtype(chunk.dtype, chunk.device)
    inp = torch.cat(send) if send else torch.empty(0, dtype=wdt, device=dev)
    got = torch.empty(sum(out_splits), dtype=wdt, device=dev)
    dist.all_to_all_single(got, inp, out_splits, in_splits,
                           group=_group(ranks))
    _count("all_to_all", inp)
    recv, at = {}, 0
    for q in members:
        if q == me:
            continue
        for i in owned[q]:
            for j in mine:
                recv[i, j] = got[at:at + chunk.numel()].view(
                    chunk.shape).to(chunk.dtype)
                at += chunk.numel()
    out: list = [None] * n
    join = torch.cat if tiled else torch.stack
    for j in mine:
        out[j] = join([_put(parts[i][j] if ranks[i] == me else recv[i, j],
                            devices[j]) for i in range(n)], dim=concat_axis)
    return out


def all_to_all(xs: Tensors, devices: Devices, split_axis: int,
               concat_axis: int, tiled: bool = True) -> list[torch.Tensor]:
    """Shard ``i`` splits its tensor into n chunks along ``split_axis``
    and sends chunk ``j`` to shard ``j``; shard ``j`` joins what it
    receives in source order along ``concat_axis`` (``tiled=True``), or
    stacks it on a new ``concat_axis`` after dropping ``split_axis``,
    whose size must be n (``tiled=False``): ``lax.all_to_all``'s two
    forms. Raises ValueError when ``split_axis`` does not split into n
    equal chunks."""
    n = len(xs)
    recorder.collective("all_to_all", n)
    size = next(x for x in xs if x is not None).shape[split_axis]
    if (size % n) if tiled else (size != n):
        raise ValueError(f"all_to_all: axis {split_axis} of size {size} "
                         f"does not split into {n} equal chunks")
    if crosses(devices):
        return _crossing(
            "all_to_all",
            lambda s: _all_to_all_wire(s, devices, split_axis, concat_axis,
                                       tiled),
            lambda g: _all_to_all_wire(g, devices, concat_axis, split_axis,
                                       tiled), xs)
    if tiled:
        parts = [torch.chunk(x, n, dim=split_axis) for x in xs]
        return [torch.cat([_put(parts[i][j], devices[j]) for i in range(n)],
                          dim=concat_axis) for j in range(n)]
    return [torch.stack([_put(x.select(split_axis, j), devices[j])
                         for x in xs], dim=concat_axis) for j in range(n)]


# -- all_gather -----------------------------------------------------------------


def _all_gather_wire(xs: list, devices: Devices, axis: int) -> list:
    n = len(devices)
    ranks = ranks_of(devices)
    mine = local_indices(devices)
    members = sorted(set(ranks))
    owned = {r: [i for i in range(n) if ranks[i] == r] for r in members}
    width = max(len(v) for v in owned.values())
    ref = xs[mine[0]]
    stack = torch.zeros((width, *ref.shape), dtype=ref.dtype,
                        device=ref.device)
    for p, i in enumerate(mine):
        stack[p] = xs[i]
    stack = _wire(stack)
    got = torch.empty((len(members) * width, *ref.shape), dtype=stack.dtype,
                      device=ref.device)
    dist.all_gather_into_tensor(got, stack, group=_group(ranks))
    _count("all_gather", stack)
    got = got.to(ref.dtype)
    slot = {i: members.index(r) * width + p
            for r, own in owned.items() for p, i in enumerate(own)}
    whole = torch.cat([got[slot[i]] for i in range(n)], dim=axis)
    del got
    # the first shard takes the gathered tensor itself, the others copies
    return local_map(devices, lambda j: whole if j == mine[0]
                     else _put(whole, devices[j]))


def all_gather(xs: Tensors, devices: Devices, axis: int = 0
               ) -> list[torch.Tensor]:
    """Every shard receives all shards' tensors joined along ``axis`` in
    shard order (``lax.all_gather(..., tiled=True)``)."""
    recorder.collective("all_gather", len(xs))
    if crosses(devices):
        ref = next(x for x in xs if x is not None)
        size = ref.shape[axis]
        whole = (*ref.shape[:axis], size * len(xs), *ref.shape[axis + 1:])

        def transpose(grads):  # each shard's slice of the summed wholes
            total = _psum_wire(grads, devices, (whole, ref.dtype))
            return local_map(devices, lambda i: total[i].narrow(
                axis, i * size, size))

        return _crossing("all_gather",
                         lambda s: _all_gather_wire(s, devices, axis),
                         transpose, xs)
    return [torch.cat([_put(x, d) for x in xs], dim=axis) for d in devices]


def gather_whole(xs: Sequence[torch.Tensor | None], devices: Devices,
                 axis: int = 0) -> torch.Tensor:
    """The shards' tensors joined along ``axis`` in shard order, on this
    rank's first shard's device: a ``cat`` in one process, an
    :func:`all_gather` across ranks (JAX's replicated ``out_shardings``:
    every rank gets the whole)."""
    if not crosses(devices):
        return torch.cat([x.to(devices[0]) for x in xs], dim=axis)
    return all_gather(xs, devices, axis)[local_indices(devices)[0]]


# -- broadcast ------------------------------------------------------------------


def _broadcast_wire(xs: list, devices: Devices, src: int) -> list:
    ranks, me = ranks_of(devices), process_index()
    mine = local_indices(devices)
    group = _group(ranks)
    sender = ranks[src] == me
    head = _header(xs[src]) if sender else torch.empty(_HEAD,
                                                       dtype=torch.int64)
    dist.broadcast(head, src=ranks[src], group=group)
    if sender:
        whole = xs[src]
        wired = _wire(whole)
        dist.broadcast(wired, src=ranks[src], group=group)
        _count("broadcast", head, wired)
    else:
        dtype = _DTYPES[int(head[1])]
        dev = devices[mine[0]]
        wired = torch.empty(head[3:3 + int(head[2])].tolist(),
                            dtype=_wire_dtype(dtype, dev), device=dev)
        dist.broadcast(wired, src=ranks[src], group=group)
        _count("broadcast")
        whole = wired.to(dtype)
    # the first shard of a receiving rank takes the received tensor itself
    return local_map(devices, lambda j: whole if j == mine[0] and not sender
                     else _put(whole, devices[j]))


def broadcast(xs: Sequence[torch.Tensor | None], devices: Devices,
              src: int) -> list[torch.Tensor]:
    """Every shard receives shard ``src``'s tensor (the other slots are
    not read and may be None)."""
    recorder.collective("broadcast", len(xs))
    if crosses(devices):
        blank: list = []  # (shape, dtype) of what arrived, for the transpose

        def run(slots):
            out = _broadcast_wire(slots, devices, src)
            got = out[local_indices(devices)[0]]
            blank.append((got.shape, got.dtype))
            return out

        def transpose(grads):  # the summed gradients, back to ``src``
            total = _psum_wire(grads, devices, blank[0])
            return local_map(devices, lambda i: total[i] if i == src
                             else None)

        return _crossing("broadcast", run, transpose, xs)
    return [_put(xs[src], d) for d in devices]


# -- psum -----------------------------------------------------------------------


def _psum_wire(xs: list, devices: Devices, blank: tuple | None = None
               ) -> list:
    xs = _blank(xs, devices, blank)
    n = len(devices)
    mine = local_indices(devices)
    ref = xs[mine[0]]
    pad = -0.0 if ref.dtype.is_floating_point else 0
    stack = torch.full((n, *ref.shape), pad, dtype=ref.dtype,
                       device=ref.device)
    for i in mine:
        stack[i] = xs[i]
    wired = _wire(stack)
    dist.all_reduce(wired, group=_group(ranks_of(devices)))
    _count("psum", wired)
    stack = wired.to(ref.dtype)
    total = stack[0]
    for i in range(1, n):
        total = total + stack[i]
    return local_map(devices, lambda j: _put(total, devices[j]))


def psum(xs: Tensors, devices: Devices) -> list[torch.Tensor]:
    """Every shard receives the sum of all shards' tensors, added in
    shard order."""
    recorder.collective("psum", len(xs))
    if crosses(devices):
        ref = next(x for x in xs if x is not None)
        return _crossing("psum", lambda s: _psum_wire(s, devices),
                         lambda g: _psum_wire(g, devices,
                                              (ref.shape, ref.dtype)), xs)
    out = []
    for d in devices:
        total = _put(xs[0], d)
        for x in xs[1:]:
            total = total + _put(x, d)
        out.append(total)
    return out
