"""Device meshes and the multi-process join.

The counterpart of ``kepler_tpu.parallel.mesh``. The scaling axes are the
reference's:

- ``node``  — the fleet's node axis: each shard attributes a slice of the
  cluster's nodes with its own resident buffers and its own launches;
- ``model`` — the estimator's hidden dimension (a 2-D ``node × model``
  mesh; the port's window engines run such a mesh unsharded on its first
  shard's device).

A :class:`Mesh` is an ordered tuple of :class:`Shard` s, each a
``torch.device`` and the rank of the process that launches on it.
Shard identity is the shard's INDEX, never its device: several shards
may name the same device (virtual shards, the counterpart of the
reference's forced host device count), and each still keeps its own
buffers and launches. A mesh built after :func:`initialize_multihost`
holds every rank's shards, as JAX's global mesh holds every host's
devices; :func:`local_shards` names the ones this rank launches.

The packed fleet window has no cross-node math, so no tensor of a window
ever crosses processes: each process launches its own shards, and the
only cross-process traffic is the tiny bucket-need agreement over gloo.
The parallel families' tensors cross processes through
``parallel.collectives``: CPU tensors over gloo, CUDA tensors over NCCL
(``initialize_multihost(device=...)``).
"""

from __future__ import annotations

import logging
import math
import os
from datetime import timedelta
from typing import Callable, NamedTuple, Sequence

import torch

from kepler_tpu_torch.device import resolve_device

NODE_AXIS = "node"
MODEL_AXIS = "model"

log = logging.getLogger("kepler.parallel.mesh")


class Shard(NamedTuple):
    """One mesh entry: the device its buffers live on and the process
    that launches on it."""

    device: torch.device
    process: int = 0


class Mesh(NamedTuple):
    """Shards in mesh order (row-major over ``shape``), with the mesh's
    ``shape`` and axis names."""

    shards: tuple[Shard, ...]
    shape: tuple[int, ...]
    axes: tuple[str, ...]

    @property
    def size(self) -> int:
        return len(self.shards)

    @property
    def devices(self) -> tuple[torch.device, ...]:
        """Each shard's device, in shard order (repeats allowed)."""
        return tuple(s.device for s in self.shards)

    @property
    def processes(self) -> tuple[int, ...]:
        """Each shard's process index, in shard order."""
        return tuple(s.process for s in self.shards)

    def axis_size(self, axis: str) -> int:
        """Size of ``axis`` (0 when the mesh has no such axis)."""
        return dict(zip(self.axes, self.shape)).get(axis, 0)

    def describe(self) -> dict[str, int]:
        """``{axis: size}`` — the reference's ``dict(mesh.shape)``."""
        return dict(zip(self.axes, self.shape))

    def with_processes(self, process_of: Callable[[int], int]) -> "Mesh":
        """The same mesh with shard ``k``'s process set to
        ``process_of(k)`` (a virtual multi-process topology)."""
        return self._replace(shards=tuple(
            Shard(s.device, int(process_of(k)))
            for k, s in enumerate(self.shards)))


def local_shards(mesh: Mesh) -> tuple[int, ...]:
    """The indices of the shards of ``mesh`` this rank launches, in mesh
    order (every shard in a mesh of one process)."""
    me = process_index()
    return tuple(k for k, s in enumerate(mesh.shards) if s.process == me)


class MultihostInit(NamedTuple):
    """Outcome of :func:`initialize_multihost` — truthy iff the process
    joined a cluster, with the DISTINCT failure reason preserved so a
    half-joined mesh is diagnosable from the return value, the log, and
    the ``fleet-window`` health probe (not a generic decline).

    ``reason`` is one of the bounded labels below; ``detail`` carries
    the underlying error text (bounded) when one exists.
    """

    joined: bool
    reason: str  # joined | unconfigured | coordinator_unreachable | init_error
    detail: str = ""
    num_processes: int = 1
    process_id: int = 0

    def __bool__(self) -> bool:  # callers truth-test it
        return self.joined


#: the last initialize_multihost outcome in this process ("never called"
#: reads as an unconfigured single-host decline) — the health probe's view
_last_init: MultihostInit = MultihostInit(False, "unconfigured")


def multihost_status() -> MultihostInit:
    """The last :func:`initialize_multihost` outcome in this process."""
    return _last_init


def process_index() -> int:
    """This process's rank in the joined job (0 when none was joined)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank())
    return 0


def _world() -> tuple[int, int]:
    """(rank, world size) of the joined job; (0, 1) when none."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank()), int(dist.get_world_size())
    return 0, 1


# error-text markers that mean "the coordinator never answered" (the
# store client's timeout/connectivity vocabulary) — anything else is an
# init_error, a different operator problem entirely
_UNREACHABLE_MARKERS = ("deadline_exceeded", "deadline exceeded",
                        "unavailable", "timed out", "timeout",
                        "failed to connect", "connection refused",
                        "distnetworkerror")


def _classify_init_error(err: BaseException) -> str:
    text = f"{type(err).__name__}: {err}".lower()
    if any(m in text for m in _UNREACHABLE_MARKERS):
        return "coordinator_unreachable"
    return "init_error"


#: pre-probe and join bound when no init_timeout is configured
_DEFAULT_JOIN_DEADLINE_S = 300.0
#: the coordinator port torch uses when MASTER_PORT is unset
_DEFAULT_MASTER_PORT = 29500


def _wait_coordinator(addr: str, deadline_s: float) -> bool:
    """Poll a TCP connect to the coordinator until ``deadline_s``.

    Non-zero ranks probe before joining, so an unreachable coordinator
    is a diagnosable ``coordinator_unreachable`` decline within the
    deadline instead of a join that blocks inside the store client.
    Retries absorb the normal startup race where rank 0 hasn't bound
    its port yet."""
    import socket
    import time

    host, _, port_s = addr.rpartition(":")
    try:
        port = int(port_s)
    except ValueError:
        return True  # unparseable → let the join produce its own error
    host = host.strip("[]") or "127.0.0.1"
    deadline = time.monotonic() + max(1.0, deadline_s)
    while True:
        try:
            with socket.create_connection((host, port), timeout=2.0):
                return True
        except OSError:
            if time.monotonic() >= deadline:
                return False
            time.sleep(min(0.5, max(0.05,
                                    deadline - time.monotonic())))


def _visible_devices(device: str | torch.device) -> list[Shard]:
    """Every visible device of ``device``'s type, over every process of
    the joined job in rank order (one gloo ``all_gather`` of the local
    counts): ``torch.cuda.device_count()`` entries per process for
    ``cuda``, one for ``cpu``."""
    dev = resolve_device(device)
    local = torch.cuda.device_count() if dev.type == "cuda" else 1
    _rank, world = _world()
    counts = {0: local}
    if world > 1:
        gathered = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
        torch.distributed.all_gather(
            gathered, torch.tensor([local], dtype=torch.int64))
        counts = {p: int(c.item()) for p, c in enumerate(gathered)}
    return [Shard(torch.device("cuda", i) if dev.type == "cuda"
                  else torch.device("cpu"), proc)
            for proc, n in counts.items() for i in range(n)]


def make_mesh(
    mesh_shape: Sequence[int] = (),
    axes: Sequence[str] = (NODE_AXIS,),
    devices: Sequence[Shard | torch.device | str] | None = None,
    device: str | torch.device = "cuda",
) -> Mesh:
    """Build a mesh; empty shape = all devices on the first axis.

    ``devices=None`` means every visible device of ``device``'s type (on a
    joined job, every process's, in rank order). ``devices`` may repeat
    a device (virtual shards). ``mesh_shape`` may contain one ``-1``
    (inferred). Axis count must match shape length (after defaulting).
    Raises when a shard names CUDA and no CUDA device is present.
    """
    if devices is None:
        shards = _visible_devices(device)
    else:
        me = process_index()
        shards = [d if isinstance(d, Shard) else Shard(d, me)
                  for d in devices]
        shards = [Shard(resolve_device(s.device), int(s.process))
                  for s in shards]
    n = len(shards)
    if not mesh_shape:
        mesh_shape = [n] + [1] * (len(axes) - 1)
    shape = list(mesh_shape)
    if shape.count(-1) > 1:
        raise ValueError("at most one -1 in mesh_shape")
    if -1 in shape:
        known = math.prod(s for s in shape if s != -1)
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        shape[shape.index(-1)] = n // known
    if math.prod(shape) != n:
        raise ValueError(
            f"mesh shape {shape} needs {math.prod(shape)} devices, "
            f"have {n}")
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} vs axes {axes} rank mismatch")
    return Mesh(tuple(shards), tuple(int(s) for s in shape), tuple(axes))


def submesh_for_processes(
    mesh: Mesh,
    processes: Sequence[int],
    device_process: Callable[[int], int] | None = None,
) -> Mesh:
    """A 1-D node mesh over the subset of ``mesh``'s shards owned by
    ``processes`` — the elastic-membership rebuild primitive: after a
    host death the survivors rebuild their multi-host window engine
    over exactly the surviving processes' shards (and a rejoin rebuilds
    over the full set again). Shard order is preserved, so every process
    derives the identical shard order with no coordination.

    ``device_process`` maps a shard INDEX to its process (defaults to
    the shard's own ``process``); the kept shards carry that process.
    Degenerate cases fail loudly: an empty retained set has no mesh to
    build.
    """
    keep = {int(p) for p in processes}
    if device_process is None:
        def device_process(k: int) -> int:
            return mesh.shards[k].process
    kept = [Shard(s.device, int(device_process(k)))
            for k, s in enumerate(mesh.shards)
            if int(device_process(k)) in keep]
    if not kept:
        raise ValueError(
            f"no devices of the mesh belong to processes "
            f"{sorted(keep)!r}")
    return make_mesh([len(kept)], (NODE_AXIS,), devices=kept)


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    init_timeout: float | None = None,
    device: str | torch.device | None = None,
) -> MultihostInit:
    """Join a multi-process job (``torch.distributed``) so meshes span
    every process's devices — the scale-out leg beyond one aggregator
    host.

    Report ingest stays HTTP behind a load balancer; each process
    launches only its own shards, and the processes agree on bucket
    needs (a few integers) through the gloo process group. ``device``
    names where the parallel families' tensors live: None or ``cpu``
    joins gloo alone; a CUDA device joins ``cpu:gloo,cuda:nccl`` with
    NCCL bound to that device (``device_id``), so CPU tensors travel
    over gloo and CUDA tensors over NCCL. On a CUDA device a failed join
    RAISES RuntimeError naming its reason (NCCL's refusal is its cause):
    nothing falls back to gloo.

    Arguments default from torch's env convention (``MASTER_ADDR`` /
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); explicit arguments (the
    aggregator's config keys) take precedence. → a truthy
    :class:`MultihostInit` if the join ran; a falsy one when
    unconfigured (single-host, the default) or when joining FAILED —
    with the failure reason kept distinct: ``coordinator_unreachable``
    (the coordinator never answered within the deadline) vs
    ``init_error`` (anything else). Both are also logged at error level
    and surfaced by :func:`multihost_status`, which the aggregator's
    ``fleet-window`` health probe republishes.

    The group's timeout is ``init_timeout`` (300 s when unset): a
    collective whose peer never comes raises after it.

    Call ONCE per process, before the aggregator builds its mesh.
    """
    global _last_init
    # the card NCCL binds to (None: gloo alone)
    card = None
    if device is not None and resolve_device(device).type == "cuda":
        card = torch.device(device)
        if card.index is None:
            card = torch.device("cuda", torch.cuda.current_device())
    addr = coordinator_address
    if not addr and os.environ.get("MASTER_ADDR"):
        addr = (f"{os.environ['MASTER_ADDR']}:"
                f"{os.environ.get('MASTER_PORT', _DEFAULT_MASTER_PORT)}")
    if not addr:
        _last_init = MultihostInit(False, "unconfigured")
        return _last_init
    nproc = (num_processes if num_processes is not None
             else os.environ.get("WORLD_SIZE"))
    pid = (process_id if process_id is not None
           else os.environ.get("RANK"))
    pid_i = int(pid) if pid is not None else None
    nproc_i = int(nproc) if nproc is not None else None
    bound = (float(init_timeout) if init_timeout and init_timeout > 0
             else _DEFAULT_JOIN_DEADLINE_S)
    if pid_i is None:
        log.warning(
            "multi-host init with no explicit process id: the "
            "coordinator reachability pre-probe is skipped (set RANK / "
            "aggregator.multihost.processId for a diagnosable "
            "coordinator_unreachable decline against %s)", addr)
    # non-coordinator processes: verify the coordinator ANSWERS before
    # joining. Rank 0 hosts the coordinator's store itself, so it never
    # probes.
    if pid_i is not None and pid_i != 0:
        if not _wait_coordinator(addr, bound):
            detail = (f"no coordinator listening at {addr} within "
                      f"{bound:g}s")
            _last_init = MultihostInit(
                False, "coordinator_unreachable", detail=detail,
                num_processes=nproc_i if nproc_i is not None else 1,
                process_id=pid_i)
            log.error("multi-host init FAILED "
                      "(coordinator_unreachable): %s", detail)
            if card is not None:
                raise RuntimeError(f"joining NCCL on {card} failed "
                                   f"(coordinator_unreachable): {detail}")
            return _last_init
    try:
        if nproc_i is None or pid_i is None:
            raise ValueError(
                "the process count and process id are required "
                "(aggregator.multihost.numProcesses / processId, or "
                "WORLD_SIZE / RANK)")
        backend, bind = "gloo", {}
        if card is not None:
            torch.cuda.set_device(card)
            backend, bind = "cpu:gloo,cuda:nccl", {"device_id": card}
        torch.distributed.init_process_group(
            backend, init_method=f"tcp://{addr}", world_size=nproc_i,
            rank=pid_i, timeout=timedelta(seconds=bound), **bind)
    except Exception as err:
        # a failed join must not read as "unconfigured single-host": the
        # reason is preserved for the return/log/probe so the operator
        # sees a coordinator that never answered vs a real init bug
        reason = _classify_init_error(err)
        detail = f"{type(err).__name__}: {err}"[:240]
        _last_init = MultihostInit(
            False, reason, detail=detail,
            num_processes=nproc_i if nproc_i is not None else 1,
            process_id=pid_i if pid_i is not None else 0)
        log.error("multi-host init FAILED (%s) against %s: %s",
                  reason, addr, detail)
        if card is not None:  # NCCL's own words, whole
            raise RuntimeError(f"joining NCCL on {card} failed ({reason}): "
                               f"{type(err).__name__}: {err}") from err
        return _last_init
    rank, world = _world()
    _last_init = MultihostInit(True, "joined", num_processes=world,
                               process_id=rank)
    log.info("joined multi-process job: %s (process %d/%d)", addr, rank,
             world)
    return _last_init
