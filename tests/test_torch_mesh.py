"""The port's device mesh and multi-process join against the JAX package's.

``kepler_tpu_torch.parallel.mesh`` over 8 virtual ``cpu`` shards is held
against ``kepler_tpu.parallel.mesh`` over the 8 CPU devices
``tests/conftest.py`` gives JAX: the same shapes and the same errors from
``make_mesh``, the same order-preserving ``submesh_for_processes``. Then
``initialize_multihost``'s four outcomes: ``unconfigured``,
``coordinator_unreachable`` (the non-zero rank's pre-probe against a
closed port, and a join whose store times out), ``init_error``, and
``joined`` on a one-rank gloo world on 127.0.0.1 (destroyed after) —
each reason equal to the reference's for the same failure, and
republished by the Aggregator's ``fleet-window`` probe.
"""

from __future__ import annotations

import socket

import jax
import pytest
import torch

from kepler_tpu.fleet.aggregator import Aggregator as JAggregator
from kepler_tpu.parallel import mesh as jmesh
from kepler_tpu.server.http import APIServer as JServer
from kepler_tpu_torch.fleet.aggregator import Aggregator as PAggregator
from kepler_tpu_torch.parallel import mesh as pmesh
from kepler_tpu_torch.server.http import APIServer as PServer

VIRTUAL = ["cpu"] * 8


def free_port() -> int:
    """A port nothing listens on (bind, read, close)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(autouse=True)
def keep_status(monkeypatch):
    """Each test's join outcome stays its own (both packages keep the
    last one in a module global)."""
    monkeypatch.setattr(pmesh, "_last_init", pmesh._last_init)
    monkeypatch.setattr(jmesh, "_last_init", jmesh._last_init)


@pytest.mark.parametrize("shape,axes", [
    ((), ("node",)),
    ([8], ("node",)),
    ([-1], ("node",)),
    ([4, 2], ("node", "model")),
    ([2, -1], ("node", "model")),
    ((), ("node", "model")),
])
def test_make_mesh_shapes_match_the_reference(shape, axes):
    ref = jmesh.make_mesh(shape, axes)
    got = pmesh.make_mesh(shape, axes, devices=VIRTUAL)
    assert got.describe() == dict(ref.shape)
    assert got.size == ref.devices.size == 8
    assert got.devices == (torch.device("cpu"),) * 8
    assert got.processes == (0,) * 8


@pytest.mark.parametrize("shape,axes", [
    ([-1, -1], ("node", "model")),
    ([3, -1], ("node", "model")),
    ([4], ("node",)),
    ([16], ("node",)),
    ([8], ("node", "model")),
])
def test_make_mesh_errors_match_the_reference(shape, axes):
    with pytest.raises(ValueError) as want:
        jmesh.make_mesh(shape, axes)
    with pytest.raises(ValueError) as got:
        pmesh.make_mesh(shape, axes, devices=VIRTUAL)
    assert str(got.value) == str(want.value)


def test_default_mesh_is_every_visible_device_of_the_type():
    mesh = pmesh.make_mesh(device="cpu")
    assert mesh.size == 1 and mesh.describe() == {"node": 1}
    assert mesh.shards == (pmesh.Shard(torch.device("cpu"), 0),)


def test_submesh_for_processes_matches_the_reference():
    ref_devs = jax.devices()
    ref = jmesh.make_mesh([8], ["node"], devices=ref_devs)
    ref_proc = {d: k // 3 for k, d in enumerate(ref_devs)}
    mesh = pmesh.make_mesh([8], devices=VIRTUAL)
    for keep in ([0], [1], [2], [0, 2], [2, 0, 1]):
        want = jmesh.submesh_for_processes(ref, keep, ref_proc.get)
        got = pmesh.submesh_for_processes(mesh, keep, lambda k: k // 3)
        assert got.describe() == dict(want.shape)
        # order kept: the same processes in the same shard order
        assert list(got.processes) == [ref_proc[d]
                                       for d in want.devices.flat]
    with pytest.raises(ValueError) as want:
        jmesh.submesh_for_processes(ref, [7], ref_proc.get)
    with pytest.raises(ValueError) as got:
        pmesh.submesh_for_processes(mesh, [7], lambda k: k // 3)
    assert str(got.value) == str(want.value)
    # the shards' own labels are the default topology
    labelled = mesh.with_processes(lambda k: k // 4)
    assert pmesh.submesh_for_processes(labelled, [1]).processes == (1,) * 4


def test_unconfigured_is_a_clean_decline(monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    out = pmesh.initialize_multihost()
    ref = jmesh.initialize_multihost()
    assert not out and out.reason == ref.reason == "unconfigured"
    assert pmesh.multihost_status().reason == "unconfigured"


def test_worker_preprobe_declines_on_a_closed_port(monkeypatch):
    """A non-zero rank probes the coordinator before joining: a closed
    port is ``coordinator_unreachable`` within the deadline, and the
    join is never entered."""
    def must_not_run(*a, **kw):
        raise AssertionError("init_process_group reached with an "
                             "unreachable coordinator")

    monkeypatch.setattr(torch.distributed, "init_process_group",
                        must_not_run)
    monkeypatch.setattr(jax.distributed, "initialize", must_not_run)
    addr = f"127.0.0.1:{free_port()}"
    kw = dict(coordinator_address=addr, num_processes=2, process_id=1,
              init_timeout=1.5)
    out = pmesh.initialize_multihost(**kw)
    ref = jmesh.initialize_multihost(**kw)
    assert not out
    assert out.reason == ref.reason == "coordinator_unreachable"
    assert "no coordinator listening" in out.detail
    assert out.process_id == 1 and out.num_processes == 2
    assert pmesh.multihost_status().reason == "coordinator_unreachable"


def test_store_timeout_is_coordinator_unreachable(monkeypatch):
    def timed_out(*a, **kw):
        raise RuntimeError("DEADLINE_EXCEEDED: timed out connecting to "
                           "coordinator 10.0.0.1:1234")

    monkeypatch.setattr(torch.distributed, "init_process_group", timed_out)
    monkeypatch.setattr(jax.distributed, "initialize", timed_out)
    kw = dict(coordinator_address="10.0.0.1:1234", num_processes=2,
              process_id=0, init_timeout=1.0)
    out = pmesh.initialize_multihost(**kw)
    ref = jmesh.initialize_multihost(**kw)
    assert out.reason == ref.reason == "coordinator_unreachable"
    assert "DEADLINE_EXCEEDED" in out.detail


def test_other_init_failures_keep_their_own_reason(monkeypatch):
    def boom(*a, **kw):
        raise ValueError("process_id 7 out of range")

    monkeypatch.setattr(torch.distributed, "init_process_group", boom)
    monkeypatch.setattr(jax.distributed, "initialize", boom)
    kw = dict(coordinator_address="10.0.0.1:1234", num_processes=2,
              process_id=0)
    out = pmesh.initialize_multihost(**kw)
    ref = jmesh.initialize_multihost(**kw)
    assert not out and out.reason == ref.reason == "init_error"
    assert "out of range" in out.detail
    # a missing process id or count is an init_error of its own
    out = pmesh.initialize_multihost(coordinator_address="10.0.0.1:1234")
    assert out.reason == "init_error" and "required" in out.detail


def test_env_convention_is_torchs(monkeypatch):
    """MASTER_ADDR/MASTER_PORT, WORLD_SIZE and RANK stand in for the
    reference's JAX_* names (explicit arguments win)."""
    seen = {}

    def record(backend, init_method, world_size, rank, timeout):
        seen.update(backend=backend, init_method=init_method,
                    world_size=world_size, rank=rank)
        raise ValueError("recorded")

    monkeypatch.setattr(torch.distributed, "init_process_group", record)
    monkeypatch.setenv("MASTER_ADDR", "10.1.2.3")
    monkeypatch.setenv("MASTER_PORT", "4567")
    monkeypatch.setenv("WORLD_SIZE", "3")
    monkeypatch.setenv("RANK", "0")
    pmesh.initialize_multihost()
    assert seen == {"backend": "gloo", "init_method": "tcp://10.1.2.3:4567",
                    "world_size": 3, "rank": 0}
    pmesh.initialize_multihost(coordinator_address="10.9.9.9:1",
                               num_processes=1, process_id=0)
    assert seen["init_method"] == "tcp://10.9.9.9:1"
    assert seen["world_size"] == 1


def test_joined_on_a_one_rank_gloo_world():
    assert not torch.distributed.is_initialized()
    try:
        out = pmesh.initialize_multihost(
            coordinator_address=f"127.0.0.1:{free_port()}",
            num_processes=1, process_id=0, init_timeout=30)
        assert out and out.reason == "joined"
        assert (out.num_processes, out.process_id) == (1, 0)
        assert isinstance(out, pmesh.MultihostInit)
        assert pmesh.process_index() == 0
        mesh = pmesh.make_mesh(device="cpu")
        assert mesh.size == 1 and mesh.processes == (0,)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def test_probe_republishes_init_reason(monkeypatch):
    def boom(*a, **kw):
        raise RuntimeError("UNAVAILABLE: failed to connect")

    monkeypatch.setattr(torch.distributed, "init_process_group", boom)
    monkeypatch.setattr(jax.distributed, "initialize", boom)
    kw = dict(coordinator_address="10.0.0.1:9", num_processes=2,
              process_id=0)
    pmesh.initialize_multihost(**kw)
    jmesh.initialize_multihost(**kw)
    port = PAggregator(PServer(), device="cpu", model_mode=None,
                       multihost_enabled=True, stale_after=1e9)
    port._mesh = pmesh.make_mesh(devices=VIRTUAL)
    ref = JAggregator(JServer(), model_mode=None, multihost_enabled=True,
                      stale_after=1e9)
    ref._mesh = jmesh.make_mesh()
    got, want = port.window_health(), ref.window_health()
    assert got["multihost"] == want["multihost"]
    assert got["multihost"]["init_reason"] == "coordinator_unreachable"
    assert got["multihost"]["init_joined"] is False
    assert "init_detail" in got["multihost"]
