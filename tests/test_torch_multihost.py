"""The port's multi-host fleet window, against its single-host sharded
engine and against the JAX package's Aggregator on the same topology.

Virtual hosts: two ``MultiHostWindowEngine``\\ s in one process, each
owning 4 of 8 virtual ``cpu`` shards (process = shard index // 4), wired
through a :class:`HostLocalFabric` and run on two threads in lockstep.
Each launches only its own shards, so the union of their published rows
must equal — bit for bit, model rows included, since every shard runs
the same per-shard program on the same rows — the single-host
``ShardedWindowEngine``'s over the whole fleet, window by window
(``tests/test_multihost_engine.py``'s churn: full pack, delta, join,
drop). The fabric's rendezvous semantics mirror
``tests/test_multihost_engine.py``'s cases.

The Aggregator on a virtual topology is held against the JAX Aggregator
on the same topology (JAX: 8 CPU devices split 4/4; port: 8 virtual
shards split 4/4): the mesh-derived ring, rung 0's engine and name, the
"mesh minus one host" demotion with its epoch bump and timeline, the
3-host succession, and a real window failure — a killed fabric —
driving ``_demote_mesh`` from the aggregation path.

One test spawns two processes joined over gloo on 127.0.0.1, each
running ``MultiHostWindowEngine(fabric=None)`` over a 2-process mesh of
4 shards each (``tests/torch_multihost_worker.py``); the union of their
published rows must equal the single-process sharded engine's. It has
its own 60 s limit and fails rather than hangs.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest
import torch

from kepler_tpu.fleet.aggregator import Aggregator as JAggregator
from kepler_tpu.fleet.ring import MeshRing as JMeshRing
from kepler_tpu.fleet.window import DeviceWindowError as JWindowError
from kepler_tpu.parallel.mesh import make_mesh as jax_mesh
from kepler_tpu.server.http import APIServer as JServer
from kepler_tpu_torch.fleet.aggregator import (RUNG_NAME_MESH_DEGRADED,
                                               RUNG_NAME_MULTIHOST,
                                               RUNG_PIPELINED)
from kepler_tpu_torch.fleet.aggregator import Aggregator as PAggregator
from kepler_tpu_torch.fleet.aggregator import _Stored as PStored
from kepler_tpu_torch.fleet.ring import MeshRing
from kepler_tpu_torch.fleet.window import (DeviceWindowError,
                                           HostLocalFabric,
                                           MultiHostWindowEngine,
                                           ShardedWindowEngine,
                                           fetch_plane)
from kepler_tpu_torch.parallel.mesh import make_mesh
from kepler_tpu_torch.server.http import APIServer as PServer
from tests.torch_multihost_worker import (PEERS, SCHEDULE, SHARD_PROCS,
                                          ZONES, make_report, make_rows,
                                          mlp_params, owner_split)

REPO = pathlib.Path(__file__).resolve().parent.parent
PEERS3 = PEERS + ["127.0.0.1:28293"]


@pytest.fixture(autouse=True)
def no_join_yet(monkeypatch):
    """Both packages keep the last multi-host join outcome in a module
    global, which the probe republishes: each test starts from "never
    called", whatever an earlier test in this process left there."""
    from kepler_tpu.parallel import mesh as jmesh
    from kepler_tpu_torch.parallel import mesh as pmesh

    monkeypatch.setattr(jmesh, "_last_init",
                        jmesh.MultihostInit(False, "unconfigured"))
    monkeypatch.setattr(pmesh, "_last_init",
                        pmesh.MultihostInit(False, "unconfigured"))


def port_mesh(n: int = 8):
    return make_mesh([n], devices=["cpu"] * n)


def run_hosts(engines, rows_by_host, zones, params, dispatch=True,
              timeout: float = 60.0) -> list:
    """ONE window on every virtual host concurrently (the fabric's
    barriers demand lockstep) → per-host (plan, plane | None); re-raises
    the first host's error."""
    out: list = [None] * len(engines)
    errs: list = [None] * len(engines)
    zones_of = zones if isinstance(zones, list) else [zones] * len(engines)

    def run(p: int) -> None:
        try:
            plan = engines[p].plan_window(rows_by_host[p], zones_of[p],
                                          params)
            plane = (fetch_plane(engines[p].dispatch_window(plan))
                     if dispatch else None)
            out[p] = (plan, plane)
        except BaseException as e:  # re-raised on the caller thread
            errs[p] = e

    threads = [threading.Thread(target=run, args=(p,), daemon=True)
               for p in range(len(engines))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in threads), "a virtual host hung"
    for e in errs:
        if e is not None:
            raise e
    return out


# -- the fabric ---------------------------------------------------------------


class TestHostLocalFabric:
    def test_agree_is_elementwise_max(self):
        fabric = HostLocalFabric(2, timeout=10)
        got = [None, None]

        def party(p, vec):
            got[p] = fabric.agree(p, "needs", np.asarray(vec, np.int64))

        a = threading.Thread(target=party, args=(0, [1, 9]))
        b = threading.Thread(target=party, args=(1, [5, 2]))
        a.start(); b.start(); a.join(10); b.join(10)
        np.testing.assert_array_equal(got[0], [5, 9])
        np.testing.assert_array_equal(got[1], [5, 9])

    def test_exchange_merges_mappings(self):
        fabric = HostLocalFabric(2, timeout=10)
        got = [None, None]

        def party(p, mapping):
            got[p] = fabric.exchange(p, "shards", mapping)

        a = threading.Thread(target=party, args=(0, {0: "a", 1: "b"}))
        b = threading.Thread(target=party, args=(1, {2: "c"}))
        a.start(); b.start(); a.join(10); b.join(10)
        assert got[0] == got[1] == {0: "a", 1: "b", 2: "c"}

    def test_kill_breaks_waiters_and_future_calls(self):
        fabric = HostLocalFabric(2, timeout=30)
        err = [None]

        def waiter():
            try:
                fabric.agree(0, "needs", np.asarray([1], np.int64))
            except DeviceWindowError as e:
                err[0] = e

        t = threading.Thread(target=waiter)
        t.start()
        fabric.kill()
        t.join(10)
        assert err[0] is not None and err[0].reason == "host_dead"
        with pytest.raises(DeviceWindowError) as exc:
            fabric.agree(1, "needs", np.asarray([1], np.int64))
        assert exc.value.reason == "host_dead"

    def test_diverged_call_sites_detected(self):
        fabric = HostLocalFabric(2, timeout=10)
        errs = [None, None]

        def party(p, name):
            try:
                fabric.agree(p, name, np.asarray([1], np.int64))
            except DeviceWindowError as e:
                errs[p] = e

        a = threading.Thread(target=party, args=(0, "needs"))
        b = threading.Thread(target=party, args=(1, "other"))
        a.start(); b.start(); a.join(10); b.join(10)
        assert all(e is not None and e.reason == "mesh_desync"
                   for e in errs)

    def test_party_ids_and_incarnations(self):
        with pytest.raises(ValueError):
            HostLocalFabric()
        with pytest.raises(ValueError):
            HostLocalFabric(3, parties=[0, 1])
        survivors = HostLocalFabric(parties=[2, 1])
        assert survivors.parties == (1, 2) and survivors.n_parties == 2
        with pytest.raises(DeviceWindowError) as exc:
            survivors.agree(0, "needs", np.asarray([1], np.int64))
        assert exc.value.reason == "host_dead"


# -- the engine ---------------------------------------------------------------


def make_engines(n_hosts: int = 2, **kw):
    fabric = HostLocalFabric(n_hosts, timeout=60)
    per = 8 // n_hosts
    kw.setdefault("model_mode", "mlp")
    kw.setdefault("node_bucket", 8)
    kw.setdefault("workload_bucket", 16)
    engines = [MultiHostWindowEngine(port_mesh(), process_index=p,
                                     device_process=lambda k: k // per,
                                     fabric=fabric, **kw)
               for p in range(n_hosts)]
    return engines, fabric


def single_host(**kw) -> ShardedWindowEngine:
    return ShardedWindowEngine(port_mesh(), model_mode="mlp",
                               node_bucket=8, workload_bucket=16, **kw)


def single_host_rows(eng: ShardedWindowEngine, params) -> dict:
    """``seq/name`` → the single-host engine's published row per window."""
    out = {}
    for seq, names in SCHEDULE:
        plan = eng.plan_window(make_rows(names, seq), ZONES, params)
        plane = fetch_plane(eng.dispatch_window(plan))
        for name, i in plan.meta.rows.items():
            out[f"{seq}/{name}"] = plane[i]
    return out


@pytest.mark.parametrize("backend", ["einsum", "pallas"])
def test_bit_equal_vs_single_host_under_churn(backend):
    """The two virtual hosts' published rows are BIT-identical per node
    to the single-host sharded engine fed the union fleet, across
    full-pack, delta, join and drop windows; remote shards see zero H2D
    and are never materialized."""
    engines, _fabric = make_engines(backend=backend)
    params = mlp_params()
    want = single_host_rows(single_host(backend=backend), params)
    for seq, names in SCHEDULE:
        all_rows = make_rows(names, seq)
        owned = owner_split(names)
        rows_by_host = [[r for r in all_rows if r.name in set(owned[p])]
                        for p in range(2)]
        for p, (plan, plane) in enumerate(
                run_hosts(engines, rows_by_host, ZONES, params)):
            assert plane.shape[0] == plan.meta.n_rows
            assert sorted(plan.meta.rows) == sorted(owned[p])
            for name, li in plan.meta.rows.items():
                np.testing.assert_array_equal(
                    plane[li], want[f"{seq}/{name}"],
                    err_msg=f"{name} diverged at seq {seq}")
            mine = set(engines[p]._owned_shards)
            for k, n in enumerate(plan.h2d_shards):
                if k not in mine:
                    assert n == 0
            for k, buf in enumerate(engines[p]._buffers[engines[p]._buf_i]):
                assert (buf is not None) == (k in mine)


def test_capacity_scales_with_host_count():
    """8 nodes on one 4-shard host vs 16 nodes over two 4-shard hosts:
    the global rows hosted grow ≥ 1.8×."""
    params = mlp_params()
    single = ShardedWindowEngine(port_mesh(4), model_mode="mlp",
                                 node_bucket=8, workload_bucket=16)
    plan_1 = single.plan_window(
        make_rows([f"node-{i:02d}" for i in range(8)], 1), ZONES, params)
    cap_1 = plan_1.meta.n_rows
    names = [f"node-{i:02d}" for i in range(16)]
    engines, _ = make_engines()
    owned = owner_split(names)
    rows_by_host = [make_rows(owned[p], 1) for p in range(2)]
    plan = run_hosts(engines, rows_by_host, ZONES, params,
                     dispatch=False)[0][0]
    sb = plan.meta.n_rows // len(engines[0]._owned_shards)
    assert plan.n_shards * sb / cap_1 >= 1.8


def test_zone_desync_raises_mesh_desync():
    engines, _ = make_engines()
    params = mlp_params()
    rows0 = make_rows(["a0"], 1)
    rows1 = make_rows(["b0"], 1)
    with pytest.raises(DeviceWindowError) as exc:
        run_hosts(engines, [rows0, rows1], [ZONES, ("package", "core")],
                  params, dispatch=False)
    assert exc.value.reason == "mesh_desync"


def test_owned_shards_partition_the_mesh():
    engines, _ = make_engines()
    all_shards = sorted(engines[0]._owned_shards + engines[1]._owned_shards)
    assert all_shards == list(range(8))
    assert not set(engines[0]._owned_shards) & set(engines[1]._owned_shards)
    for eng in engines:
        snap = eng.introspect()
        assert snap["multihost"]["hosts"] == 2
        assert snap["multihost"]["simulated_fabric"] is True
    with pytest.raises(ValueError, match="owns no devices"):
        MultiHostWindowEngine(port_mesh(), process_index=5,
                              device_process=lambda k: k // 4)


def test_two_processes_over_gloo_match_the_single_process_engine(
        tmp_path):
    """Two ranks on 127.0.0.1, no fabric: bucket needs agreed by a gloo
    all-reduce, each rank launching its 4 shards. The union of their
    published rows equals the single-process sharded engine's."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        addr = f"127.0.0.1:{s.getsockname()[1]}"
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    env["PYTHONPATH"] = str(REPO)
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "torch_multihost_worker.py"),
         str(rank), "2", addr, str(tmp_path / f"rank{rank}.npz")],
        cwd=str(REPO), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for rank in (0, 1)]
    try:
        outs = [p.communicate(timeout=60) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    got: dict = {}
    for rank in (0, 1):
        with np.load(tmp_path / f"rank{rank}.npz") as npz:
            for key in npz.files:
                assert key not in got, f"{key} published by both ranks"
                got[key] = npz[key]
    want = single_host_rows(single_host(), mlp_params())
    assert sorted(got) == sorted(want)
    for key, row in want.items():
        np.testing.assert_array_equal(got[key], row, err_msg=key)


# -- the Aggregator on a virtual topology, against JAX's ------------------------


def jax_topology(n_hosts: int):
    devs = jax.devices()
    per = len(devs) // n_hosts
    proc_of = {d: min(k // per, n_hosts - 1) for k, d in enumerate(devs)}
    return jax_mesh([len(devs)], ["node"], devices=devs), proc_of.get


def make_pair(process_index: int = 0, n_hosts: int = 2, fabrics=(None, None),
              membership_topology=None, **kw):
    """(JAX Aggregator, port Aggregator) as virtual host
    ``process_index`` of an ``n_hosts``-host topology over 8 shards."""
    peers = (PEERS3 if n_hosts == 3 else PEERS)[:n_hosts]
    kw.setdefault("model_mode", "mlp")
    kw.setdefault("node_bucket", 8)
    kw.setdefault("workload_bucket", 8)
    kw.setdefault("stale_after", 1e9)
    common = dict(multihost_enabled=True, peers=list(peers),
                  self_peer=peers[process_index], **kw)
    if membership_topology is not None:
        common["membership_topology"] = membership_topology
    jmesh_, jproc = jax_topology(n_hosts)
    ref = JAggregator(JServer(), mesh=jmesh_, multihost_topology={
        "process_index": process_index, "device_process": jproc,
        "fabric": fabrics[0]}, **common)
    per = 8 // n_hosts
    port = PAggregator(PServer(), device="cpu", mesh=port_mesh(),
                       multihost_topology={
                           "process_index": process_index,
                           "device_process": lambda k: min(k // per,
                                                           n_hosts - 1),
                           "fabric": fabrics[1]}, **common)
    ref.init()
    port.init()
    return ref, port


def test_rung0_engine_and_mesh_derived_ring_match_jax():
    ref, port = make_pair(0)
    try:
        assert isinstance(port._ring, MeshRing)
        assert isinstance(ref._ring, JMeshRing)
        assert port._ring.ownership_ratio(PEERS[0]) == pytest.approx(0.5)
        names = [f"node-{i}" for i in range(64)]
        assert [port._ring.owner(n) for n in names] == \
            [ref._ring.owner(n) for n in names]
        engine = port._packed_engine(RUNG_PIPELINED)
        ref._packed_engine(RUNG_PIPELINED)
        assert isinstance(engine, MultiHostWindowEngine)
        assert engine._owned_shards == [0, 1, 2, 3]
        for agg in (ref, port):
            assert agg._rung_display(RUNG_PIPELINED) == RUNG_NAME_MULTIHOST
        got, want = port.window_health(), ref.window_health()
        assert got["multihost"] == want["multihost"]
        assert got["multihost"]["active"] is True
        assert got["rung_name"] == want["rung_name"]
        assert got["shards"] == want["shards"] == 8
    finally:
        ref.shutdown()
        port.shutdown()


def test_misordered_and_short_peer_lists_are_refused_as_jax():
    for peers, match in (([PEERS[1], PEERS[0]], "process index"),
                         (PEERS3, "one peer endpoint per")):
        jmesh_, jproc = jax_topology(2)
        ref = JAggregator(JServer(), model_mode="mlp", stale_after=1e9,
                          multihost_enabled=True, mesh=jmesh_,
                          multihost_topology={"process_index": 0,
                                              "device_process": jproc},
                          peers=peers, self_peer=PEERS[0])
        port = PAggregator(PServer(), device="cpu", model_mode="mlp",
                           stale_after=1e9, multihost_enabled=True,
                           mesh=port_mesh(),
                           multihost_topology={
                               "process_index": 0,
                               "device_process": lambda k: k // 4},
                           peers=peers, self_peer=PEERS[0])
        for agg in (ref, port):
            with pytest.raises(ValueError, match=match):
                agg.init()


@pytest.mark.parametrize("takeover", [True, False])
def test_mesh_demotion_keeps_rung0_and_bumps_epoch_as_jax(takeover):
    """A cross-host failure at rung 0 demotes to the LOCAL sharded engine
    (rung 0 kept, sticky), bumps the ring epoch by succession (unless
    takeover is off), and the probe and timeline name the tier — the
    same on both sides."""
    ref, port = make_pair(0, multihost_takeover=takeover)
    try:
        epoch_before = port._ring.epoch
        for agg, err in ((ref, JWindowError("host_dead", "peer lost")),
                         (port, DeviceWindowError("host_dead",
                                                  "peer lost"))):
            agg._packed_engine(RUNG_PIPELINED)
            agg._handle_device_failure(err)
        assert port._mesh_degraded is ref._mesh_degraded is True
        assert port._rung == ref._rung == RUNG_PIPELINED
        assert port._ring.epoch == ref._ring.epoch == \
            epoch_before + (1 if takeover else 0)
        if takeover:
            assert not isinstance(port._ring, MeshRing)
            assert port._ring.owner("anything") == PEERS[0]
        assert port._rung_display(RUNG_PIPELINED) == RUNG_NAME_MESH_DEGRADED
        keys = ("rung", "rung_name", "from_rung", "from_rung_name",
                "reason")
        assert ({k: port._rung_timeline[-1][k] for k in keys}
                == {k: ref._rung_timeline[-1][k] for k in keys})
        assert port._rung_timeline[-1]["from_rung_name"] == \
            RUNG_NAME_MULTIHOST
        engine = port._packed_engine(RUNG_PIPELINED)
        assert type(engine) is ShardedWindowEngine
        assert engine.n_shards == 4
        got, want = port.window_health(), ref.window_health()
        assert got["ok"] is want["ok"] is False
        assert got["multihost"] == want["multihost"]
    finally:
        ref.shutdown()
        port.shutdown()


@pytest.mark.parametrize("me", [0, 1])
def test_succession_on_three_host_mesh_as_jax(me):
    """Host 2 of 3 dies. The incumbent holder (host 0) is the one issuer:
    it bumps the epoch over the survivors and broadcasts to host 1 only;
    host 1 holds position, degraded and awaiting membership, until the
    broadcast lands — on both sides alike."""
    alive = set(PEERS3[:2])
    sent = {"jax": [], "port": []}

    def seams(side):
        return {"peer_alive": lambda p: p in alive,
                "deliver": lambda peer, payload: (
                    sent[side].append((peer, payload)) or {"ok": True})}

    jmesh_, jproc = jax_topology(3)
    kw = dict(model_mode="mlp", stale_after=1e9, node_bucket=8,
              workload_bucket=8, multihost_enabled=True,
              peers=list(PEERS3), self_peer=PEERS3[me])
    ref = JAggregator(JServer(), mesh=jax_mesh([6], ["node"],
                                               devices=jax.devices()[:6]),
                      multihost_topology={"process_index": me,
                                          "device_process": jproc},
                      membership_topology=seams("jax"), **kw)
    port = PAggregator(PServer(), device="cpu", mesh=port_mesh(6),
                       multihost_topology={
                           "process_index": me,
                           "device_process": lambda k: k // 2},
                       membership_topology=seams("port"), **kw)
    ref.init()
    port.init()
    try:
        epoch_before = port._ring.epoch
        for agg, err in ((ref, JWindowError("host_dead", "peer lost")),
                         (port, DeviceWindowError("host_dead",
                                                  "peer lost"))):
            agg._packed_engine(RUNG_PIPELINED)
            agg._handle_device_failure(err)
        assert port._ring.epoch == ref._ring.epoch
        assert sorted(port._ring.peers) == sorted(ref._ring.peers)
        assert port._lease.holder == ref._lease.holder
        assert [p for p, _ in sent["port"]] == [p for p, _ in sent["jax"]]
        got, want = port.window_health(), ref.window_health()
        assert got["multihost"] == want["multihost"]
        if me == 0:
            assert port._ring.epoch == epoch_before + 1
            assert [p for p, _ in sent["port"]] == [PEERS3[1]]
        else:
            assert port._ring.epoch == epoch_before
            assert got["multihost"]["awaiting_membership"] is True
            for agg in (ref, port):
                agg.apply_membership(PEERS3[:2], epoch_before + 1,
                                     source="wire", issuer=PEERS3[0])
            assert port.window_health()["multihost"] == \
                ref.window_health()["multihost"]
            assert port._lease.holder == PEERS3[0]
    finally:
        ref.shutdown()
        port.shutdown()


def test_killed_fabric_demotes_through_the_window_path():
    """Two virtual hosts publish a window together; then the fabric
    dies. Host 0's next aggregate_once fails in the bucket agreement
    (host_dead), the window-failure path demotes the mesh — rung 0
    kept, ``packed-sharded-mesh-minus-host``, ``_demote_mesh`` run
    (epoch bumped by succession) — and the same interval still
    publishes every node host 0 ingests, from its local 4-shard
    engine."""
    fabric = HostLocalFabric(2, timeout=30)
    ticks = [1e9]
    aggs = []
    for p in range(2):
        agg = PAggregator(
            PServer(), device="cpu", mesh=port_mesh(), model_mode=None,
            node_bucket=8, workload_bucket=8, stale_after=1e9,
            clock=lambda: ticks[0], multihost_enabled=True,
            multihost_topology={"process_index": p,
                                "device_process": lambda k: k // 4,
                                "fabric": fabric},
            membership_topology={"peer_alive": lambda peer: peer ==
                                 PEERS[0],
                                 "deliver": lambda peer, payload: {}},
            peers=list(PEERS), self_peer=PEERS[p])
        agg.init()
        aggs.append(agg)
    names = [f"node-{i:02d}" for i in range(10)]
    owned = owner_split(names)

    def seed(seq):
        ticks[0] += 5.0
        for p, agg in enumerate(aggs):
            for i, name in enumerate(owned[p]):
                agg._reports[name] = PStored(
                    report=make_report(name, seq * 100 + i),
                    zone_names=ZONES, received=ticks[0], seq=seq, run="r")

    seed(1)
    results = [None, None]
    threads = [threading.Thread(
        target=lambda p=p: results.__setitem__(p, aggs[p].aggregate_once()))
        for p in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    for p in range(2):
        assert sorted(results[p].names) == sorted(owned[p])
        assert aggs[p]._rung_display(0) == RUNG_NAME_MULTIHOST
    epoch = aggs[0]._ring.epoch
    fabric.kill()
    seed(2)
    result = aggs[0].aggregate_once()
    agg = aggs[0]
    assert sorted(result.names) == sorted(owned[0])
    assert agg._rung == RUNG_PIPELINED and agg._mesh_degraded
    assert agg._rung_display(0) == RUNG_NAME_MESH_DEGRADED
    assert agg._rung_timeline[-1]["reason"] == "host_dead"
    assert agg._ring.epoch == epoch + 1  # succession ran
    assert type(agg._engine) is ShardedWindowEngine
    assert agg._engine.n_shards == 4
    assert agg._stats["window_demotions_total"] == 1
    # and it keeps publishing at the degraded tier
    seed(3)
    assert sorted(agg.aggregate_once().names) == sorted(owned[0])
    for a in aggs:
        a.shutdown()
