"""The port's fleet ``Aggregator`` against the JAX package's, on the CPU.

``kepler_tpu_torch.fleet.aggregator.Aggregator(device="cpu")`` and
``kepler_tpu.fleet.aggregator.Aggregator`` are fed the same seeded report
stream (``tests/test_window_pipeline.py``'s churn: joins, drops, a
restart, a zone-set change, mixed modes) on the same fake clock. The JAX
aggregator is pinned to one device (``tests/conftest.py`` gives JAX eight
CPU devices; unpinned it would run the sharded engine and round the node
bucket), and its Pallas backend runs in interpret mode, as
``tests/test_fused_window.py`` runs it.

Tolerances, per published window:

- fused tier (K ∈ {2, 4}) and ratio rows of the pipelined tier: the f16
  plane, node power, node energy and cumulative joules bit-equal;
- model rows of the packed programs (MLP, f32 on both sides): within
  rtol 1e-3 (atol 1e-3 W) on the f16 plane — one f16 ulp plus matmul
  summation order;
- serial rung, accuracy mode: model watts within rtol 1e-4; temporal at
  bf16: within rtol 1e-2 and atol 1e-2 · max|watts| (bf16 operands round
  after f32 sums taken in another order); ratio rows of the serial rung
  within rtol 1e-6 (one f32 multiply or divide apart);
- the degradation ladder under each injected fault site: the same rung
  sequence, demotion reasons and re-promotions, and every interval
  publishes; a permanently failing device ends at the NumPy rung with
  ratio watts equal to JAX's NumPy rung.

Both aggregators get explicit numpy params (for the zone axes a window
can have), so no untrained fallback — whose random bits differ between
the packages — is ever drawn.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from kepler_tpu import fault as jfault
from kepler_tpu.config import config as jconfig
from kepler_tpu.fault import FaultPlan as JPlan
from kepler_tpu.fault import FaultSpec as JSpec
from kepler_tpu.fleet import wire as jwire
from kepler_tpu.fleet.aggregator import Aggregator as JAggregator
from kepler_tpu.fleet.aggregator import _Stored as JStored
from kepler_tpu.fleet.journal import EventJournal as JJournal
from kepler_tpu.models.mlp import init_mlp
from kepler_tpu.parallel.mesh import make_mesh
from kepler_tpu.server.http import APIServer as JServer
from kepler_tpu.service.lifecycle import CancelContext as JCancel
from kepler_tpu_torch import fault as pfault
from kepler_tpu_torch.cmd import aggregator as pcmd
from kepler_tpu_torch.config import config as pconfig
from kepler_tpu_torch.fault import FaultPlan as PPlan
from kepler_tpu_torch.fault import FaultSpec as PSpec
from kepler_tpu_torch.fleet.aggregator import RUNG_NUMPY
from kepler_tpu_torch.fleet.aggregator import Aggregator as PAggregator
from kepler_tpu_torch.fleet.aggregator import _Stored as PStored
from kepler_tpu_torch.fleet.journal import EventJournal as PJournal
from kepler_tpu_torch.ops import cuda_attribution as ca
from kepler_tpu_torch.parallel.fleet import MODE_MODEL, MODE_RATIO
from kepler_tpu_torch.parallel.fleet import NodeReport
from kepler_tpu_torch.parallel.mesh import Mesh, Shard
from kepler_tpu_torch.server.http import APIServer as PServer
from kepler_tpu_torch.service.lifecycle import CancelContext as PCancel
from tests.test_torch_temporal import jax_params as temporal_params
from tests.test_window_pipeline import (ZONES, ZONES_WIDE, churn_schedule,
                                        make_report)

# the keys hack/introspect_smoke.py checks on the debug surfaces
WINDOW_REQUIRED = {"rung", "rung_name", "shards", "timeline",
                   "windows_at_rung", "windows_since_last_failure",
                   "demotions_by_reason", "engines", "stats"}
ENGINE_REQUIRED = {"engine", "n_shards", "window_seq", "buckets",
                   "resident", "shards", "programs", "updates",
                   "compile_count"}
FLEET_REQUIRED = {"cap", "anomaly_z", "flag_ttl_s", "stale_after_s",
                  "states", "nodes"}
RING_REQUIRED = {"enabled", "epoch", "self", "peers", "vnodes",
                 "ownership_ratio", "owned_nodes", "redirected_total",
                 "last_redirect_age_s"}
TIMELINE_KEYS = ("rung", "rung_name", "from_rung", "from_rung_name",
                 "reason", "windows_at_prev_rung")


def port_report(rep) -> NodeReport:
    """The same report as the port's NodeReport (a field-for-field copy)."""
    return NodeReport(
        node_name=rep.node_name, zone_deltas_uj=rep.zone_deltas_uj,
        zone_valid=rep.zone_valid, usage_ratio=rep.usage_ratio,
        cpu_deltas=rep.cpu_deltas, workload_ids=rep.workload_ids,
        node_cpu_delta=rep.node_cpu_delta, dt_s=rep.dt_s, mode=rep.mode,
        workload_kinds=rep.workload_kinds, meta=dict(rep.meta))


def mlp_params(n_zones: int) -> dict:
    """JAX-initialised MLP params as numpy, with a non-zero head."""
    p = {k: np.asarray(v) for k, v in
         init_mlp(jax.random.PRNGKey(3), n_zones=n_zones).items()}
    rng = np.random.default_rng(n_zones)
    p["w2"] = rng.normal(0.0, 0.05, p["w2"].shape).astype(np.float32)
    p["w_skip"] = rng.normal(0.0, 0.01, p["w_skip"].shape).astype(
        np.float32)
    p["b2"] = np.full(p["b2"].shape, 0.5, np.float32)
    return p


def model_params(mode: str | None, n_zones: int) -> dict | None:
    if mode == "mlp":
        return mlp_params(n_zones)
    if mode == "linear":
        rng = np.random.default_rng(n_zones)
        return {"weight": rng.normal(0.0, 0.3, (7, n_zones)).astype(
                    np.float32),
                "bias": np.full(n_zones, 0.2, np.float32)}
    if mode in ("moe", "deep"):
        from tests.test_torch_models import deep_params, moe_params

        return (moe_params if mode == "moe" else deep_params)(
            n_zones, n_zones=n_zones)
    if mode == "temporal":
        return temporal_params(z=n_zones, d_model=32, t_max=128,
                               seed=n_zones)
    return None


class Pair:
    """A JAX aggregator pinned to one device and the port's on the CPU,
    on one fake clock, with the same explicit params for both zone axes
    the churn schedule produces."""

    def __init__(self, jax_server=None, port_server=None, **kw) -> None:
        kw.setdefault("node_bucket", 8)
        kw.setdefault("workload_bucket", 8)
        kw.setdefault("stale_after", 1e9)
        kw.setdefault("model_mode", None)
        self.ticks = [1e9]
        mode = kw["model_mode"]
        if mode:
            kw.setdefault("model_params", model_params(mode, len(ZONES)))
        jkw = dict(kw)
        pkw = dict(kw)
        if "journal" in kw:  # one journal per side
            jkw["journal"], pkw["journal"] = kw["journal"]
        self.jax = JAggregator(jax_server or JServer(),
                               clock=self.clock, **jkw)
        self.jax._mesh = make_mesh(devices=jax.devices()[:1])
        self.port = PAggregator(port_server or PServer(),
                                clock=self.clock, device="cpu", **pkw)
        if mode:
            wide = model_params(mode, len(ZONES_WIDE))
            for agg in (self.jax, self.port):
                agg._fallback_params[len(ZONES_WIDE)] = wide

    def clock(self) -> float:
        return self.ticks[0]

    def seed(self, sched: dict) -> None:
        """Store one interval's reports in both aggregators, as ingest
        would (temporal histories included)."""
        self.ticks[0] += 5.0
        now = self.ticks[0]
        for name, (seed, zones, mode, seq, run) in sched.items():
            rep = make_report(name, seed, zones=zones, mode=mode)
            for agg, stored, report in (
                    (self.jax, JStored, rep),
                    (self.port, PStored, port_report(rep))):
                prev = agg._reports.get(name)
                agg._reports[name] = stored(
                    report=report, zone_names=tuple(zones), received=now,
                    seq=seq, run=run)
                if (agg._model_mode == "temporal" and mode == MODE_MODEL
                        and (prev is None or prev.seq != seq
                             or prev.run != run)):
                    agg._push_history(report)
        for agg in (self.jax, self.port):
            for name in list(agg._reports):
                if name not in sched:
                    del agg._reports[name]

    def run(self, schedules: list[dict]) -> tuple[list, list]:
        """aggregate_once per interval on both, then a drain. → the
        published windows of each side (None where nothing published)."""
        out_j, out_p = [], []
        for sched in schedules:
            self.seed(sched)
            out_j.append(self.jax.aggregate_once())
            out_p.append(self.port.aggregate_once())
        out_j.append(self.jax._drain_pipeline())
        out_p.append(self.port._drain_pipeline())
        return out_j, out_p


@contextlib.contextmanager
def faults(**spec):
    """The same fault spec armed in both packages' registries."""
    with jfault.installed(JPlan([JSpec(**spec)])) as jp, \
            pfault.installed(PPlan([PSpec(**spec)])) as pp:
        yield jp, pp


def wl_plane(res, i: int) -> np.ndarray:
    """One row's workload watts (f16 plane when the window has one)."""
    if res._wl_watts_f16 is not None:
        return res._wl_watts_f16[i].astype(np.float32)
    return res.wl_power_uw[i] * 1e-6


def assert_same_window(ref, got, model: str = "exact",
                       ratio: str = "exact") -> None:
    """``model`` / ``ratio``: how the two row kinds are held — "exact",
    "packed" (rtol 1e-3 on the f16 plane), "f32" (rtol 1e-4), "bf16"
    (rtol 1e-2, atol 1e-2 · max|watts|) or "serial" (rtol 1e-6)."""
    assert (ref is None) == (got is None)
    if ref is None:
        return
    assert got.timestamp == ref.timestamp
    assert list(got.zones) == list(ref.zones)
    assert sorted(got.names) == sorted(ref.names)
    scale = max((float(np.abs(wl_plane(ref, ref.rows[n])).max(initial=0.0))
                 for n in ref.names if ref.mode[ref.rows[n]] == MODE_MODEL),
                default=0.0)
    for name in ref.names:
        i, j = ref.rows[name], got.rows[name]
        assert int(got.mode[j]) == int(ref.mode[i]), name
        assert got.counts[j] == ref.counts[i]
        assert list(got.workload_ids[j]) == list(ref.workload_ids[i])
        how = model if int(ref.mode[i]) == MODE_MODEL else ratio
        pairs = [(got.node_power_uw[j] * 1e-6, ref.node_power_uw[i] * 1e-6),
                 (got.node_energy_uj[j], ref.node_energy_uj[i]),
                 (wl_plane(got, j), wl_plane(ref, i))]
        if how == "exact":
            for a, b in pairs:
                np.testing.assert_array_equal(a, b, err_msg=name)
            np.testing.assert_array_equal(got.node_joules_total[j],
                                          ref.node_joules_total[i])
            assert got.render_node(name) == ref.render_node(name), name
            continue
        a, b = pairs[2]
        if how == "packed":
            np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3,
                                       err_msg=name)
        elif how == "f32":
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6,
                                       err_msg=name)
        elif how == "bf16":
            np.testing.assert_allclose(a, b, rtol=1e-2, atol=1e-2 * scale,
                                       err_msg=name)
        else:
            assert how == "serial", how
            for x, y in pairs:
                np.testing.assert_allclose(x, y, rtol=1e-6, err_msg=name)


def assert_same_ladder(jagg, pagg) -> None:
    """The same rung transitions, demotion reasons and counters."""
    tj = [tuple(e[k] for k in TIMELINE_KEYS) for e in jagg._rung_timeline]
    tp = [tuple(e[k] for k in TIMELINE_KEYS) for e in pagg._rung_timeline]
    assert tp == tj
    assert pagg._demotions_by_reason == jagg._demotions_by_reason
    for key in ("window_rung", "window_demotions_total",
                "window_repromotions_total", "attributions_total"):
        assert pagg._stats[key] == jagg._stats[key], key
    assert pagg.window_health()["rung_name"] == \
        jagg.window_health()["rung_name"]


# -- tiers ----------------------------------------------------------------------

@pytest.mark.parametrize("k", [2, 4])
def test_fused_tier_bit_equal_to_jax_under_churn(k):
    pair = Pair(backend="pallas", fused_window_k=k)
    before = dict(ca.LAUNCHES)
    out_j, out_p = pair.run(churn_schedule(10))
    assert pair.port.window_health()["rung_name"] == "packed-fused-scan"
    published = [r for r in out_p if r is not None]
    assert len(published) >= 10 // k
    for ref, got in zip(out_j, out_p):
        assert_same_window(ref, got)
    assert pair.port._stats["attributions_total"] == 10  # one per interval
    assert_same_ladder(pair.jax, pair.port)
    # the plain version serves CPU tensors: no kernel launch is counted
    assert dict(ca.LAUNCHES) == before


@pytest.mark.parametrize("backend", ["einsum", "pallas"])
def test_pipelined_mixed_fleet_matches_jax(backend):
    pair = Pair(backend=backend, model_mode="mlp", pipeline_depth=2)
    schedules = churn_schedule(9)
    out_j, out_p = pair.run(schedules)
    # depth 2: the first interval fills the pipeline, the drain publishes
    # the last window — staleness ≤ depth − 1 windows, as in JAX
    assert out_p[0] is None and out_j[0] is None
    assert all(r is not None for r in out_p[1:])
    for t, (ref, got) in enumerate(zip(out_j, out_p)):
        assert_same_window(ref, got, model="packed")
        if got is not None:
            assert got.timestamp == 1e9 + 5.0 * min(t, len(schedules))
    assert pair.port.window_health()["rung_name"] == "packed-pipelined"


def test_serial_rung_accuracy_mode_matches_jax():
    pair = Pair(model_mode="mlp", accuracy_mode=True)
    out_j, out_p = pair.run(churn_schedule(6))
    for ref, got in zip(out_j, out_p):
        assert_same_window(ref, got, model="f32", ratio="serial")


def test_serial_rung_temporal_bf16_matches_jax():
    pair = Pair(model_mode="temporal", history_window=4, backend="pallas")
    out_j, out_p = pair.run(churn_schedule(6))
    assert sum(r is not None for r in out_p) == 6
    for ref, got in zip(out_j, out_p):
        assert_same_window(ref, got, model="bf16", ratio="serial")
    assert set(pair.port._history) == set(pair.jax._history)


# -- the degradation ladder --------------------------------------------------------

# per fault site: the spec, the aggregator's settings and the churn's
# base node count (the OOM case starts at 4 nodes in a bucket of 4 and
# grows when a node joins at interval 3)
LADDER_CASES = {
    "dispatch_error": (dict(site="device.dispatch_error", skip=2, count=1),
                       dict(model_mode="mlp", pipeline_depth=2)),
    "dispatch_error_fused": (dict(site="device.dispatch_error", skip=2,
                                  count=1),
                             dict(backend="pallas", fused_window_k=2)),
    "compile_error": (dict(site="device.compile_error", count=1),
                      dict(model_mode="mlp", pipeline_depth=2)),
    "oom_on_grow": (dict(site="device.oom_on_grow", count=1),
                    dict(model_mode="mlp", node_bucket=4), 4),
    "stall": (dict(site="device.stall", count=1, arg=1.0),
              dict(model_mode=None, pipeline_depth=2,
                   dispatch_timeout=0.25)),
}


@pytest.mark.parametrize("case", sorted(LADDER_CASES))
def test_ladder_walks_as_jax_under_each_fault_site(case):
    spec, kw, *base = LADDER_CASES[case]
    pair = Pair(repromote_after=2, **kw)
    with faults(**spec) as (jp, pp):
        out_j, out_p = pair.run(churn_schedule(9, *base))
    assert pp.fired(spec["site"]) == jp.fired(spec["site"]) == 1
    assert_same_ladder(pair.jax, pair.port)
    assert pair.port._stats["window_demotions_total"] >= 1
    assert pair.port._stats["window_repromotions_total"] >= 1
    assert len(pair.port._demotions_by_reason) == 1
    reason = next(iter(pair.port._demotions_by_reason))
    assert reason == spec["site"].split(".", 1)[1]
    for ref, got in zip(out_j, out_p):
        assert_same_window(ref, got, model="packed")


def test_dead_device_ends_at_numpy_rung_with_jax_watts():
    pair = Pair(pipeline_depth=2, repromote_after=2)
    schedules = churn_schedule(8)
    with faults(site="device.dispatch_error"):
        out_j, out_p = pair.run(schedules)
    assert_same_ladder(pair.jax, pair.port)
    assert pair.port._rung == RUNG_NUMPY
    assert pair.port.window_health()["rung_name"] == "numpy-host"
    # every interval published (the drain has nothing left at this rung)
    assert all(r is not None for r in out_p[:-1])
    for ref, got in zip(out_j, out_p):
        assert_same_window(ref, got)
    # the NumPy rung calls no torch.cuda API: it publishes with the
    # CUDA runtime made unusable
    def dead(*args, **kwargs):
        raise AssertionError("the NumPy rung touched torch.cuda")

    with pytest.MonkeyPatch.context() as mp:
        for name in ("Event", "current_stream", "synchronize", "Stream",
                     "is_available", "device_count", "current_device"):
            mp.setattr(torch.cuda, name, dead)
        pair.ticks[0] += 5.0
        assert pair.port.aggregate_once() is not None
    # ratio conservation on the NumPy rung: Σ workload watts == active
    res = out_p[-2]
    for name in res.names:
        i = res.rows[name]
        wl = res.wl_power_uw[i, :res.counts[i]].sum(axis=0)
        assert np.all(wl <= res.node_power_uw[i] * (1 + 1e-6))


def test_real_cuda_oom_maps_to_oom_on_grow():
    from kepler_tpu_torch.fleet.aggregator import _failure_reason
    from kepler_tpu_torch.fleet.window import DeviceWindowError

    assert _failure_reason(torch.cuda.OutOfMemoryError("x")) == \
        "oom_on_grow"
    assert _failure_reason(DeviceWindowError("stall")) == "stall"
    assert _failure_reason(RuntimeError("illegal address")) == \
        "runtime_error"


def test_init_fails_when_a_kernel_does_not_build(monkeypatch):
    """On the card with the pallas backend, ``init()`` builds every hand
    kernel: a failed nvcc fails init() instead of reaching the ladder,
    which would demote past every kernel."""
    from kepler_tpu_torch.ops import build

    def broken():
        raise RuntimeError("nvcc failed for attribution.cu (rc 1)")

    monkeypatch.setattr(build, "build_all", broken)
    for backend, fails in (("pallas", True), ("einsum", False)):
        agg = PAggregator(PServer(), device="cpu", backend=backend,
                          model_mode=None)
        # as it is on the card: one shard on cuda (built by hand, since
        # make_mesh refuses CUDA here)
        agg._mesh = Mesh((Shard(torch.device("cuda")),), (1,), ("node",))
        if fails:
            with pytest.raises(RuntimeError, match="nvcc failed"):
                agg.init()
        else:
            agg.init()


def test_mesh_shape_over_more_devices_than_visible_is_refused():
    """``init()`` builds the mesh with ``make_mesh``: two shards over the
    one visible ``cpu`` device fail with its error, as the reference's do
    over too few devices; one shard builds."""
    agg = PAggregator(PServer(), device="cpu", model_mode=None,
                      mesh_shape=[2])
    with pytest.raises(ValueError, match=r"needs 2 devices, have 1"):
        agg.init()
    agg = PAggregator(PServer(), device="cpu", model_mode=None,
                      mesh_shape=[1])
    agg.init()
    assert agg._shard_count == 1 and agg._mesh.size == 1


@pytest.mark.parametrize("mode", [None, "mlp"])
def test_explicit_8_shard_mesh_serves_windows_equal_to_one_shard(mode):
    """An explicit mesh of 8 virtual ``cpu`` shards runs rung 0 on the
    sharded engine (B1's plain version once per shard) and publishes
    every window of the churn schedule equal to ``mesh_shape=[1]``: the
    f16 plane, node power, energy and cumulative joules bit-equal."""
    from kepler_tpu_torch.fleet.window import ShardedWindowEngine
    from kepler_tpu_torch.parallel.mesh import make_mesh as pmesh

    published = []
    for kw in (dict(mesh=pmesh([8], devices=["cpu"] * 8)),
               dict(mesh_shape=[1])):
        ticks = [1e9]
        agg = PAggregator(PServer(), device="cpu", model_mode=mode,
                          backend="pallas" if mode is None else "einsum",
                          node_bucket=8, workload_bucket=8,
                          stale_after=1e9, clock=lambda: ticks[0], **kw)
        agg.init()
        if mode:
            agg._params = mlp_params(len(ZONES))
            agg._fallback_params[len(ZONES_WIDE)] = mlp_params(
                len(ZONES_WIDE))
        out = []
        for sched in churn_schedule(8):
            ticks[0] += 5.0
            for name, (seed, zones, m, seq, run) in sched.items():
                agg._reports[name] = PStored(
                    report=port_report(make_report(name, seed, zones=zones,
                                                   mode=m)),
                    zone_names=tuple(zones), received=ticks[0], seq=seq,
                    run=run)
            for name in [n for n in agg._reports if n not in sched]:
                del agg._reports[name]
            out.append(agg.aggregate_once())
        sharded = isinstance(agg._engine, ShardedWindowEngine)
        assert sharded == ("mesh" in kw)
        assert agg._rung_display(0) == ("packed-sharded-pipelined"
                                        if sharded else "packed-pipelined")
        assert agg.window_health()["shards"] == (8 if sharded else 1)
        agg.shutdown()
        published.append(out)
    for a, b in zip(*published):
        assert sorted(a.names) == sorted(b.names)
        for name in a.names:
            i, j = a.rows[name], b.rows[name]
            for field in ("node_power_uw", "node_energy_uj",
                          "node_joules_total"):
                np.testing.assert_array_equal(
                    getattr(a, field)[i], getattr(b, field)[j],
                    err_msg=f"{name} {field}")
            assert a.render_node(name) == b.render_node(name)


# -- HTTP ----------------------------------------------------------------------------

@contextlib.contextmanager
def serving(server, cancel_cls):
    server.init()
    ctx = cancel_cls()
    thread = threading.Thread(target=server.run, args=(ctx,), daemon=True)
    thread.start()
    try:
        host, port = server.addresses[0]
        yield f"http://{host}:{port}"
    finally:
        ctx.cancel()
        thread.join(timeout=10)


def http(base: str, path: str, body: bytes | None = None) -> tuple:
    req = urllib.request.Request(base + path, data=body,
                                 method="POST" if body else "GET")
    with urllib.request.urlopen(req, timeout=30) as resp:
        return resp.status, resp.read()


def frames(n_nodes: int, n_windows: int) -> list[list[bytes]]:
    """Per window, the wire-v2 frames of ``n_nodes`` agents: a keyframe
    first, then deltas against it (the base an agent keeps is its last
    acknowledged keyframe); node 0 never changes, so its deltas are
    FLAG_SAME."""
    out, bases = [], {}
    for win in range(n_windows):
        batch = []
        for i in range(n_nodes):
            name = f"node-{i}"
            seed = 0 if i == 0 else win * 10 + i
            rep = make_report(name, seed, w=5,
                              mode=MODE_MODEL if i % 3 == 2 else MODE_RATIO)
            full = jwire.encode_report_v2(rep, list(ZONES), seq=win + 1,
                                          run="r1")
            frame = full
            if name in bases:
                frame = jwire.encode_delta_v2(full, bases[name])
                assert frame is not None
                assert jwire.parse_header(frame).same == (i == 0)
            else:
                bases[name] = full
            batch.append(frame)
        out.append(batch)
    return out


def family_shapes(agg) -> list:
    """(name, type, sorted label-name tuples) of every collect() family."""
    return [(f.name, f.type,
             sorted({tuple(sorted(s.labels)) for s in f.samples}))
            for f in agg.collect()]


def test_http_surfaces_match_jax():
    peer = "127.0.0.1:28283"
    jserver = JServer(listen_addresses=["127.0.0.1:0"])
    pserver = PServer(listen_addresses=["127.0.0.1:0"])
    pair = Pair(jax_server=jserver, port_server=pserver, backend="pallas",
                model_mode="mlp", peers=[peer], self_peer=peer,
                admission_enabled=True, skew_tolerance=0.0,
                journal=(JJournal(enabled=True, node=peer),
                         PJournal(enabled=True, node=peer)))
    for agg in (pair.jax, pair.port):
        agg.init()
    windows = frames(4, 3)
    with serving(jserver, JCancel) as jbase, \
            serving(pserver, PCancel) as pbase:
        for win, batch in enumerate(windows):
            pair.ticks[0] += 5.0
            for base in (jbase, pbase):
                if win == 0:
                    for frame in batch:
                        status, _ = http(base, "/v1/report", frame)
                        assert status == 204
                else:
                    status, body = http(base, "/v1/reports",
                                        jwire.encode_report_batch(batch))
                    assert status == 200
                    assert [r["status"] for r in
                            json.loads(body)["results"]] == [204] * 4
            pair.jax.aggregate_once()
            pair.port.aggregate_once()
            for i in range(4):
                path = f"/v1/results?node=node-{i}"
                got = json.loads(http(pbase, path)[1])
                ref = json.loads(http(jbase, path)[1])
                if i % 3 == 2:  # a model row: f16 plane within rtol 1e-3
                    np.testing.assert_allclose(
                        [w["power_uw"] for w in got["workloads"]],
                        [w["power_uw"] for w in ref["workloads"]],
                        rtol=1e-3, atol=1e3)
                    got["workloads"] = ref["workloads"]
                    got["node_power_uw"] = ref["node_power_uw"]
                    got["node_energy_uj"] = ref["node_energy_uj"]
                    got["node_joules_total"] = ref["node_joules_total"]
                assert got == ref, path
        for path, required in (("/debug/window", WINDOW_REQUIRED),
                               ("/debug/fleet", FLEET_REQUIRED),
                               ("/debug/ring", RING_REQUIRED)):
            got = json.loads(http(pbase, path)[1])
            ref = json.loads(http(jbase, path)[1])
            assert required <= set(got), path
            assert set(got) == set(ref), path
        window = json.loads(http(pbase, "/debug/window")[1])
        for label, engine in window["engines"].items():
            assert ENGINE_REQUIRED <= set(engine), label
        fleet = json.loads(http(pbase, "/debug/fleet")[1])
        assert set(fleet["nodes"]) == {f"node-{i}" for i in range(4)}
        ring = json.loads(http(pbase, "/debug/ring")[1])
        assert ring["owned_nodes"] == 4 and ring["ownership_ratio"] == 1.0
        for path in ("/debug/journal", "/debug/bundle", "/healthz"):
            assert http(pbase, path)[0] == 200
    assert pair.port._stats["keyframe_requests_total"] == 0
    assert pair.port._stats["reports_total"] == \
        pair.jax._stats["reports_total"] == 12
    assert family_shapes(pair.port) == family_shapes(pair.jax)


# -- the binary ---------------------------------------------------------------------

@pytest.fixture
def kepler_logger():
    """cmd main() reconfigures the ``kepler`` logger; put it back."""
    logger = logging.getLogger("kepler")
    saved = (list(logger.handlers), logger.level, logger.propagate)
    yield logger
    logger.handlers[:] = saved[0]
    logger.setLevel(saved[1])
    logger.propagate = saved[2]


def test_cmd_main_without_cuda_returns_1_and_names_cuda(capsys,
                                                        kepler_logger):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    assert pcmd.main(["--no-exporter.prometheus"]) == 1
    assert "CUDA" in capsys.readouterr().out


def test_config_fragment_parses_as_jax():
    fragment = """
aggregator:
  interval: 2s
  fusedWindowK: 4
  pipelineDepth: 2
  model: temporal
  historyWindow: 8
  repromoteAfter: 3
tpu:
  fleetBackend: pallas
  nodeBucket: 1024
  workloadBucket: 256
fault:
  enabled: true
  specs: [{site: device.dispatch_error, skip: 2, count: 1}]
"""
    got = pconfig.Builder().use(fragment).build()
    ref = jconfig.Builder().use(fragment).build()
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.tpu.fleet_backend == "pallas"
    assert got.aggregator.fused_window_k == 4


def test_shutdown_waits_for_the_fetch_worker_to_end():
    """``shutdown()`` stops the window fetch worker and waits for its
    thread to end: a daemon thread that has used CUDA and is still
    ending while the process exits aborts the process (the chaos
    binary on the card did, "terminate called without an active
    exception")."""
    agg = PAggregator(PServer(), device="cpu", model_mode=None)
    agg.init()
    assert agg._fetch_device(lambda: 7) == 7  # through the worker
    worker = agg._fetch_worker
    assert worker is not None and worker.alive()
    agg.shutdown()
    assert not worker.alive() and agg._fetch_worker is None
