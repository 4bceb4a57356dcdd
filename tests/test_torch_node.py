"""The port's node agent against the JAX package's, on the CPU.

Two identical fake hosts are built from a numpy seed (``chip_smoke``'s
``build_fake_host``: a few hundred processes, half in docker/kubepods
cgroups, four RAPL zones); one runs the JAX package's stack, the other
the port's at ``device="cpu"``, on the same fake clock and the same
schedule (CPU churn, a burst of new processes, terminations past
``max_terminated``, an injected read error and counter wrap).

Tolerances:

- energy deltas, the top-k selection (ties included) and the informer's
  ``FeatureBatch``: exact;
- the monitor's node and workload arrays and the rendered values: rtol
  1e-6 (``attribute``'s f32 operations, which XLA may fuse; one f32
  rounding apart);
- agents reporting into the two Aggregators: the same ``/v1/results``,
  so the f16 plane of the ratio rows bit-equal.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import os
import re
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import jax
import numpy as np
import pytest

import chip_smoke as host
from kepler_tpu import fault as jfault
from kepler_tpu.fleet.aggregator import Aggregator as JAggregator
from kepler_tpu.parallel.mesh import make_mesh
from kepler_tpu.server.http import APIServer as JServer
from kepler_tpu.service.lifecycle import CancelContext as JCancel
from kepler_tpu_torch import fault as pfault
from kepler_tpu_torch.fleet.aggregator import Aggregator as PAggregator
from kepler_tpu_torch.server.http import APIServer as PServer
from kepler_tpu_torch.service.lifecycle import CancelContext as PCancel
from tests.test_torch_aggregator import http, serving

PACKAGES = ("kepler_tpu", "kepler_tpu_torch")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ("processes", "containers", "virtual_machines", "pods")


def both(module: str) -> list:
    """``module`` imported from each package (JAX's first)."""
    return [importlib.import_module(f"{pkg}.{module}") for pkg in PACKAGES]


def port_kw(pkg: str) -> dict:
    """The port's monitor runs on the CPU only when asked."""
    return {"device": "cpu"} if pkg == "kepler_tpu_torch" else {}


# -- deltas and top-k ---------------------------------------------------------

def test_energy_deltas_exact_with_wraps_and_no_wrap_point():
    rng = np.random.default_rng(0)
    prev = rng.integers(0, 2**62, 256, dtype=np.uint64)
    cur = rng.integers(0, 2**62, 256, dtype=np.uint64)
    cur[:64] = prev[:64] + rng.integers(0, 2**20, 64, dtype=np.uint64)
    max_e = np.full(256, 2**62, np.uint64)
    max_e[200:] = 0  # no wrap point: a backwards counter gives 0
    out = []
    for mod in both("ops.deltas"):
        vec = mod.energy_deltas(cur, prev, max_e)
        scalar = [mod.energy_delta(int(c), int(p), int(m))
                  for c, p, m in zip(cur, prev, max_e)]
        out.append((vec, scalar))
    (jv, js), (pv, ps) = out
    assert np.array_equal(pv, jv) and ps == js
    assert (np.asarray(ps)[200:][cur[200:] < prev[200:]] == 0).all()
    assert any(c < p for c, p in zip(cur[:200], prev[:200]))  # wraps ran


def topk_cases():
    rng = np.random.default_rng(1)
    ties = rng.integers(0, 3, 500).astype(np.float64)
    near = 1e8 + np.arange(1.0, 9.0)  # distinct in f64, equal in f32
    mixed = np.concatenate([rng.uniform(0, 50, 200), np.zeros(300),
                            np.full(100, 7.0)])
    return [("ties at the boundary", ties, 100, 0.0),
            ("f64 values that tie in f32", near, 3, 0.0),
            ("threshold and zero ties", mixed, 250, 0.0),
            ("threshold filters", mixed, 400, 7.0),
            ("k above n", ties[:20], 50, 1.0),
            ("k = 0", ties, 0, 0.0),
            ("none qualify", ties, 10, 5.0)]


@pytest.mark.parametrize("case", topk_cases(), ids=lambda c: c[0])
def test_top_k_selects_the_same_indices_as_jax(case):
    """``lax.top_k`` order: f32 compare, lower index first among equal
    values. ``torch.topk`` alone picks other indices at a tied
    boundary."""
    _, energies, k, min_e = case
    from kepler_tpu.ops.topk import top_k_by_energy as jtop
    from kepler_tpu_torch.ops.topk import top_k_by_energy as ptop

    want = jtop(energies, k, min_e)
    got = ptop(energies, k, min_e, device="cpu")
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


# -- meters ---------------------------------------------------------------------

def powercap_tree(root: str, counters: dict[str, int]) -> str:
    """A two-socket powercap tree (two packages aggregate into one zone)."""
    zones = {"intel-rapl:0": "package-0", "intel-rapl:1": "package-1",
             "intel-rapl:0:0": "core", "intel-rapl:0:1": "dram",
             "intel-rapl:0:2": "uncore"}
    for d, name in zones.items():
        zd = os.path.join(root, "class", "powercap", d)
        os.makedirs(zd, exist_ok=True)
        for fname, val in (("name", name),
                           ("energy_uj", counters.get(d, 1000)),
                           ("max_energy_range_uj", 2**32)):
            with open(os.path.join(zd, fname), "w") as f:
                f.write(f"{val}\n")
    return root


def meter_reading(meter) -> tuple:
    meter.init()
    zones = meter.zones()
    return ([z.name() for z in zones], meter.primary_energy_zone().name(),
            [int(z.energy()) for z in zones],
            [int(z.max_energy()) for z in zones])


def test_rapl_meter_reads_as_jax(tmp_path):
    sysfs = powercap_tree(str(tmp_path), {"intel-rapl:0": 5_000,
                                          "intel-rapl:1": 7_000})
    reads = []
    for mod in both("device.rapl"):
        meter = mod.RaplPowerMeter(sysfs_path=sysfs)
        first = meter_reading(meter)
        powercap_tree(sysfs, {"intel-rapl:0": 9_000, "intel-rapl:1": 8_000,
                              "intel-rapl:0:1": 1})
        reads.append((first, [int(z.energy()) for z in meter.zones()]))
        powercap_tree(sysfs, {"intel-rapl:0": 5_000, "intel-rapl:1": 7_000})
    assert reads[1] == reads[0]
    assert reads[0][0][1].startswith("package")


def test_msr_meter_reads_as_jax(tmp_path):
    from test_msr import DRAM, PKG, PP0, make_tree

    dev, topo = make_tree(tmp_path, sockets=2,
                          counters={(0, PKG): 65536, (1, PKG): 3 * 65536,
                                    (0, PP0): 12345, (1, DRAM): 777})
    reads = [meter_reading(mod.MsrPowerMeter(device_path=dev,
                                             topology_path=topo))
             for mod in both("device.msr")]
    assert reads[1] == reads[0]
    assert reads[0][1].startswith("package")


def test_fake_meter_reads_as_jax(monkeypatch):
    import time as time_mod

    reads = []
    for mod in both("device.fake"):
        ticks = iter(np.arange(100.0, 200.0, 0.5))
        monkeypatch.setattr(time_mod, "monotonic", lambda: next(ticks))
        reads.append(meter_reading(mod.FakeCPUMeter(seed=7)))
    assert reads[1] == reads[0]
    assert reads[0][0] == ["package", "core", "dram", "uncore"]


# -- the informer -----------------------------------------------------------------

def batch_fields(batch) -> tuple:
    return (list(batch.ids), batch.kinds.tolist(), batch.kind_offsets,
            batch.cpu_deltas.tobytes(), batch.usage_ratio,
            batch.node_cpu_delta,
            None if batch.cpu_totals is None else batch.cpu_totals.tobytes())


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
def test_informer_feature_batch_equals_jax(tmp_path, native):
    trees = [host.build_fake_host(str(tmp_path / pkg), 300, seed=3)
             for pkg in PACKAGES]
    informers = []
    for (proc, _, _), mod in zip(trees, both("resource")):
        reader = mod.make_proc_reader(proc, use_native=native)
        assert isinstance(reader, mod.FastProcFSReader) == native
        informers.append(mod.ResourceInformer(reader=reader,
                                              procfs_path=proc,
                                              clock=lambda: 1e9))
    live = [list(t[2]) for t in trees]
    for tick in range(5):
        for i, (proc, sysfs, _) in enumerate(trees):
            if tick == 2:
                live[i] += host.spawn_burst(proc, 50_000, 40)
            if tick == 3:
                host.kill_procs(proc, live[i][:30])
                live[i] = live[i][30:]
            host.advance_host(proc, sysfs, live[i], tick)
            informers[i].refresh()
        jb, pb = (inf.feature_batch() for inf in informers)
        assert batch_fields(pb) == batch_fields(jb), tick
        for kind in ("processes", "containers", "virtual_machines", "pods"):
            views = [getattr(inf, kind)() for inf in informers]
            assert list(views[1].running) == list(views[0].running)
            assert list(views[1].terminated) == list(views[0].terminated)
    assert len(jb.ids) > 300 and jb.kind_offsets[1] < jb.kind_offsets[2]


# -- the monitor ---------------------------------------------------------------------

FAULTS = (("device.read_error", 4 * 3, None), ("device.counter_wrap", 19, 0.0))


def monitor_pair(tmp_path, n_procs: int = 300, **kw):
    """Two fake hosts from one seed, the JAX package's monitor over the
    first and the port's (``device="cpu"``) over the second, on one fake
    clock. → (clock, [(monitor, informer, proc, sysfs, live pids)])."""
    clock = host.FakeClock()
    sides = []
    for pkg in PACKAGES:
        proc, sysfs, pids = host.build_fake_host(str(tmp_path / pkg),
                                                 n_procs, seed=5)
        res = importlib.import_module(f"{pkg}.resource")
        rapl = importlib.import_module(f"{pkg}.device.rapl")
        mon = importlib.import_module(f"{pkg}.monitor.monitor")
        informer = res.ResourceInformer(
            reader=res.make_proc_reader(proc), procfs_path=proc,
            clock=clock)
        monitor = mon.PowerMonitor(
            rapl.RaplPowerMeter(sysfs_path=sysfs), informer, interval=0,
            staleness=0.0, clock=clock, **kw, **port_kw(pkg))
        monitor.init()
        sides.append([monitor, informer, proc, sysfs, list(pids)])
    return clock, sides


def tick_hosts(clock, sides, tick: int) -> None:
    """One interval on both hosts: a burst on tick 2, 80 terminations on
    tick 3, 10 % churn every tick."""
    clock.t += 5.0
    for side in sides:
        _, _, proc, sysfs, live = side
        if tick == 2:
            live += host.spawn_burst(proc, 50_000, 60)
        if tick == 3:
            host.kill_procs(proc, live[:80])
            del live[:80]
        host.advance_host(proc, sysfs, live, tick)


@contextlib.contextmanager
def fault_plans(specs):
    with jfault.installed(jfault.FaultPlan(
            [jfault.FaultSpec(site=s, skip=k, count=1, arg=a)
             for s, k, a in specs])) as jp, \
            pfault.installed(pfault.FaultPlan(
                [pfault.FaultSpec(site=s, skip=k, count=1, arg=a)
                 for s, k, a in specs])) as pp:
        yield jp, pp


def assert_same_snapshot(got, ref, what: str) -> None:
    for key in ("energy_uj", "active_uj", "idle_uj", "power_uw",
                "active_power_uw", "idle_power_uw", "window_active_uj"):
        np.testing.assert_allclose(getattr(got.node, key),
                                   getattr(ref.node, key), rtol=1e-6,
                                   err_msg=f"{what} node.{key}")
    for kind in KINDS:
        for tag in ("", "terminated_"):
            a, b = getattr(got, tag + kind), getattr(ref, tag + kind)
            assert a.ids == b.ids, f"{what} {tag}{kind} ids"
            assert [dict(m) for m in a.meta] == [dict(m) for m in b.meta]
            np.testing.assert_allclose(a.energy_uj, b.energy_uj, rtol=1e-6,
                                       err_msg=f"{what} {tag}{kind}")
            np.testing.assert_allclose(a.power_uw, b.power_uw, rtol=1e-6,
                                       err_msg=f"{what} {tag}{kind}")
            if b.seconds is None:
                assert a.seconds is None
            else:
                np.testing.assert_array_equal(a.seconds, b.seconds)


def test_monitor_matches_jax_through_churn_bursts_terminations_and_faults(
        tmp_path):
    clock, sides = monitor_pair(tmp_path, max_terminated=25,
                                min_terminated_energy_uj=0.0)
    with fault_plans(FAULTS) as plans:
        for tick in range(6):
            tick_hosts(clock, sides, tick)
            for side in sides:
                side[0].refresh()
            ref, got = (s[0]._snapshot for s in sides)
            assert_same_snapshot(got, ref, f"tick {tick}")
        for plan in plans:
            assert {s: plan.fired(s) for s, _, _ in FAULTS} == {
                s: 1 for s, _, _ in FAULTS}
    snap = sides[1][0]._snapshot
    # 80 ended; top-k kept 25, most of them tied at zero energy
    assert len(snap.terminated_processes.ids) == 25
    assert len(sides[1][0]._snapshot.processes.ids) == 300 + 60 - 80


def test_monitor_restores_a_state_file_the_jax_monitor_wrote(tmp_path,
                                                             caplog):
    state = str(tmp_path / "state.json")
    clock, sides = monitor_pair(tmp_path, n_procs=20, state_path=state)
    jmon = sides[0][0]
    for tick in range(2):
        tick_hosts(clock, sides[:1], tick)
        jmon.refresh()
    with open(state) as f:
        saved = json.load(f)
    # a second monitor of each package over the JAX host adopts the file
    clock.t += 1.0
    restored = []
    for pkg in PACKAGES:
        res = importlib.import_module(f"{pkg}.resource")
        rapl = importlib.import_module(f"{pkg}.device.rapl")
        mon = importlib.import_module(f"{pkg}.monitor.monitor")
        proc, sysfs = sides[0][2], sides[0][3]
        m = mon.PowerMonitor(
            rapl.RaplPowerMeter(sysfs_path=sysfs),
            res.ResourceInformer(reader=res.make_proc_reader(proc),
                                 procfs_path=proc, clock=clock),
            interval=0, staleness=0.0, clock=clock, state_path=state,
            **port_kw(pkg))
        with caplog.at_level("INFO", logger="kepler.monitor"):
            m.init()
        restored.append(m)
    assert restored[1]._prev_counters == restored[0]._prev_counters \
        == saved["counters"]
    assert restored[1]._last_read_ts == restored[0]._last_read_ts
    assert sum("monitor state restored" in r.getMessage()
               for r in caplog.records) == 2
    # the first window after the restart attributes across it, the same
    host.advance_host(sides[0][2], sides[0][3], sides[0][4], 2)
    for m in restored:
        m._state_path = ""  # read the file, never rewrite it here
        m.refresh()
    got, ref = restored[1]._snapshot, restored[0]._snapshot
    assert ref.node.energy_uj.sum() > 0
    np.testing.assert_allclose(got.node.energy_uj, ref.node.energy_uj,
                               rtol=1e-6)


# -- exposition ----------------------------------------------------------------------

def parse_exposition(text: bytes) -> tuple[list, list, list]:
    """→ (family names in order, (family, labels) per sample in order,
    sample values)."""
    fams, series, values = [], [], []
    for line in text.decode().splitlines():
        if line.startswith("# TYPE "):
            fams.append(line.split()[2])
        elif line and not line.startswith("#"):
            head, value = line.rsplit(" ", 1)
            name, _, labels = head.partition("{")
            series.append((name, labels))
            values.append(float(value))
    return fams, series, values


@pytest.mark.parametrize("openmetrics", [False, True],
                         ids=["classic", "openmetrics"])
def test_power_collector_renders_as_jax(tmp_path, openmetrics):
    clock, sides = monitor_pair(tmp_path, n_procs=120)
    collectors = []
    for pkg, side in zip(PACKAGES, sides):
        col = importlib.import_module(f"{pkg}.exporter.prometheus.collector")
        collectors.append(col.PowerCollector(side[0], node_name="n1"))
    for tick in range(4):
        tick_hosts(clock, sides, tick)
        if tick == 0:  # the first refresh makes the collectors ready
            for side in sides:
                side[0].refresh()
            continue
        # staleness 0: every scrape refreshes, then renders
        jt, pt = (c.render_text(openmetrics=openmetrics)
                  for c in collectors)
        (jf, js, jv), (pf, ps, pv) = (parse_exposition(t) for t in (jt, pt))
        assert pf == jf and ps == js, tick
        np.testing.assert_allclose(pv, jv, rtol=1e-6)
    assert any(f.startswith("kepler_process_cpu_") for f in jf)
    assert len(js) > 500


# -- the fleet agent -------------------------------------------------------------

def get(base: str, path: str) -> dict:
    status, body = http(base, path)
    assert status == 200, path
    return json.loads(body)


def aggregators(ticks: list):
    """The JAX aggregator pinned to one device and the port's on the
    CPU, behind live servers, on the fake clock ``ticks[0]``."""
    kw = dict(node_bucket=8, workload_bucket=64, stale_after=1e9,
              model_mode=None, clock=lambda: ticks[0])
    jserver = JServer(listen_addresses=["127.0.0.1:0"])
    pserver = PServer(listen_addresses=["127.0.0.1:0"])
    jagg = JAggregator(jserver, **kw)
    jagg._mesh = make_mesh(devices=jax.devices()[:1])
    pagg = PAggregator(pserver, device="cpu", **kw)
    for agg in (jagg, pagg):
        agg.init()
    return (jagg, jserver), (pagg, pserver)


def test_agents_into_aggregators_match_jax(tmp_path):
    ticks = [1e9]
    (jagg, jserver), (pagg, pserver) = aggregators(ticks)
    nodes = []
    for n in range(2):
        clock, sides = monitor_pair(tmp_path / f"n{n}", n_procs=120)
        clock.t = ticks[0]
        nodes.append((clock, sides))
    with serving(jserver, JCancel) as jbase, \
            serving(pserver, PCancel) as pbase:
        agents = []
        for n, (clock, sides) in enumerate(nodes):
            for pkg, side, base in zip(PACKAGES, sides, (jbase, pbase)):
                base = base.removeprefix("http://")
                side[0].refresh()  # seeds the counters
                agent_mod = importlib.import_module(f"{pkg}.fleet.agent")
                agent = agent_mod.FleetAgent(side[0], endpoint=base,
                                             node_name=f"node-{n}",
                                             clock=clock, jitter_seed=0)
                agent.init()
                agents.append(agent)
        for win in range(3):
            ticks[0] += 5.0
            for clock, sides in nodes:
                tick_hosts(clock, sides, win + 1)
                clock.t = ticks[0]
                for side in sides:
                    side[0].refresh()
            for agent in agents:
                agent._drain(None)
            jres, pres = jagg.aggregate_once(), pagg.aggregate_once()
            assert jres is not None and pres is not None
            for n in range(2):
                path = f"/v1/results?node=node-{n}"
                ref, got = get(jbase, path), get(pbase, path)
                assert got == ref, (win, n)
                assert len(got["workloads"]) > 100
                i, j = jres.rows[f"node-{n}"], pres.rows[f"node-{n}"]
                np.testing.assert_array_equal(pres._wl_watts_f16[j],
                                              jres._wl_watts_f16[i])
        stats = [a._stats for a in agents]
    assert [s["send_failures"] for s in stats] == [0] * 4
    assert [s["deltas_sent"] for s in stats[1::2]] == \
        [s["deltas_sent"] for s in stats[::2]]
    assert pagg._stats["reports_total"] == jagg._stats["reports_total"] == 6


def test_port_agent_replays_a_spool_the_jax_agent_wrote(tmp_path):
    from kepler_tpu.fleet.agent import FleetAgent as JAgent
    from kepler_tpu.fleet.spool import Spool as JSpool
    from kepler_tpu_torch.fleet.agent import FleetAgent as PAgent
    from kepler_tpu_torch.fleet.spool import Spool as PSpool

    spool_dir = str(tmp_path / "spool")
    clock, sides = monitor_pair(tmp_path, n_procs=120)
    jmon, pmon = sides[0][0], sides[1][0]
    jmon.refresh()
    jspool = JSpool(spool_dir)
    # the aggregator is down: every window stays in the spool
    JAgent(jmon, endpoint="127.0.0.1:9", node_name="node-s", clock=clock,
           spool=jspool).init()
    for tick in range(1, 4):
        tick_hosts(clock, sides[:1], tick)
        jmon.refresh()
    assert jspool.pending_records() == 3
    jspool.close()

    ticks = [clock.t]
    pagg, pserver = aggregators(ticks)[1]
    pspool = PSpool(spool_dir)
    assert pspool.pending_records() == 3
    with serving(pserver, PCancel) as pbase:
        agent = PAgent(pmon, endpoint=pbase.removeprefix("http://"),
                       node_name="node-s", clock=clock, spool=pspool)
        agent.init()
        agent._drain(None)
        assert pspool.pending_records() == 0
        assert pagg._stats["reports_total"] == 3
        assert pagg.aggregate_once() is not None
        res = get(pbase, "/v1/results?node=node-s")
    assert len(res["workloads"]) > 100
    assert np.isfinite([w["power_uw"] for w in res["workloads"]]).all()


# -- the binary -----------------------------------------------------------------------

def test_node_binary_on_cpu_serves_metrics_and_stops_on_sigterm(tmp_path):
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    cfg = tmp_path / "node.yaml"
    cfg.write_text("dev:\n  fake-cpu-meter:\n    enabled: true\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.Popen(
        [sys.executable, "-m", "kepler_tpu_torch.cmd.main", "--device",
         "cpu", "--config.file", str(cfg), "--monitor.interval", "1s",
         "--web.listen-address", f"127.0.0.1:{port}"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        deadline = time.monotonic() + 60
        body = b""
        while b"kepler_process_cpu_" not in body:
            assert proc.poll() is None, proc.communicate()[0][-2000:]
            assert time.monotonic() < deadline, "no /metrics"
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
                    body = r.read()
            except OSError:
                time.sleep(0.2)
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            out, _ = proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
    assert proc.returncode == 0, out[-2000:]
    assert "Graceful shutdown completed" in out
    assert re.search(rb"^kepler_node_cpu_watts\{", body, re.M)
    assert " on cpu" in out


def test_split_device_strips_the_port_flag():
    from kepler_tpu_torch.cmd.main import split_device

    assert split_device(["--device", "cpu", "--x", "1"]) == ("cpu",
                                                             ["--x", "1"])
    assert split_device(["--device=cuda"]) == ("cuda", [])
    assert split_device([]) == ("cuda", [])
    with pytest.raises(ValueError, match="cuda or cpu"):
        split_device(["--device", "tpu"])
