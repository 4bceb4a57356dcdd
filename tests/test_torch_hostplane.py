"""The port's copies of the jax-free host modules against the originals.

Every module the Aggregator slice copied into ``kepler_tpu_torch`` (only
its imports changed) gets one seeded scenario that runs through the JAX
package's module and the port's and must give the same answers: the
ingest ring, membership decisions, the dedup/loss tracker, the journal,
the scoreboard, admission control, the HLC, the row store, the service
lifecycle's restart policy, the health registry, the HTTP server, the web
config, the config layer and the exposition renderers.
"""

from __future__ import annotations

import importlib
import io
import json
import logging
import random
import threading
import urllib.request

import numpy as np
import pytest

PACKAGES = ("kepler_tpu", "kepler_tpu_torch")


def both(module: str) -> list:
    """``module`` imported from each package (JAX's first)."""
    return [importlib.import_module(f"{pkg}.{module}") for pkg in PACKAGES]


def same(fn, module: str):
    """``fn(mod)`` for each package's ``module`` → the shared answer."""
    ref, got = (fn(m) for m in both(module))
    assert got == ref
    return got


def names(n: int, seed: int) -> list[str]:
    rng = random.Random(seed)
    return [f"node-{rng.getrandbits(48):012x}" for _ in range(n)]


def test_hash_ring_owners_for_1000_names_and_3_peers():
    peers = ["10.0.0.1:28283", "10.0.0.2:28283", "10.0.0.3:28283"]
    keys = names(1000, 0)

    def owners(ring_mod):
        ring = ring_mod.HashRing(peers, epoch=3, vnodes=64)
        grown = ring.with_members(peers + ["10.0.0.4:28283"], 4)
        return ([ring.owner(k) for k in keys], ring.membership_digest,
                [round(ring.ownership_ratio(p), 12) for p in peers],
                [grown.owner(k) for k in keys])

    got = same(owners, "fleet.ring")
    assert set(got[0]) == set(peers)


def test_membership_plans_and_succession():
    peers = ["a:1", "b:1", "c:1"]
    proposals = [(2, ["a:1", "b:1"], "operator"),
                 (1, ["a:1", "b:1", "c:1"], "wire"),
                 (1, ["a:1", "c:1"], "wire"),
                 (0, ["a:1"], "operator"),
                 (5, ["b:1", "c:1"], "succession"),
                 (3, ["a:1", "b:1", "c:1", "d:1"], "join")]

    def plans(mod):
        ring = importlib.import_module(
            mod.__name__.rsplit(".", 1)[0] + ".ring").HashRing(
                peers, epoch=1)
        out = []
        for epoch, new, source in proposals:
            try:
                d = mod.plan_membership_apply(
                    ring.epoch, ring.peers, ring.membership_digest, epoch,
                    new, "a:1", source)
                out.append((d.action, d.epoch, tuple(d.peers), d.retired))
            except mod.MembershipError as err:
                out.append(("rejected", err.reason))
        out.append([mod.plan_succession(h, s) for h, s in (
            ("b:1", ["a:1", "b:1"]), ("c:1", ["a:1", "b:1"]),
            ("", ["c:1", "b:1"]))])
        out.append(mod.elect_successor(["c:1", "a:1", "b:1"]))
        return out

    got = same(plans, "fleet.membership")
    assert {x[0] for x in got[:len(proposals)]} >= {"rejected"}


def test_seq_tracker_gaps_and_duplicates():
    rng = np.random.default_rng(7)
    seqs = [int(s) for s in rng.integers(1, 60, 200)]

    def observe(mod):
        tracker = mod.SeqTracker("r1", 16)
        mod.seed_fresh_tracker(tracker, 3, seqs[0])
        out = [tracker.observe(s) for s in seqs]
        mod.reseed_on_ownership_return(tracker, 2, 40, 45)
        out.append(tracker.observe(44))
        out.append(mod.delta_base_matches("r1", 5, "r1", 5))
        out.append(mod.delta_base_matches("r1", 5, "r2", 5))
        return out

    got = same(observe, "fleet.delivery")
    assert any(dup for dup, _ in got[:200])
    assert any(lost for _, lost in got[:200])


def test_journal_canonical_json_and_spool_round_trip(tmp_path):
    doc = {"b": [1, 2.5, {"z": None}], "a": "x", "ü": True}

    def journal(mod):
        ticks = iter(float(1.7e9 + i) for i in range(1000))
        d = tmp_path / mod.__name__.split(".")[0]
        jnl = mod.EventJournal(enabled=True, node="agg-0", dir=str(d),
                               clock=lambda: next(ticks))
        for k in range(5):
            jnl.emit("rung.transition", rung=k % 4, rung_name="x",
                     from_rung=0, from_rung_name="y", reason="stall")
        jnl.emit("quarantine.onset", node="n1", reason="malformed")
        jnl.close()
        files = sorted(p for p in d.iterdir() if p.suffix == ".kepj")
        frames = [f for p in files for f in mod.read_frames(str(p))]
        stats = jnl.stats()
        stats["spool"] = stats["spool"].rsplit("/", 1)[-1]
        return (mod.canonical_json(doc), frames, jnl.snapshot(),
                sorted(stats.items()))

    got = same(journal, "fleet.journal")
    assert len(got[1]) == 6


def test_scoreboard_states():
    def states(mod):
        rng = np.random.default_rng(11)
        board = mod.FleetScoreboard(cap=16, anomaly_z=3.0, flag_ttl=30.0)
        now = 1000.0
        for step in range(40):
            now += 5.0
            for i in range(10):
                node = f"n{i}"
                power = float(rng.normal(100.0, 2.0))
                if i == 3 and step == 35:
                    power = 400.0  # an anomaly
                if i == 5 and step > 20:
                    continue  # goes stale
                board.observe_report(node, now, power,
                                     lost=1 if (i == 7 and step == 30)
                                     else 0)
            if step == 32:
                board.observe_quarantine("n8", now, "malformed")
        return board.states(now, 15.0), board.snapshot(now, 15.0)

    got = same(states, "fleet.scoreboard")
    assert set(got[0].values()) - {0}  # some node left "healthy"


def test_admission_decisions_with_jitter_seed():
    def decisions(mod):
        ticks = [0.0]
        ctrl = mod.AdmissionController(
            max_inflight=4, latency_budget=0.05, retry_after=0.5,
            retry_after_max=8.0, jitter_seed=1234,
            monotonic=lambda: ticks[0])
        out = []
        for step in range(60):
            ticks[0] += 0.01
            prio = step % 4
            retry = ctrl.admit(prio)
            out.append(None if retry is None else round(retry, 12))
            if retry is None and step % 3:
                ctrl.done(0.02 + 0.01 * (step % 7))
        out.append(ctrl.shed_by_reason())
        out.append(round(ctrl.load(), 12))
        out.append(ctrl.health())
        return out

    got = same(decisions, "fleet.admission")
    assert any(x is not None for x in got[:60])


def test_hlc_clock_observe_and_parse():
    def stamps(mod):
        ticks = iter([10.0, 10.0, 9.5, 11.0, 500.0, 12.0])
        clock = mod.HlcClock("n", clock=lambda: next(ticks),
                             max_drift_s=60.0)
        out = [clock.now(), clock.now()]
        out.append(clock.observe(mod.HLC(10_500_000, 3, "m")))
        out.append(clock.now())
        out.append(clock.observe(mod.HLC(900_000_000, 0, "m")))
        out.append(clock.clamped_total())
        out.append(mod.parse_hlc(out[0].encode()))
        out.append(mod.parse_hlc("garbage"))
        return [tuple(x) if isinstance(x, tuple) else x for x in out]

    same(stamps, "telemetry.hlc")


def test_row_store_accumulates_and_remaps():
    rng = np.random.default_rng(5)
    batches = [(tuple(f"w{i}" for i in rng.choice(20, 8, replace=False)),
                rng.uniform(0, 10, (8, 2))) for _ in range(12)]

    def run(mod):
        store = mod.RowStore(2, initial_rows=4)
        out = [store.accumulate(ids, vals).tolist()
               for ids, vals in batches]
        store.pop("w3")
        store.remap_columns(["package", "dram"], ["dram", "package",
                                                  "uncore"])
        out.append(store.accumulate(("w1", "w3"),
                                    np.ones((2, 3))).tolist())
        return out

    same(run, "utils.rowstore")


def test_restart_policy_backoff_and_logger():
    def backoffs(mod):
        policy = mod.RestartPolicy(max_restarts=5, backoff_initial=0.5,
                                   backoff_max=4.0, seed=3)
        rng = random.Random(3)
        return [round(policy.backoff(a, rng), 12) for a in range(8)]

    same(backoffs, "service.lifecycle")

    def log_line(mod):
        logger = logging.getLogger("kepler")
        saved = (list(logger.handlers), logger.level, logger.propagate)
        stream = io.StringIO()
        try:
            mod.new_logger("info", "json", stream=stream)
            logger.getChild("x").info("hello %d", 3)
        finally:
            logger.handlers[:] = saved[0]
            logger.setLevel(saved[1])
            logger.propagate = saved[2]
        line = json.loads(stream.getvalue())
        return line["level"], line["logger"], line["msg"]

    same(log_line, "utils.logger")


def test_health_registry_and_http_server():
    def serve(health_mod):
        pkg = health_mod.__name__.split(".")[0]
        http = importlib.import_module(f"{pkg}.server.http")
        lifecycle = importlib.import_module(f"{pkg}.service.lifecycle")
        server = http.APIServer(listen_addresses=["127.0.0.1:0"])
        server.health.register_probe("a", lambda: {"ok": True})
        server.health.register_probe("b", lambda: {"ok": False,
                                                   "why": "x"})
        server.register("/v1/echo", "Echo", "echo the body",
                        lambda r: (200, {"Content-Type": "text/plain"},
                                   r.body[::-1]))
        server.init()
        ctx = lifecycle.CancelContext()
        thread = threading.Thread(target=server.run, args=(ctx,),
                                  daemon=True)
        thread.start()
        host, port = server.addresses[0]
        base = f"http://{host}:{port}"
        out = []
        try:
            req = urllib.request.Request(base + "/v1/echo", data=b"abc",
                                         method="POST")
            with urllib.request.urlopen(req, timeout=10) as resp:
                out.append((resp.status, resp.read()))
            for path in ("/healthz", "/readyz", "/nope"):
                try:
                    with urllib.request.urlopen(base + path,
                                                timeout=10) as resp:
                        out.append((resp.status, json.loads(resp.read())))
                except urllib.error.HTTPError as err:
                    out.append((err.code, err.read()[:40]))
        finally:
            ctx.cancel()
            thread.join(timeout=10)
        out.append(server.health.check_health())
        return out

    got = same(serve, "server.health")
    assert got[0] == (200, b"cba")


def test_web_config_and_shacrypt(tmp_path):
    hashed = "$6$rounds=5000$saltsalt$" + "x" * 86

    def parse(mod):
        pkg = mod.__name__.split(".")[0]
        sha = importlib.import_module(f"{pkg}.server.shacrypt")
        digest = sha.sha_crypt("secret", "$6$rounds=5000$saltsalt$")
        path = tmp_path / f"{pkg}.yaml"
        path.write_text("basic_auth_users:\n  alice: '" + digest + "'\n")
        cfg = mod.load_web_config(str(path))
        return (digest, sha.verify("secret", digest),
                sha.verify("nope", digest), sha.verify("secret", hashed),
                cfg.basic_auth_users, cfg.has_tls)

    got = same(parse, "server.webconfig")
    assert got[1] is True and got[2] is False


def test_config_defaults_flags_and_levels():
    argv = ["--aggregator.fused-window-k", "4", "--tpu.fleet-backend",
            "pallas", "--no-exporter.prometheus", "--metrics", "node",
            "--metrics", "pod"]

    def parse(mod):
        import dataclasses

        pkg = mod.__name__.split(".")[0]
        level = importlib.import_module(f"{pkg}.config.level")
        version = importlib.import_module(f"{pkg}.version")
        cfg = mod.parse_args_and_config(argv, skip_validation=("host",))
        return (dataclasses.asdict(cfg),
                dataclasses.asdict(mod.default_config()),
                int(level.parse_level(["node", "container"])),
                version.info().version)

    got = same(parse, "config.config")
    assert got[0]["aggregator"]["fused_window_k"] == 4


def test_exposition_renders_the_same_bytes():
    from prometheus_client import CollectorRegistry
    from prometheus_client.core import CounterMetricFamily, GaugeMetricFamily

    class Families:
        def collect(self):
            g = GaugeMetricFamily("kepler_fleet_nodes", "Nodes",
                                  labels=["zone"])
            for z, v in (("package", 1.5), ("dram", float("nan")),
                         ("core", 1e-9)):
                g.add_metric([z], v)
            yield g
            c = CounterMetricFamily("kepler_fleet_reports_total",
                                    "Reports \\ \"quoted\"\n")
            c.add_metric([], 12.0)
            yield c

    class Req:
        headers = {"Accept": "application/openmetrics-text; version=1.0.0"}

    def render(mod):
        pkg = mod.__name__.split(".")[0]
        info = importlib.import_module(
            f"{pkg}.exporter.prometheus.info_collectors")
        exporter = importlib.import_module(
            f"{pkg}.exporter.prometheus.exporter")
        registry = CollectorRegistry()
        registry.register(Families())
        health = importlib.import_module(f"{pkg}.server.health")
        reg = health.HealthRegistry()
        reg.register_probe("x", lambda: {"ok": True})
        registry.register(info.HealthCollector(reg))
        handler = exporter.make_registry_handler(registry)
        return (mod.fast_generate_latest(registry),
                mod.fast_generate_openmetrics(registry),
                handler(Req())[2], mod.wants_openmetrics(Req()),
                [mod.fmt_float(v) for v in (0.1, 1e21, -0.0, 3.0)])

    got = same(render, "exporter.prometheus.fastexpo")
    assert b"kepler_fleet_nodes" in got[0]


COPIED = ("utils/rowstore.py", "telemetry/hlc.py", "fleet/delivery.py",
          "fleet/ring.py", "fleet/membership.py", "fleet/admission.py",
          "fleet/journal.py", "fleet/scoreboard.py", "service/lifecycle.py",
          "server/health.py", "server/http.py", "server/shacrypt.py",
          "config/level.py", "version.py", "exporter/prometheus/fastexpo.py",
          "device/energy.py", "device/meter.py", "device/aggregated.py",
          "device/fake.py", "device/rapl.py", "device/msr.py",
          "native/__init__.py", "resource/types.py", "resource/procfs.py",
          "resource/fast_procfs.py", "resource/container.py",
          "resource/vm.py", "k8s/pod.py", "utils/atomicio.py",
          "ops/deltas.py", "monitor/snapshot.py", "monitor/watchdog.py",
          "fleet/spool.py", "fleet/agent.py", "cmd/train.py::load_windows",
          "chaos/trace.py", "chaos/invariants.py", "chaos/schedule.py",
          "blackbox/__init__.py")


@pytest.mark.parametrize("rel", COPIED)
def test_port_copy_defines_what_its_original_defines(rel):
    """A copied module's code (docstrings and comments aside) names the
    same functions and classes as its original; a copied function
    (``path::name``) is the same code, its docstring aside."""
    import ast
    import pathlib

    root = pathlib.Path(__file__).resolve().parent.parent
    rel, _, func = rel.partition("::")
    trees = [ast.parse((root / pkg / rel).read_text()) for pkg in PACKAGES]
    if func:
        bodies = []
        for tree in trees:
            fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
                      and n.name == func)
            bodies.append([ast.dump(s) for s in fn.body[1:]])
        assert bodies[1] == bodies[0]
        return
    defs = [sorted(n.name for n in ast.walk(tree)
                   if isinstance(n, (ast.FunctionDef, ast.ClassDef)))
            for tree in trees]
    assert defs[1] == defs[0]
