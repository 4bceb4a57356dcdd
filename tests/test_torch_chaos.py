"""kepchaos in the port against the reference: the same schedules, the
same verdicts, the same traces.

The port's ``kepler_tpu_torch.chaos`` keeps copies of the reference's
pure layers (schedule grammar, ``ddmin``, the invariants, the trace), so
every pure case of ``tests/test_chaos_conductor.py`` runs here over both
packages. The conductor cases (marked ``chaos``) drive the port's real
Aggregator replicas on ``device="cpu"``: bit-identical replay, a green
sweep, the kill-holder hand-off, and the shrinking proof with the port's
``_BUG_BROADCAST_SELF_ISSUER``.

Parity with the reference is held bit for bit: a schedule run through
``kepler_tpu.chaos`` and through the port gives the same canonical
trace (every published row's digest, rung transition, membership view,
counter and fault fire). The reference's own runs (``CHAOS_r01.json``,
and this process, whose conftest gives JAX eight CPU devices) shard
rung 0 over an 8-device mesh; the port's harness shards it over 8
virtual shards of its device (``ChaosConfig.shards``), so every trace
hash equals the file's. At ``shards=1`` the port equals the reference
pinned to one device.
"""

from __future__ import annotations

import importlib
import json
import pathlib
import subprocess
import sys
import types

import pytest

PACKAGES = ("kepler_tpu", "kepler_tpu_torch")
REPO = pathlib.Path(__file__).resolve().parent.parent
CHAOS_R01 = json.loads((REPO / "CHAOS_r01.json").read_text())
MEMBERS = [f"10.99.0.{i + 1}:28283" for i in range(3)]
STANDBYS = ["10.99.0.4:28283"]


def chaos_of(pkg: str) -> types.SimpleNamespace:
    mods = {name: importlib.import_module(f"{pkg}.chaos.{name}")
            for name in ("schedule", "invariants", "trace")}
    return types.SimpleNamespace(pkg=pkg, **mods)


@pytest.fixture(params=PACKAGES)
def chaos(request) -> types.SimpleNamespace:
    return chaos_of(request.param)


def gen(chaos, index: int, seed: int = 1):
    return chaos.schedule.generate(seed, index, horizon=12,
                                   members=MEMBERS, standbys=STANDBYS)


def port_cfg(**kw):
    from kepler_tpu_torch.chaos.harness import ChaosConfig

    return ChaosConfig(device="cpu", **kw)


def port_gen(index: int, seed: int = 1):
    return gen(chaos_of("kepler_tpu_torch"), index, seed)


# -- schedule grammar and ddmin (pure; both packages) ------------------------


class TestScheduleGrammar:
    def test_generate_is_pure(self, chaos):
        for index in (0, 7, 24):
            assert gen(chaos, index).to_json() == gen(chaos, index).to_json()

    def test_keys_diversify(self, chaos):
        texts = {gen(chaos, i).to_json() for i in range(10)}
        assert len(texts) >= 8

    def test_events_sorted_and_bounded(self, chaos):
        sch = chaos.schedule
        for index in range(20):
            sched = gen(chaos, index)
            assert len(sched.events) >= 3
            keys = [(e.at, e.kind, e.site, e.target)
                    for e in sched.events]
            assert keys == sorted(keys)
            ladder = [e for e in sched.events if e.site in sch.LADDER_SITES]
            assert len(ladder) <= sch.MAX_LADDER_EVENTS
            for e in ladder:
                assert e.count == 1 and e.probability == 1.0
            for e in sched.events:
                if e.kind == "fault":
                    assert e.site in sch.FAULT_POOL
                    assert 0 <= e.at < 12

    def test_json_round_trip(self, chaos):
        sched = gen(chaos, 3).subset([0, 2])
        again = chaos.schedule.Schedule.from_json(sched.to_json())
        assert again == sched
        assert again.keep == (0, 2)

    def test_validation_rejects_malformed(self, chaos):
        ChaosEvent = chaos.schedule.ChaosEvent
        with pytest.raises(ValueError, match="unknown fault site"):
            ChaosEvent(at=0, kind="fault", site="disk.not_a_site")
        with pytest.raises(ValueError, match="unknown event kind"):
            ChaosEvent(at=0, kind="explode")
        with pytest.raises(ValueError, match="window index"):
            ChaosEvent(at=-1, kind="kill", target=MEMBERS[0])
        with pytest.raises(ValueError, match="duration"):
            ChaosEvent(at=0, kind="fault", site="net.refuse", windows=0)
        with pytest.raises(ValueError, match="unknown keys"):
            ChaosEvent.from_dict({"at": 0, "kind": "kill", "when": 3})
        with pytest.raises(ValueError, match="out of range"):
            gen(chaos, 0).subset([99])

    def test_compile_fault_specs(self, chaos):
        ChaosEvent = chaos.schedule.ChaosEvent
        events = [
            ChaosEvent(at=2, kind="fault", site="net.refuse", windows=2),
            ChaosEvent(at=0, kind="kill", target=MEMBERS[0]),
        ]
        specs = chaos.schedule.compile_fault_specs(events, interval=5.0)
        assert len(specs) == 1          # op events don't lower
        assert specs[0].site == "net.refuse"
        assert specs[0].start == pytest.approx(12.5)
        assert specs[0].duration == pytest.approx(10.0)


def test_schedules_are_the_same_in_both_packages():
    """The key alone replays the schedule in either package."""
    ref, port = (chaos_of(pkg) for pkg in PACKAGES)
    for index in range(25):
        assert gen(port, index).to_json() == gen(ref, index).to_json()


def test_port_chaos_pool_partitions_the_port_catalog():
    """The port's counterpart of ``tests/test_fault_fence.py``'s pool
    partition: every site of ``kepler_tpu_torch.fault`` is either in
    the port's chaos pool or excluded with a reason."""
    from kepler_tpu_torch.chaos.schedule import EXCLUDED_SITES, FAULT_POOL
    from kepler_tpu_torch.fault import KNOWN_SITES

    pool, excluded = set(FAULT_POOL), set(EXCLUDED_SITES)
    assert not pool & excluded, sorted(pool & excluded)
    assert pool | excluded == set(KNOWN_SITES), (
        f"uncovered: {sorted(set(KNOWN_SITES) - pool - excluded)}; "
        f"unknown: {sorted((pool | excluded) - set(KNOWN_SITES))}")
    for site, reason in EXCLUDED_SITES.items():
        assert reason.strip(), f"{site}: exclusion needs a reason"


class TestDdmin:
    def test_single_culprit(self, chaos):
        assert chaos.schedule.ddmin(range(10), lambda keep: 5 in keep) == (5,)

    def test_pair_culprit(self, chaos):
        out = chaos.schedule.ddmin(range(12),
                                   lambda keep: {2, 6} <= set(keep))
        assert sorted(out) == [2, 6]

    def test_precondition(self, chaos):
        with pytest.raises(ValueError, match="full set must fail"):
            chaos.schedule.ddmin(range(4), lambda keep: False)


# -- the trace ---------------------------------------------------------------


def test_jsonable_turns_tensors_into_numbers():
    import numpy as np
    import torch

    from kepler_tpu_torch.chaos.trace import Trace, jsonable

    assert jsonable(torch.tensor(2.5)) == 2.5
    assert jsonable(torch.tensor(3, dtype=torch.int64)) == 3
    assert jsonable(torch.tensor([[1.0, 2.0]])) == [[1.0, 2.0]]
    assert jsonable(torch.tensor([7])) == [7]      # a list, as n-d
    assert jsonable({"a": (torch.tensor(1.5), np.float32(0.5))}) == {
        "a": [1.5, 0.5]}
    trace = Trace()
    trace.emit("x", v=torch.tensor([1.0, 2.0]), s=torch.tensor(4))
    assert trace.canonical() == '[{"kind":"x","s":4,"v":[1.0,2.0]}]'


@pytest.mark.parametrize("value", [
    3, 2.5, "s", None, True, [1, (2, 3)], {"k": {"j": [1.5]}}])
def test_jsonable_matches_the_reference(value):
    import numpy as np

    ref, port = (chaos_of(pkg).trace for pkg in PACKAGES)
    for v in (value, np.float32(1.25), np.int64(-2), np.array([4.0])):
        assert port.jsonable(v) == ref.jsonable(v)
    # a numpy array of more than one element stops at ``.item()`` in
    # both copies (the conductor coerces rows to floats before emitting)
    for mod in (ref, port):
        with pytest.raises(ValueError):
            mod.jsonable(np.arange(3))


# -- invariant teeth (pure; both packages) -----------------------------------

R1, R2 = MEMBERS[0], MEMBERS[1]


def clean_row(inv, node: str = "n0"):
    return inv.RowRecord(
        node=node, dt=5.0,
        energy_uj=(1e7, 5e6), power_uw=(2e6, 1e6),
        wl_power_sum_uw=(1e6, 5e5), wl_ids=("w0", "w1"),
        usage_ratio=0.5, emitted_energy_uj=(1e7, 5e6))


def clean_record(inv, **overrides):
    view = inv.MembershipView(epoch=2, peers=(R1, R2), holder=R1)
    base = dict(
        windows=[inv.WindowRecord(replica=R1, win=1,
                                  rows=[clean_row(inv)])],
        stats={f"{R1}#0": {"windows_lost_total": 0}},
        timelines={f"{R1}#0": [
            {"rung": 1, "rung_name": "jit", "from_rung": 0,
             "from_rung_name": "pipelined", "reason": "dispatch_error"},
            {"rung": 0, "rung_name": "pipelined", "from_rung": 1,
             "from_rung_name": "jit", "reason": "repromoted",
             "windows_at_prev_rung": 2},
        ]},
        repromote_after=1, abandoned_windows=0,
        membership={R1: view,
                    R2: inv.MembershipView(epoch=2, peers=(R1, R2),
                                           holder=R1)},
        alive=frozenset({R1, R2}),
        health_ok={R1: True, R2: True},
        window_health_ok={R1: True, R2: True},
        pending={"cn00": 0})
    base.update(overrides)
    return inv.RunRecord(**base)


def one_row(inv, row):
    return clean_record(inv, windows=[inv.WindowRecord(replica=R1, win=1,
                                                       rows=[row])])


class TestInvariantTeeth:
    def test_clean_record_passes(self, chaos):
        assert chaos.invariants.check_all(clean_record(chaos.invariants)) \
            == []

    def test_conservation_energy_vs_power(self, chaos):
        inv = chaos.invariants
        row = clean_row(inv)
        row.energy_uj = (1e7, 1e6)     # zone 1 off by 5x
        out = inv.check_conservation(one_row(inv, row))
        assert out and all(v.invariant == "conservation" for v in out)
        assert any("zone=1" in v.detail for v in out)

    def test_conservation_published_vs_emitted(self, chaos):
        inv = chaos.invariants
        row = clean_row(inv)
        row.emitted_energy_uj = (1e7, 9e6)   # agent never sent this
        out = inv.check_conservation(one_row(inv, row))
        assert any("!= emitted" in v.detail for v in out)

    def test_conservation_workload_plane(self, chaos):
        inv = chaos.invariants
        row = clean_row(inv)
        row.wl_power_sum_uw = (1e6, 1e4)     # plane lost zone 1
        out = inv.check_conservation(one_row(inv, row))
        assert any("workload plane" in v.detail for v in out)

    def test_conservation_arity(self, chaos):
        inv = chaos.invariants
        row = clean_row(inv)
        row.power_uw = (2e6,)
        out = inv.check_conservation(one_row(inv, row))
        assert any("arity" in v.detail for v in out)

    def test_fabricated_loss_fires(self, chaos):
        inv = chaos.invariants
        rec = clean_record(
            inv, stats={f"{R1}#0": {"windows_lost_total": 2},
                        f"{R2}#0": {"windows_lost_total": 1}})
        out = inv.check_no_fabricated_loss(rec)
        assert len(out) == 1 and out[0].invariant == "loss"
        assert "windows_lost_total=3" in out[0].detail
        rec.abandoned_windows = 3
        assert inv.check_no_fabricated_loss(rec) == []

    def test_duplicate_window_owner_fires(self, chaos):
        inv = chaos.invariants
        rec = clean_record(inv, windows=[
            inv.WindowRecord(replica=R1, win=4, rows=[clean_row(inv)]),
            inv.WindowRecord(replica=R2, win=4, rows=[clean_row(inv)])])
        out = inv.check_no_duplicates(rec)
        assert any("published by both" in v.detail for v in out)

    def test_duplicate_workload_id_fires(self, chaos):
        inv = chaos.invariants
        row = clean_row(inv)
        row.wl_ids = ("w0", "w0")
        out = inv.check_no_duplicates(one_row(inv, row))
        assert any("repeated workload id" in v.detail for v in out)

    def test_ladder_two_rung_demotion_fires(self, chaos):
        inv = chaos.invariants
        rec = clean_record(inv, timelines={f"{R1}#0": [
            {"rung": 2, "from_rung": 0, "reason": "compile_error"}]})
        assert any("exactly one rung" in v.detail
                   for v in inv.check_ladder(rec))

    def test_ladder_unknown_reason_fires(self, chaos):
        inv = chaos.invariants
        rec = clean_record(inv, timelines={f"{R1}#0": [
            {"rung": 1, "from_rung": 0, "reason": "cosmic_ray"}]})
        assert any("unknown transition reason" in v.detail
                   for v in inv.check_ladder(rec))

    def test_ladder_early_repromotion_fires(self, chaos):
        inv = chaos.invariants
        rec = clean_record(inv, timelines={f"{R1}#0": [
            {"rung": 0, "from_rung": 1, "reason": "repromoted",
             "windows_at_prev_rung": 0}]})
        rec.repromote_after = 1
        assert any("clean" in v.detail for v in inv.check_ladder(rec))

    def test_ladder_repromotion_skips_rung_fires(self, chaos):
        inv = chaos.invariants
        rec = clean_record(inv, timelines={f"{R1}#0": [
            {"rung": 0, "from_rung": 2, "reason": "repromoted",
             "windows_at_prev_rung": 5}]})
        assert any("climb exactly one" in v.detail
                   for v in inv.check_ladder(rec))

    def test_convergence_divergent_views_fire(self, chaos):
        inv = chaos.invariants
        rec = clean_record(inv)
        rec.membership[R2] = inv.MembershipView(
            epoch=3, peers=(R1, R2), holder=R1)
        assert any("views diverge" in v.detail
                   for v in inv.check_convergence(rec))

    def test_convergence_departed_holder_fires(self, chaos):
        inv = chaos.invariants
        gone = "10.99.0.9:28283"
        rec = clean_record(inv, membership={
            R1: inv.MembershipView(epoch=3, peers=(R1, R2), holder=gone),
            R2: inv.MembershipView(epoch=3, peers=(R1, R2), holder=gone)})
        assert any("not a ring member" in v.detail
                   for v in inv.check_convergence(rec))

    def test_convergence_dead_holder_fires(self, chaos):
        inv = chaos.invariants
        rec = clean_record(inv, alive=frozenset({R2}), membership={
            R2: inv.MembershipView(epoch=3, peers=(R1, R2), holder=R1)})
        assert any("is dead" in v.detail
                   for v in inv.check_convergence(rec))

    def test_convergence_red_probes_fire(self, chaos):
        inv = chaos.invariants
        rec = clean_record(inv, health_ok={R1: False, R2: True},
                           window_health_ok={R1: True, R2: False})
        out = inv.check_convergence(rec)
        assert any("health probe still red" in v.detail for v in out)
        assert any("window health still red" in v.detail for v in out)

    def test_convergence_backlog_fires(self, chaos):
        inv = chaos.invariants
        out = inv.check_convergence(clean_record(inv, pending={"cn00": 3}))
        assert any("undelivered" in v.detail for v in out)

    def test_convergence_no_members_fires(self, chaos):
        inv = chaos.invariants
        out = inv.check_convergence(clean_record(
            inv, membership={}, alive=frozenset()))
        assert any("no live member" in v.detail for v in out)


def jev(phys_us: int, logical: int, node: str, kind: str,
        **fields) -> dict:
    return {"hlc": {"phys_us": phys_us, "logical": logical,
                    "node": node},
            "kind": kind, "fields": fields}


class TestJournalInvariantTeeth:
    """Invariant 6 (journal vs schedule): every checker path fires on a
    hand-built lying journal and stays quiet on an honest one."""

    KILL = {"op": "kill", "peer": R2, "t_us": 1_000_000,
            "epoch_before": 2}

    def witness(self, phys_us: int = 1_000_000) -> dict:
        return jev(phys_us, 0, R1, "membership.apply",
                   epoch=3, peers=[R1], source="succession")

    def test_honest_journal_passes(self, chaos):
        inv = chaos.invariants
        rec = clean_record(
            inv, journals={f"{R1}#0": [jev(500_000, 0, R1, "lease.adopt",
                                           holder=R1, epoch=2),
                                       self.witness()]},
            schedule_ops=[dict(self.KILL)])
        assert inv.check_journal_vs_schedule(rec) == []
        assert inv.check_all(rec) == []

    def test_missing_witness_fires(self, chaos):
        inv = chaos.invariants
        rec = clean_record(
            inv, journals={f"{R1}#0": [jev(1_000_000, 0, R1,
                                           "membership.apply", epoch=3,
                                           peers=[R1, R2])]},
            schedule_ops=[dict(self.KILL)])
        assert any("no witnessing event" in v.detail
                   for v in inv.check_journal_vs_schedule(rec))

    def test_epoch_not_advanced_is_no_witness(self, chaos):
        inv = chaos.invariants
        rec = clean_record(
            inv, journals={f"{R1}#0": [jev(1_000_000, 0, R1,
                                           "membership.apply", epoch=2,
                                           peers=[R1])]},
            schedule_ops=[dict(self.KILL)])
        assert any("no witnessing event" in v.detail
                   for v in inv.check_journal_vs_schedule(rec))

    def test_empty_journal_with_ops_fires(self, chaos):
        inv = chaos.invariants
        out = inv.check_journal_vs_schedule(clean_record(
            inv, journals={}, schedule_ops=[dict(self.KILL)]))
        assert any("merged journal is empty" in v.detail for v in out)

    def test_non_monotonic_hlc_fires(self, chaos):
        inv = chaos.invariants
        rec = clean_record(
            inv, journals={f"{R1}#0": [self.witness(2_000_000),
                                       jev(1_500_000, 0, R1, "lease.adopt",
                                           holder=R1, epoch=3)]},
            schedule_ops=[])
        assert any("strictly HLC-increasing" in v.detail
                   for v in inv.check_journal_vs_schedule(rec))
        rec = clean_record(
            inv, journals={f"{R1}#0": [self.witness(), self.witness()]})
        assert any("strictly HLC-increasing" in v.detail
                   for v in inv.check_journal_vs_schedule(rec))

    def test_witness_predating_its_cause_fires(self, chaos):
        inv = chaos.invariants
        rec = clean_record(
            inv, journals={f"{R1}#0": [self.witness(900_000)]},
            schedule_ops=[dict(self.KILL)])
        assert any("before the op's virtual time" in v.detail
                   for v in inv.check_journal_vs_schedule(rec))

    def test_autoscale_evidence_requires_epoch_bump(self, chaos):
        inv = chaos.invariants
        op = {"op": "autoscale", "peer": "", "t_us": 1_000_000,
              "epoch_before": 2}
        stale = clean_record(
            inv, journals={f"{R1}#0": [jev(1_000_000, 0, R1,
                                           "autoscale.enact", epoch=2,
                                           direction="up")]},
            schedule_ops=[dict(op)])
        assert any("no witnessing event" in v.detail
                   for v in inv.check_journal_vs_schedule(stale))
        good = clean_record(
            inv, journals={f"{R1}#0": [jev(1_000_000, 0, R1,
                                           "autoscale.enact", epoch=3,
                                           direction="up")]},
            schedule_ops=[dict(op)])
        assert inv.check_journal_vs_schedule(good) == []

    def test_restart_witnessed_by_inclusive_apply(self, chaos):
        inv = chaos.invariants
        op = {"op": "restart", "peer": R2, "t_us": 1_000_000,
              "epoch_before": 3}
        rec = clean_record(
            inv, journals={f"{R2}#1": [jev(1_000_000, 1, R2,
                                           "membership.apply", epoch=4,
                                           peers=[R1, R2],
                                           source="join")]},
            schedule_ops=[dict(op)])
        assert inv.check_journal_vs_schedule(rec) == []


# -- conductor runs (the port's fleet on the CPU, virtual clock) -------------


@pytest.mark.chaos
class TestConductor:
    def test_replay_is_bit_identical(self):
        from kepler_tpu_torch.chaos.conductor import run_schedule

        sched = port_gen(0)
        first = run_schedule(sched, port_cfg())
        second = run_schedule(sched, port_cfg())
        assert first.ok, [str(v) for v in first.violations]
        assert first.trace_hash == second.trace_hash
        assert first.trace.canonical() == second.trace.canonical()
        assert first.windows_published == second.windows_published > 0

    def test_small_sweep_green_and_artifact_shape(self):
        from kepler_tpu_torch.chaos.conductor import run_many

        report = run_many(1, 3, port_cfg())
        assert report.ok
        art = report.to_artifact()
        assert art["schedules_run"] == 3
        assert art["verdicts"] == {"green": 3, "red": 0}
        assert art["windows_published"] > 0
        assert isinstance(art["fault_fires"], dict)
        assert len(art["trace_hashes"]) == 3
        json.dumps(art)     # artifact must be plain JSON

    def test_kill_holder_handoff_stays_green(self):
        from kepler_tpu_torch.chaos.conductor import run_schedule
        from kepler_tpu_torch.chaos.schedule import ChaosEvent, Schedule

        sched = Schedule(seed=0, index=0, events=(
            ChaosEvent(at=1, kind="kill", target=MEMBERS[0]),
            ChaosEvent(at=4, kind="restart", target=MEMBERS[0]),
        ))
        result = run_schedule(sched, port_cfg())
        assert result.ok, [str(v) for v in result.violations]
        views = {(v.epoch, tuple(sorted(v.peers)), v.holder)
                 for v in result.record.membership.values()}
        assert len(views) == 1
        # the kill was certain and its succession apply is journaled
        assert [op["op"] for op in result.record.schedule_ops] == [
            "kill", "restart"]

    def test_repro_command(self):
        from kepler_tpu_torch.chaos.conductor import repro_command

        sched = port_gen(24)
        assert repro_command(sched) == (
            "python -m kepler_tpu_torch.chaos --seed 1 --schedule 24")
        shrunk = sched.subset([0, 3])
        assert repro_command(shrunk) == (
            "python -m kepler_tpu_torch.chaos --seed 1 --schedule 24 "
            "--keep 0,3")
        assert repro_command(shrunk, "cpu") == (
            "python -m kepler_tpu_torch.chaos --seed 1 --schedule 24 "
            "--keep 0,3 --device cpu")

    def test_backend_pallas_runs_the_same_schedule(self):
        """``backend="pallas"`` on the CPU takes the kernels' plain
        versions: the same windows, fires and trace as einsum."""
        from kepler_tpu_torch.chaos.conductor import run_schedule

        sched = port_gen(1)       # a compile_error and a re-promotion
        einsum = run_schedule(sched, port_cfg())
        pallas = run_schedule(sched, port_cfg(backend="pallas"))
        assert pallas.ok, [str(v) for v in pallas.violations]
        assert pallas.fault_fires == einsum.fault_fires
        assert pallas.trace.canonical() == einsum.trace.canonical()


@pytest.mark.chaos
class TestShrinkingProof:
    """The reintroduced broadcast-issuer bug (the port's test-only flag)
    is caught by a randomized schedule and shrunk to a minimal repro;
    the same schedule is green with the flag off."""

    def test_randomized_schedule_catches_and_shrinks(self, monkeypatch):
        from kepler_tpu_torch.chaos.conductor import run_schedule, shrink
        from kepler_tpu_torch.fleet import aggregator

        sched = port_gen(24)
        assert any(e.kind == "leave" and e.target == MEMBERS[0]
                   for e in sched.events)

        monkeypatch.setattr(
            aggregator, "_BUG_BROADCAST_SELF_ISSUER", True)
        broken = run_schedule(sched, port_cfg())
        assert not broken.ok
        assert any(v.invariant == "convergence"
                   and "not a ring member" in v.detail
                   for v in broken.violations), (
            [str(v) for v in broken.violations])

        shrunk, runs = shrink(sched, port_cfg())
        assert 1 <= len(shrunk.events) <= 5
        assert runs >= 1
        assert any(e.kind == "leave" and e.target == MEMBERS[0]
                   for e in shrunk.events)
        assert not run_schedule(shrunk, port_cfg()).ok

        monkeypatch.setattr(
            aggregator, "_BUG_BROADCAST_SELF_ISSUER", False)
        fixed = run_schedule(sched, port_cfg())
        assert fixed.ok, [str(v) for v in fixed.violations]


# -- parity with the reference -------------------------------------------------


def run_both(index: int):
    from kepler_tpu.chaos.conductor import run_schedule as jax_run
    from kepler_tpu_torch.chaos.conductor import run_schedule as port_run

    ref = jax_run(gen(chaos_of("kepler_tpu"), index))
    return ref, port_run(port_gen(index), port_cfg())


@pytest.fixture
def jax_one_device(monkeypatch):
    """The reference's Aggregators on a one-device mesh (as the port's
    Aggregator tests pin it), so its rung 0 is ``packed-pipelined``."""
    import jax

    from kepler_tpu.fleet import aggregator
    from kepler_tpu.parallel import mesh

    def one_device(shape=(), axes=(mesh.NODE_AXIS,), devices=None):
        return mesh.make_mesh(shape, axes, devices=(
            jax.devices()[:1] if devices is None else devices))

    monkeypatch.setattr(aggregator, "make_mesh", one_device)


@pytest.mark.chaos
@pytest.mark.parametrize("index", [0, 1, 2, 24])
def test_trace_equals_the_reference(index):
    """The same key through both packages, both sharded 8 ways: the same
    canonical trace, byte for byte (rung 0 named
    ``packed-sharded-pipelined`` on both sides), and the file's hash."""
    ref, port = run_both(index)
    assert ref.trace_hash == CHAOS_R01["trace_hashes"][str(index)]
    assert port.ok and ref.ok
    assert port.trace.canonical() == ref.trace.canonical()
    assert port.trace_hash == CHAOS_R01["trace_hashes"][str(index)]
    assert port.fault_fires == ref.fault_fires
    assert port.windows_published == ref.windows_published


@pytest.mark.chaos
@pytest.mark.parametrize("index", [0, 1, 2, 24])
def test_trace_equals_the_reference_on_one_device(index, jax_one_device):
    """Pinned to one device, the reference's trace is the port's at one
    shard (``shards=1``), byte for byte, rung names included."""
    from kepler_tpu.chaos.conductor import run_schedule as jax_run
    from kepler_tpu_torch.chaos.conductor import run_schedule as port_run

    ref = jax_run(gen(chaos_of("kepler_tpu"), index))
    port = port_run(port_gen(index), port_cfg(shards=1))
    assert port.trace.canonical() == ref.trace.canonical()
    assert port.trace_hash == ref.trace_hash


@pytest.mark.chaos
def test_full_sweep_matches_the_artifact():
    """The reference's 25-schedule sweep at seed 1 (the CLI's default
    config, 8 shards): every count of ``CHAOS_r01.json`` and all 25
    trace hashes — the 13 schedules with rung transitions included,
    whose rung 0 reads ``packed-sharded-pipelined`` on both sides."""
    from kepler_tpu_torch.chaos.conductor import run_many

    report = run_many(1, 25, port_cfg(), do_shrink=False)
    art = report.to_artifact()
    for key in ("schedules_run", "events_total", "windows_published",
                "fault_fires", "verdicts"):
        assert art[key] == CHAOS_R01[key], key
    laddered = {str(r.schedule.index) for r in report.results
                if any(r.record.timelines.values())}
    assert len(laddered) == 13
    assert art["trace_hashes"] == CHAOS_R01["trace_hashes"]


# -- host-death succession against the reference ------------------------------


class _Req:
    command = "POST"

    def __init__(self, body: bytes) -> None:
        self.body = body


def succession_fleet(pkg: str, takeover: bool) -> dict:
    """Three replicas of ``pkg``'s Aggregator over injected seams; kill
    the lease holder and let every survivor run ``_demote_mesh`` (what
    the chaos harness's succession tick does) → each survivor's view."""
    agg_mod = importlib.import_module(f"{pkg}.fleet.aggregator")
    server_mod = importlib.import_module(f"{pkg}.server.http")
    alive = set(MEMBERS)
    aggs: dict = {}

    def deliver(target: str, payload: dict) -> dict:
        if target not in alive:
            raise OSError(f"connection refused: {target}")
        _, _, body = aggs[target]._handle_membership(
            _Req(json.dumps(payload).encode()))
        return json.loads(body)

    extra: dict = {"device": "cpu"}
    if pkg == "kepler_tpu":
        import jax

        from kepler_tpu.parallel.mesh import make_mesh

        extra = {"mesh": make_mesh(devices=jax.devices()[:1])}
    for peer in MEMBERS:
        aggs[peer] = agg_mod.Aggregator(
            server_mod.APIServer(), peers=MEMBERS, self_peer=peer,
            model_mode=None, clock=lambda: 1e9,
            multihost_takeover=takeover, membership_auto_apply=True,
            membership_topology={"peer_alive": lambda p: p in alive,
                                 "deliver": deliver}, **extra)
        aggs[peer].init()
    holder = aggs[MEMBERS[0]]._lease.holder
    alive.discard(holder)
    aggs.pop(holder).shutdown()
    for peer in sorted(aggs):
        aggs[peer]._demote_mesh("host_dead")
    out = {}
    for peer, agg in sorted(aggs.items()):
        out[peer] = {"epoch": int(agg._ring.epoch),
                     "peers": list(agg._ring.peers),
                     "holder": agg._lease.holder,
                     "awaiting": agg._awaiting_membership,
                     "applied": dict(agg._membership_applied),
                     "engine_dropped": agg._engine is None}
        agg.shutdown()
    return {"holder": holder, "views": out}


@pytest.mark.chaos
def test_holder_death_succession_matches_the_reference():
    ref, port = (succession_fleet(pkg, True) for pkg in PACKAGES)
    assert port == ref
    assert port["holder"] == MEMBERS[0]
    survivors = MEMBERS[1:]
    for view in port["views"].values():
        # one epoch bump, issued by the lowest survivor, adopted by all
        assert view["epoch"] == 2 and view["peers"] == survivors
        assert view["holder"] == survivors[0]
        assert view["awaiting"] is False and view["engine_dropped"]
    assert port["views"][survivors[0]]["applied"] == {"succession": 1}


@pytest.mark.chaos
def test_holder_death_without_takeover_awaits_membership():
    ref, port = (succession_fleet(pkg, False) for pkg in PACKAGES)
    assert port == ref
    for view in port["views"].values():
        assert view["awaiting"] is True
        assert view["epoch"] == 1 and view["peers"] == MEMBERS


# -- the binary ----------------------------------------------------------------


@pytest.mark.chaos
def test_cli_sweep_on_the_cpu(tmp_path, capsys):
    from kepler_tpu_torch.chaos.__main__ import main

    out = tmp_path / "chaos.json"
    assert main(["--seed", "1", "--schedules", "3", "--device", "cpu",
                 "--artifact", str(out)]) == 0
    text = capsys.readouterr().out
    assert "all 3 schedules green (seed=1)" in text
    assert "trace 3a0c357a576afb0f" in text
    art = json.loads(out.read_text())
    for i in ("0", "2"):
        assert art["trace_hashes"][i] == CHAOS_R01["trace_hashes"][i]


def test_package_import_loads_no_torch():
    """``python -m kepler_tpu_torch.chaos`` parses its arguments before
    the fleet (and torch) is imported: the package resolves lazily."""
    probe = ("import sys, kepler_tpu_torch.chaos as c; "
             "assert 'torch' not in sys.modules; "
             "c.ChaosConfig; assert 'torch' in sys.modules")
    proc = subprocess.run([sys.executable, "-c", probe], cwd=str(REPO),
                          capture_output=True, text=True, timeout=120,
                          check=False)
    assert proc.returncode == 0, proc.stderr[-2000:]
