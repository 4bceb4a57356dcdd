"""The port's black-box reader against the reference's.

``kepler_tpu_torch.blackbox`` is a copy of ``kepler_tpu.blackbox`` over
the port's journal module, so every case of ``tests/test_blackbox.py``
runs here over both packages: merge, findings, renders, the CLI's
determinism. One case crosses them: the journals of one chaos schedule,
run once by each package, give the same timeline SHA-256 from either
reader, and each reader gives that SHA over the other's journals.
"""

from __future__ import annotations

import importlib
import json
import types

import pytest

PACKAGES = ("kepler_tpu", "kepler_tpu_torch")


def reader(pkg: str) -> types.SimpleNamespace:
    mod = importlib.import_module(f"{pkg}.blackbox")
    return types.SimpleNamespace(
        pkg=pkg, mod=mod,
        main=importlib.import_module(f"{pkg}.blackbox.__main__").main,
        EventJournal=importlib.import_module(
            f"{pkg}.fleet.journal").EventJournal)


@pytest.fixture(params=PACKAGES)
def bb(request) -> types.SimpleNamespace:
    return reader(request.param)


def ev(phys_us, logical, node, kind, **fields):
    return {"hlc": {"phys_us": phys_us, "logical": logical,
                    "node": node},
            "kind": kind, "fields": fields}


class TestMerge:
    def test_orders_across_journals_by_hlc(self, bb):
        a = [ev(3_000_000, 0, "r1", "rung.transition", rung=1),
             ev(1_000_000, 0, "r1", "lease.adopt", holder="r1")]
        b = [ev(2_000_000, 0, "r2", "membership.apply", epoch=2)]
        merged = bb.mod.merge_events([a, b])
        assert [e["kind"] for e in merged] == [
            "lease.adopt", "membership.apply", "rung.transition"]

    def test_ties_break_on_logical_then_node(self, bb):
        merged = bb.mod.merge_events([[ev(1, 1, "a", "breaker.open"),
                                       ev(1, 0, "b", "breaker.close"),
                                       ev(1, 0, "a", "lease.adopt")]])
        assert [(e["hlc"]["logical"], e["hlc"]["node"])
                for e in merged] == [(0, "a"), (0, "b"), (1, "a")]

    def test_dedupes_same_event_from_two_sources(self, bb):
        e = ev(1_000_000, 0, "r1", "lease.adopt", holder="r1")
        assert len(bb.mod.merge_events([[e], [dict(e)]])) == 1

    def test_skips_stampless_garbage(self, bb):
        merged = bb.mod.merge_events([[{"kind": "x"}, "nope",
                                       ev(1, 0, "r1", "lease.adopt")]])
        assert len(merged) == 1


class TestLoadSource:
    def test_bare_list_bundle_journal_and_kepj(self, bb, tmp_path):
        events = [ev(1_000_000, 0, "r1", "lease.adopt", holder="r1")]
        bare = tmp_path / "bare.json"
        bare.write_text(json.dumps(events))
        bundle = tmp_path / "bundle.json"
        bundle.write_text(json.dumps({"schema": "kepler-bundle/v1",
                                      "journal": events}))
        dump = tmp_path / "journal.json"
        dump.write_text(json.dumps({"node": "r1", "events": events}))
        jnl = bb.EventJournal(enabled=True, node="r1", dir=str(tmp_path),
                              clock=lambda: 1.0)
        jnl.emit("lease.adopt", holder="r1")
        jnl.close()
        kepj = next(tmp_path.glob("*.kepj"))
        for path in (bare, bundle, dump, kepj):
            [journal] = bb.mod.load_source(str(path))
            assert journal[0]["kind"] == "lease.adopt", path

    def test_unrecognized_shape_raises(self, bb, tmp_path):
        bad = tmp_path / "bad.json"
        bad.write_text('{"what": "ever"}')
        with pytest.raises(ValueError, match="not a bundle"):
            bb.mod.load_source(str(bad))


class TestAnalyze:
    def test_clean_timeline_has_no_findings(self, bb):
        merged = [ev(1_000_000, 0, "r1", "lease.adopt",
                     holder="r1", epoch=2),
                  ev(2_000_000, 0, "r2", "lease.adopt",
                     holder="r1", epoch=2),
                  ev(3_000_000, 0, "r1", "membership.apply",
                     epoch=3, peers=["r1", "r2"]),
                  ev(4_000_000, 0, "r2", "membership.apply",
                     epoch=3, peers=["r2", "r1"])]    # order-insensitive
        assert bb.mod.analyze(merged) == []

    def test_split_brain_lease(self, bb):
        merged = [ev(1_000_000, 0, "r1", "lease.adopt",
                     holder="r1", epoch=5),
                  ev(1_500_000, 0, "r2", "lease.adopt",
                     holder="r2", epoch=5)]
        [finding] = bb.mod.analyze(merged)
        assert finding["finding"] == "split_brain_lease"
        assert finding["epoch"] == 5
        assert finding["holders"] == {"r1": "r1", "r2": "r2"}

    def test_split_brain_membership(self, bb):
        merged = [ev(1_000_000, 0, "r1", "membership.apply",
                     epoch=4, peers=["r1"]),
                  ev(1_100_000, 0, "r2", "membership.apply",
                     epoch=4, peers=["r1", "r2"])]
        [finding] = bb.mod.analyze(merged)
        assert finding["finding"] == "split_brain_membership"

    def test_breaker_flap_inside_window(self, bb):
        merged = [ev(i * 1_000_000, 0, "agent-1",
                     "breaker.open" if i % 2 else "breaker.close")
                  for i in range(4)]
        [finding] = bb.mod.analyze(merged)
        assert finding["finding"] == "breaker_flap"
        assert finding["node"] == "agent-1"

    def test_slow_breaker_cycle_is_not_a_flap(self, bb):
        merged = [ev(i * 200_000_000, 0, "agent-1",
                     "breaker.open" if i % 2 else "breaker.close")
                  for i in range(6)]
        assert bb.mod.analyze(merged) == []

    def test_rung_flap(self, bb):
        merged = [ev(i * 2_000_000, 0, "r1", "rung.transition",
                     rung=i % 2) for i in range(5)]
        assert [f["finding"] for f in bb.mod.analyze(merged)] == [
            "rung_flap"]


class TestRenders:
    MERGED = [ev(10_000_000, 0, "r1", "lease.adopt",
                 holder="r1", epoch=2),
              ev(11_000_000, 1, "r2", "membership.apply",
                 epoch=3, peers=["r1"])]

    def test_text_render(self, bb):
        text = bb.mod.render_text(self.MERGED, bb.mod.analyze(self.MERGED))
        lines = text.splitlines()
        assert "[r1] lease.adopt epoch=2 holder=r1" in lines[0]
        assert lines[0].startswith("+     0.000s")
        assert lines[1].startswith("+     1.000s")
        assert "-- 2 events, 0 findings" in text

    def test_text_render_lists_findings(self, bb):
        merged = [ev(1_000_000, 0, "r1", "lease.adopt",
                     holder="r1", epoch=5),
                  ev(1_500_000, 0, "r2", "lease.adopt",
                     holder="r2", epoch=5)]
        text = bb.mod.render_text(merged, bb.mod.analyze(merged))
        assert "!! split_brain_lease" in text

    def test_chrome_trace_shape(self, bb):
        doc = bb.mod.chrome_trace(self.MERGED)
        events = doc["traceEvents"]
        meta = [e for e in events if e["ph"] == "M"]
        inst = [e for e in events if e["ph"] == "i"]
        assert {m["args"]["name"] for m in meta} == {"r1", "r2"}
        assert all(e["s"] == "p" for e in inst)
        assert [e["ts"] for e in inst] == [10_000_000, 11_000_000]
        assert len({m["pid"] for m in meta}) == 2

    def test_sha_is_deterministic_and_sensitive(self, bb):
        sha = bb.mod.timeline_sha256
        findings = bb.mod.analyze(self.MERGED)
        assert (sha(self.MERGED, findings)
                == sha(list(self.MERGED), list(findings)))
        mutated = [dict(self.MERGED[0], kind="breaker.open"),
                   self.MERGED[1]]
        assert sha(mutated, findings) != sha(self.MERGED, findings)


class TestCli:
    def write_sources(self, tmp_path):
        a = tmp_path / "r1.json"
        a.write_text(json.dumps({"events": [
            ev(2_000_000, 0, "r1", "membership.apply",
               epoch=3, peers=["r1"]),
            ev(1_000_000, 0, "r1", "lease.adopt",
               holder="r1", epoch=2)]}))
        b = tmp_path / "r2.json"
        b.write_text(json.dumps({"journal": [
            ev(1_500_000, 0, "r2", "rung.transition", rung=1)]}))
        return a, b

    def test_text_output_is_merged_timeline(self, bb, tmp_path, capsys):
        a, b = self.write_sources(tmp_path)
        assert bb.main([str(a), str(b)]) == 0
        out = capsys.readouterr().out
        kinds = [line.split("] ")[1].split()[0]
                 for line in out.splitlines() if line.startswith("+")]
        assert kinds == ["lease.adopt", "rung.transition",
                         "membership.apply"]

    def test_json_output_is_canonical(self, bb, tmp_path, capsys):
        a, b = self.write_sources(tmp_path)
        assert bb.main([str(a), str(b), "--format", "json"]) == 0
        doc = json.loads(capsys.readouterr().out)
        assert doc["schema"] == bb.mod.SCHEMA
        assert len(doc["events"]) == 3
        assert doc["findings"] == []

    def test_sha_is_source_order_invariant(self, bb, tmp_path, capsys):
        a, b = self.write_sources(tmp_path)
        assert bb.main([str(a), str(b), "--sha"]) == 0
        first = capsys.readouterr().out.strip()
        assert bb.main([str(b), str(a), "--sha"]) == 0
        assert capsys.readouterr().out.strip() == first
        assert len(first) == 64

    def test_trace_output_loads_as_json(self, bb, tmp_path, capsys):
        a, b = self.write_sources(tmp_path)
        assert bb.main([str(a), "--format", "trace"]) == 0
        doc = json.loads(capsys.readouterr().out)
        assert doc["displayTimeUnit"] == "ms"
        assert any(e["ph"] == "i" for e in doc["traceEvents"])

    def test_bad_source_is_error_not_traceback(self, bb, tmp_path, capsys):
        bad = tmp_path / "bad.json"
        bad.write_text('{"nope": 1}')
        assert bb.main([str(bad)]) == 1
        assert "error:" in capsys.readouterr().err


def test_cli_outputs_are_the_same_in_both_packages(tmp_path, capsys):
    """Every output format of the two readers, byte for byte."""
    a, b = TestCli().write_sources(tmp_path)
    for fmt in (["--sha"], ["--format", "json"], ["--format", "text"],
                ["--format", "trace"]):
        outs = []
        for pkg in PACKAGES:
            assert reader(pkg).main([str(a), str(b), *fmt]) == 0
            outs.append(capsys.readouterr().out)
        assert outs[1] == outs[0], fmt


@pytest.mark.chaos
def test_chaos_journals_give_the_same_timeline_in_both_packages():
    """Schedule 0 of seed 1 (a leave and a re-join of the lease holder),
    run once by each package: each reader gives the same timeline
    SHA-256 over its own package's journals, and the same over the
    other's."""
    from kepler_tpu.chaos.conductor import run_schedule as jax_run
    from kepler_tpu.chaos.schedule import generate as jax_generate
    from kepler_tpu_torch.chaos.conductor import run_schedule as port_run
    from kepler_tpu_torch.chaos.harness import ChaosConfig
    from kepler_tpu_torch.chaos.schedule import generate as port_generate

    members = [f"10.99.0.{i + 1}:28283" for i in range(3)]
    key = dict(horizon=12, members=members, standbys=["10.99.0.4:28283"])
    journals = {
        "kepler_tpu": jax_run(jax_generate(1, 0, **key)).record.journals,
        "kepler_tpu_torch": port_run(port_generate(1, 0, **key),
                                     ChaosConfig(device="cpu")
                                     ).record.journals}
    assert journals["kepler_tpu_torch"] == journals["kepler_tpu"]
    shas = {}
    for pkg in PACKAGES:
        mod = reader(pkg).mod
        for src, jnl in journals.items():
            merged = mod.merge_events(jnl[inc] for inc in sorted(jnl))
            assert any(e["kind"] == "membership.apply" for e in merged)
            shas[(pkg, src)] = mod.timeline_sha256(merged,
                                                   mod.analyze(merged))
    assert len(set(shas.values())) == 1, shas
