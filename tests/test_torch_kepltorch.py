"""The port's device tier (``kepler_tpu_torch.analysis.device``) on the CPU.

Every registered program runs once at its tiny shapes under the op
recorder on ``device="cpu"`` and passes KTL120-123 against the port's
committed snapshot. The registry mirrors the reference's kepljax
registry entry for entry (names, cases, dims and contracts). Each family
fires on a planted defect: a bf16 product with a bf16 result, an
undeclared f16 cast, a half reduction (KTL120); a declared donation that
copies or is not updated, an undeclared in-place update (KTL121); a
collective outside the allowlist, lost per-shard bodies (KTL122); a
drifted histogram, a missing or stale snapshot (KTL123). On the card,
``chip_smoke.py``'s ``main_analysis`` runs the same registry with
``device="cuda"`` and holds each fingerprint to the CPU's.
"""

from __future__ import annotations

import dataclasses
import os
import time

import pytest
import torch

from kepler_tpu.analysis.device import DEVICE_PROGRAMS as REF_PROGRAMS
from kepler_tpu_torch.analysis.__main__ import main as keplint_main
from kepler_tpu_torch.analysis.device import (
    DEVICE_PROGRAMS,
    ProgramCase,
    ProgramSpec,
    SNAPSHOT_NAME,
    analyze_device_programs,
    clear_trace_cache,
    load_snapshots,
    spec_by_name,
    trace_all,
    write_snapshots,
)
from kepler_tpu_torch.models.nn import acc_matmul
from kepler_tpu_torch.parallel import collectives

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
FIXTURE_SOURCE = "kepler_tpu_torch/parallel/packed.py"


@pytest.fixture(autouse=True)
def _fresh_runs():
    clear_trace_cache()
    yield
    clear_trace_cache()


def _spec(name, fn, args, **kw):
    return ProgramSpec(name=name, source=FIXTURE_SOURCE,
                       description="fixture",
                       build=lambda case, dev: (fn, args()),
                       cases=(ProgramCase("c"),), **kw)


def _run(spec, only, root=REPO):
    return analyze_device_programs(root, only=only, specs=(spec,),
                                   device="cpu")


def _ids(diags):
    return [d.rule_id for d in diags]


def _f32(*shape):
    gen = torch.Generator().manual_seed(sum(shape))
    return torch.randn(shape, generator=gen)


# ---------------------------------------------------------------------------
# the shipped registry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", DEVICE_PROGRAMS,
                         ids=[s.name for s in DEVICE_PROGRAMS])
def test_entry_runs_clean_against_the_committed_snapshot(spec):
    diags = analyze_device_programs(REPO, specs=(spec,), device="cpu")
    assert diags == [], "\n".join(d.render() for d in diags)


def test_registry_mirrors_the_reference_contracts():
    ref = {s.name: s for s in REF_PROGRAMS}
    assert [s.name for s in DEVICE_PROGRAMS] == list(ref)
    for spec in DEVICE_PROGRAMS:
        want = ref[spec.name]
        assert [(c.name, c.dims) for c in spec.cases] == [
            (c.name, c.dims) for c in want.cases]
        assert spec.donates == want.donates, spec.name
        assert spec.require_shard_map == want.require_shard_map
        # the port spells out the DP×TP step's gradient all-reduce,
        # which the reference leaves to GSPMD
        extra = {"psum"} if spec.name == "trainer.train_step" else set()
        assert spec.allowed_collectives == want.allowed_collectives | extra
        # the port's bf16 operand rounding casts back to f32 too
        assert spec.allowed_half_casts - {"bfloat16->float32"} == \
            want.allowed_half_casts - {"bfloat16->float32"}
        assert spec.source.startswith("kepler_tpu_torch/")
        assert os.path.exists(os.path.join(REPO, spec.source))


def test_committed_snapshots_match_registry_keys():
    snapshots = load_snapshots(REPO)
    assert snapshots is not None, f"commit {SNAPSHOT_NAME}"
    assert set(snapshots) == {f"{s.name}/{c.name}" for s in DEVICE_PROGRAMS
                              for c in s.cases}


def test_kernel_entries_record_one_op_per_kernel_call():
    """A kernel wrapper is one op whatever runs inside it: B2's plain
    version (a scatter, the attribution, the f16 pack) leaves nothing
    else in the histogram, so the card's launch reads the same."""
    reports, errors = trace_all((spec_by_name("window.fused_pallas"),
                                 spec_by_name("packed.pallas_dense")), "cpu")
    assert errors == []
    fused, dense = reports
    assert fused.op_counts == {"empty": 1, "kernel:fused_window_step": 1}
    assert fused.half_casts == {}
    assert fused.updated_args == fused.flat_indices_of_arg(1)
    assert dense.op_counts["kernel:outer_product_attribution"] == 8
    assert len(dense.shards) == 8


def test_device_tier_within_budget():
    """All 27 cases on the CPU, with room for the tier-1 run's parallel
    load (about 4 s alone on a CPU host)."""
    t0 = time.monotonic()
    diags = analyze_device_programs(REPO, device="cpu")
    elapsed = time.monotonic() - t0
    assert diags == []
    assert elapsed < 90.0, f"device tier took {elapsed:.1f}s (budget 90s)"


def test_cli_device_tier_on_the_cpu(capsys):
    assert keplint_main(["--device-tier", "--device", "cpu",
                         "--only=KTL120,KTL121,KTL122,KTL123",
                         os.path.join(REPO, "kepler_tpu_torch", "ops")]
                        ) == 0
    assert "clean" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# KTL120 dtype-flow
# ---------------------------------------------------------------------------


def test_bf16_product_with_bf16_result_fires():
    spec = _spec("fx.bad_product",
                 lambda x: x.to(torch.bfloat16) @ x.to(torch.bfloat16),
                 lambda: (_f32(8, 8),),
                 allowed_half_casts=frozenset({"float32->bfloat16"}))
    diags = _run(spec, {"KTL120"})
    assert _ids(diags) == ["KTL120"]
    assert "accumulates in half precision" in diags[0].message


def test_half_reduction_fires():
    spec = _spec("fx.bad_reduce",
                 lambda x: x.to(torch.float16).sum(),
                 lambda: (_f32(8),),
                 allowed_half_casts=frozenset({"float32->float16"}))
    diags = _run(spec, {"KTL120"})
    assert _ids(diags) == ["KTL120"]
    assert "reduction over half-precision operands" in diags[0].message


def test_undeclared_half_cast_fires():
    spec = _spec("fx.bad_cast",
                 lambda x: (x * 2).to(torch.float16).to(torch.float32),
                 lambda: (_f32(4),))
    diags = _run(spec, {"KTL120"})
    assert _ids(diags) == ["KTL120", "KTL120"]
    assert any("float32->float16" in d.message for d in diags)
    assert any("float16->float32" in d.message for d in diags)


def test_acc_matmul_pattern_is_clean():
    spec = _spec("fx.good_product",
                 lambda x: acc_matmul(x, x, torch.bfloat16),
                 lambda: (_f32(8, 8),),
                 allowed_half_casts=frozenset({"float32->bfloat16",
                                               "bfloat16->float32"}))
    assert _run(spec, {"KTL120"}) == []


# ---------------------------------------------------------------------------
# KTL121 donation-alias
# ---------------------------------------------------------------------------


def test_declared_donation_that_copies_fires():
    """The regression the port had: the resident batch rebuilt by a
    full-size `where` and copied back, every window."""
    def update(resident, rows, hit):
        return resident.copy_(torch.where(hit[:, None], rows, resident))

    spec = _spec("fx.copying_update", update,
                 lambda: (_f32(16, 12), _f32(16, 12),
                          torch.arange(16) % 3 == 0),
                 donates=(0,))
    diags = _run(spec, {"KTL121"})
    assert _ids(diags) == ["KTL121"]
    assert "copied, not updated in place" in diags[0].message


def test_declared_donation_not_updated_fires():
    real = spec_by_name("window.update")

    def build(case, dev):
        fn, args = real.build(case, dev)
        return (lambda resident, rows, idx:
                fn(resident.clone(), rows, idx)), args

    flipped = dataclasses.replace(real, build=build, cases=real.cases[:1])
    diags = _run(flipped, {"KTL121"})
    assert _ids(diags) == ["KTL121", "KTL121"]
    assert "not realized" in diags[0].message
    assert "clone" in diags[1].message


def test_undeclared_in_place_update_fires():
    spec = _spec("fx.secret_update", lambda r, v: r.add_(v),
                 lambda: (_f32(8, 4), _f32(8, 4)))
    diags = _run(spec, {"KTL121"})
    assert _ids(diags) == ["KTL121"]
    assert "undeclared donation" in diags[0].message


def test_declared_and_realized_is_clean():
    spec = _spec("fx.good_update",
                 lambda r, v: r.index_copy_(0, torch.tensor([0]), v[None]),
                 lambda: (_f32(8, 4), _f32(4)), donates=(0,))
    assert _run(spec, {"KTL121"}) == []


# ---------------------------------------------------------------------------
# KTL122 collective-discipline
# ---------------------------------------------------------------------------


def test_lost_per_shard_bodies_fire():
    """The replicated-index regression: the sparse program built without
    shard-local rows runs as one program, no per-shard body."""
    real = spec_by_name("packed.sparse_local_mlp")
    case = real.cases[0]
    regressed = dataclasses.replace(
        real, cases=(ProgramCase(case.name, dims={**case.dims, "local": 0,
                                                  "devices": 1}),))
    diags = _run(regressed, {"KTL122"})
    assert _ids(diags) == ["KTL122"]
    assert "lost its shard_map" in diags[0].message


def _psum_spec(name, **kw):
    def body(x):
        parts = list(x.chunk(8))
        return torch.stack(collectives.psum(parts, [CPU] * 8))

    return _spec(name, body, lambda: (_f32(8, 4),),
                 require_shard_map=True, **kw)


def test_collective_outside_the_allowlist_fires():
    diags = _run(_psum_spec("fx.rogue_psum"), {"KTL122"})
    assert _ids(diags) == ["KTL122"]
    assert "psum" in diags[0].message


def test_allowlisted_collective_is_clean():
    spec = _psum_spec("fx.ok_psum", allowed_collectives=frozenset({"psum"}))
    assert _run(spec, {"KTL122"}) == []


# ---------------------------------------------------------------------------
# KTL123 program-ratchet
# ---------------------------------------------------------------------------


def _matmul_spec(name="fx.ratchet", transpose=False):
    if transpose:
        return _spec(name, lambda x: (x @ x).t().contiguous(),
                     lambda: (_f32(8, 8),))
    return _spec(name, lambda x: x @ x, lambda: (_f32(8, 8),))


def test_snapshot_roundtrip_then_drift(tmp_path):
    root = str(tmp_path)
    spec = _matmul_spec()
    assert write_snapshots(root, specs=(spec,), device="cpu") == (1, [])
    assert analyze_device_programs(root, specs=(spec,), device="cpu") == []
    clear_trace_cache()
    diags = _run(_matmul_spec(transpose=True), {"KTL123"}, root)
    assert diags and all(d.rule_id == "KTL123" for d in diags)
    assert any("fingerprint drift in `ops`" in d.message for d in diags)


def test_missing_snapshot_file_fires(tmp_path):
    diags = _run(_matmul_spec(), {"KTL123"}, str(tmp_path))
    assert any("missing " + SNAPSHOT_NAME in d.message for d in diags)


def test_unsnapshotted_case_and_stale_entry_fire(tmp_path):
    root = str(tmp_path)
    two = dataclasses.replace(_matmul_spec(), cases=(ProgramCase("a"),
                                                     ProgramCase("b")))
    write_snapshots(root, specs=(two,), device="cpu")
    clear_trace_cache()
    renamed = dataclasses.replace(two, cases=(ProgramCase("a"),
                                              ProgramCase("new")))
    messages = " | ".join(d.message for d in _run(renamed, {"KTL123"}, root))
    assert "no golden snapshot" in messages
    assert "stale snapshot entry" in messages


def test_build_failure_reports_ktl000():
    def boom(case, dev):
        raise RuntimeError("no program")

    spec = dataclasses.replace(_matmul_spec(), build=boom)
    diags = _run(spec, None)
    assert _ids(diags)[:1] == ["KTL000"]
    assert "failed to build/run" in diags[0].message
