"""The port's wire frames are byte-identical to the JAX package's.

``kepler_tpu_torch.fleet.wire`` is a copy of ``kepler_tpu.fleet.wire``
with only its imports changed: v1 and v2 keyframes, v2 delta frames and
batch frames must come out byte for byte the same from the same report,
and each package must decode the frames the other wrote.
"""

from __future__ import annotations

import numpy as np
import pytest

from kepler_tpu.fleet import wire as jw
from kepler_tpu.parallel.fleet import NodeReport as JaxReport
from kepler_tpu_torch.fleet import wire as tw
from kepler_tpu_torch.parallel.fleet import NodeReport

ZONES = ["package", "core", "dram", "uncore"]


def report_fields(seed: int, w: int = 7) -> dict:
    rng = np.random.default_rng(seed)
    cpu = rng.uniform(0.1, 5.0, w).astype(np.float32)
    return dict(
        node_name=f"node-{seed}",
        zone_deltas_uj=rng.uniform(1e7, 5e8, 4).astype(np.float32),
        zone_valid=np.array([True, True, False, True]),
        usage_ratio=float(rng.uniform(0.2, 0.9)),
        cpu_deltas=cpu,
        workload_ids=[f"pod-{seed}-{k}" for k in range(w)],
        node_cpu_delta=float(cpu.sum()),
        dt_s=5.0,
        mode=seed % 2,
        workload_kinds=np.ones(w, np.int8),
        meta={"arch": "x86"},
    )


def both(seed: int, **kw) -> tuple[JaxReport, NodeReport]:
    f = report_fields(seed, **kw)
    return JaxReport(**f), NodeReport(**f)


def assert_reports_equal(a, b) -> None:
    for field in ("node_name", "usage_ratio", "node_cpu_delta", "dt_s",
                  "mode", "workload_ids", "meta"):
        assert getattr(a, field) == getattr(b, field), field
    for field in ("zone_deltas_uj", "zone_valid", "cpu_deltas",
                  "workload_kinds"):
        np.testing.assert_array_equal(np.asarray(getattr(a, field)),
                                      np.asarray(getattr(b, field)))


@pytest.mark.parametrize("encode", ["encode_report", "encode_report_v2"])
def test_keyframes_byte_identical_and_cross_decode(encode):
    j, t = both(3)
    kw = dict(seq=5, run="r1", sent_at=12.5, trace_id="t-1",
              emitted_at=11.0)
    a = getattr(jw, encode)(j, ZONES, **kw)
    b = getattr(tw, encode)(t, ZONES, **kw)
    assert a == b
    rep_t, hdr_t = tw.decode_report(a)
    rep_j, hdr_j = jw.decode_report(b)
    assert isinstance(rep_t, NodeReport) and isinstance(rep_j, JaxReport)
    assert_reports_equal(rep_t, t)
    assert_reports_equal(rep_j, j)
    assert hdr_t["seq"] == hdr_j["seq"] == 5


@pytest.mark.parametrize("change", ["rows", "zones", "same"])
def test_delta_frames_byte_identical_and_cross_decode(change):
    f0 = report_fields(8)
    f1 = dict(f0)
    if change == "rows":
        cpu = f0["cpu_deltas"].copy()
        cpu[[1, 4]] += 1.0
        f1["cpu_deltas"] = cpu
        f1["node_cpu_delta"] = float(cpu.sum())
    elif change == "zones":
        f1["zone_deltas_uj"] = f0["zone_deltas_uj"] * 2
    base_j = jw.encode_report_v2(JaxReport(**f0), ZONES, seq=1, run="r")
    full_j = jw.encode_report_v2(JaxReport(**f1), ZONES, seq=2, run="r")
    base_t = tw.encode_report_v2(NodeReport(**f0), ZONES, seq=1, run="r")
    full_t = tw.encode_report_v2(NodeReport(**f1), ZONES, seq=2, run="r")
    assert (base_j, full_j) == (base_t, full_t)
    delta_j = jw.encode_delta_v2(full_j, base_j)
    delta_t = tw.encode_delta_v2(full_t, base_t)
    assert delta_j is not None and delta_j == delta_t
    parsed = tw.parse_header(delta_j)
    assert parsed.same == (change == "same")
    base_rep, _ = tw.decode_report(base_j)
    merged, _, changed = tw.decode_delta(delta_j, parsed, base_rep,
                                         tuple(ZONES))
    assert changed == (change != "same")
    assert_reports_equal(merged, NodeReport(**f1))
    jbase, _ = jw.decode_report(base_t)
    jmerged, _, _ = jw.decode_delta(delta_t, jw.parse_header(delta_t),
                                    jbase, tuple(ZONES))
    assert_reports_equal(jmerged, JaxReport(**f1))


def test_batch_frames_byte_identical_and_cross_decode():
    payloads = []
    for seed in range(5):
        j, t = both(seed, w=seed + 1)
        a = jw.encode_report_v2(j, ZONES, seq=seed)
        assert a == tw.encode_report_v2(t, ZONES, seq=seed)
        payloads.append(a)
    batch_j = jw.encode_report_batch(payloads)
    batch_t = tw.encode_report_batch(payloads)
    assert batch_j == batch_t
    assert tw.decode_report_batch(batch_j) == payloads
    assert jw.decode_report_batch(batch_t) == payloads


def test_hostile_frames_raise_the_same():
    j, _ = both(1)
    frame = jw.encode_report_v2(j, ZONES)
    for bad in (frame[:-3], b"garbage" + frame, frame[:20]):
        with pytest.raises(tw.WireError):
            tw.decode_report(bad)
        with pytest.raises(jw.WireError):
            jw.decode_report(bad)
