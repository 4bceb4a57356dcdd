"""Reading a device trace: the window, busy time, idle gaps by what the
host was doing, and device time under a host range."""

from __future__ import annotations

import pytest

from portbench import devtrace


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    _x("user_annotation", devtrace.WINDOW, 0, 100),
    _x("user_annotation", "harness.dispatch", 0, 40),
    _x("cpu_op", "aten::copy_", 5, 20),
    _x("user_annotation", "Optimizer.step#AdamW.step", 29, 3),
    _x("cuda_runtime", "cudaLaunchKernel", 30, 1, corr=7),
    _x("cuda_runtime", "cudaLaunchKernel", 45, 1, corr=8),
    _x("kernel", "k1", 20, 30, tid=9, corr=7),
    _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 60, 10, tid=9,
       corr=8),
    _x("kernel", "k2", 65, 10, tid=9, corr=8),  # overlaps the copy
    _x("kernel", "before", -50, 10, tid=9),  # outside the window
    _x("cpu_op", "aten::other_thread", 50, 5, tid=2),
]


def test_window_busy_and_idle():
    t = devtrace.parse(EVENTS)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_intervals() == [(20, 50), (60, 75)]
    assert t.busy_s == pytest.approx(45e-6)


def test_breakdown_names_gaps_by_the_innermost_span_and_operator():
    b = devtrace.parse(EVENTS).breakdown()
    assert b["device_ops"][0] == ["k1", pytest.approx(30e-6)]
    gaps = dict(b["idle_gaps"])
    # [0, 20] inside harness.dispatch and aten::copy_; [50, 60] and
    # [75, 100] under no range of the window's thread
    assert gaps["harness.dispatch/aten::copy_"] == pytest.approx(20e-6)
    assert gaps["host"] == pytest.approx(35e-6)


def test_device_time_under_a_host_range():
    t = devtrace.parse(EVENTS)
    assert t.device_s_under("Optimizer.step#AdamW.step") == pytest.approx(
        30e-6)
    assert t.count_host("Optimizer.step#AdamW.step") == 1
    assert t.device_s(lambda o: "HtoD" in o.name) == pytest.approx(10e-6)


def test_a_trace_without_the_window_is_refused():
    with pytest.raises(ValueError):
        devtrace.parse(EVENTS[1:])
