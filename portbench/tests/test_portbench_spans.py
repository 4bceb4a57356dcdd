"""The readers of the program's spans on synthetic traces: two steps of
``train.step`` with its forward, loss, backward (launched from another
thread, as autograd does) and AdamW's own range; a trace without the spans
reads nothing; and the fleet program's ``fleet.pack`` host time."""

from __future__ import annotations

import pytest

from portbench import devtrace, spec
from portbench.harness import Reading, Window

STEP = ("forward_device_ms", "loss_device_ms", "backward_device_ms",
        "launches_per_step")
MAIN, AUTOGRAD, DEVICE = 1, 7, 9


def _x(cat, name, ts, dur, tid=MAIN, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def step_events(t0: float, corr: int) -> list[dict]:
    """One step at ``t0`` µs: forward 0-20, loss 20-30, backward 30-70,
    AdamW's own range 72-88; one kernel each, 10, 4, 20 and 2 µs; the
    backward's launch is on autograd's thread."""
    host = [("train.step", 0, 90), ("train.forward", 0, 20),
            ("train.loss", 20, 10), ("train.backward", 30, 40),
            ("Optimizer.step#AdamW.step", 72, 16)]
    kernels = [(5, MAIN, 10), (25, MAIN, 4), (40, AUTOGRAD, 20),
               (75, MAIN, 2)]
    out = [_x("user_annotation", n, t0 + s, d) for n, s, d in host]
    for k, (at, tid, dur) in enumerate(kernels):
        out.append(_x("cuda_runtime", "cudaLaunchKernel", t0 + at, 1,
                      tid=tid, corr=corr + k))
        out.append(_x("kernel", f"k{k}", t0 + at + 2, dur, tid=DEVICE,
                      corr=corr + k))
    # a copy inside the step is no launch
    out.append(_x("cuda_runtime", "cudaMemcpyAsync", t0 + 50, 1,
                  tid=AUTOGRAD))
    return out


def reading(events: list[dict], **counts) -> Reading:
    return Reading({}, {}, 0.0, Window(1.0, counts, 0),
                   devtrace.parse(events))


WINDOW = _x("user_annotation", devtrace.WINDOW, 0, 300)
# a launch outside every step (the harness's) counts in no reader
OUTSIDE = [_x("cuda_runtime", "cudaLaunchKernel", 250, 1, corr=99),
           _x("kernel", "k_out", 252, 30, tid=DEVICE, corr=99)]
TWO_STEPS = ([WINDOW] + step_events(0, 10) + step_events(100, 20)
             + OUTSIDE)


def test_two_steps_split_by_their_spans():
    r = reading(TWO_STEPS, steps=2)
    got = {m: spec.metric(m).read(r) for m in STEP}
    assert got["forward_device_ms"] == pytest.approx(10e-3)
    assert got["loss_device_ms"] == pytest.approx(4e-3)
    # launched from autograd's thread, matched by time to the span
    assert got["backward_device_ms"] == pytest.approx(20e-3)
    assert got["launches_per_step"] == 4
    opt = spec.metric("optimizer_device_ms").read(r)
    assert opt == pytest.approx(2e-3)
    # the four and AdamW's account for the steps' device time
    in_steps = (r.trace.busy_s - 30e-6) / 2 * 1e3
    assert (got["forward_device_ms"] + got["loss_device_ms"]
            + got["backward_device_ms"] + opt) == pytest.approx(in_steps)


def test_the_other_thread_s_host_ranges_are_not_the_window_s():
    r = reading(TWO_STEPS + [_x("user_annotation", "train.backward", 0,
                                300, tid=AUTOGRAD)], steps=2)
    assert r.trace.count_host("train.backward") == 2
    assert spec.metric("backward_device_ms").read(r) == pytest.approx(20e-3)


@pytest.mark.parametrize("name", STEP + ("host_pack_ms",))
def test_absent_spans_read_nothing(name):
    bare = [WINDOW] + OUTSIDE
    assert spec.metric(name).read(reading(bare, steps=2, windows=2)) is None
    untraced = Reading({}, {}, 0.0, Window(1.0, {"steps": 2, "windows": 2},
                                           0))
    assert spec.metric(name).read(untraced) is None


def test_host_pack_ms_a_window():
    events = [WINDOW] + [_x("user_annotation", "fleet.pack", t, 40)
                         for t in (10, 110)]
    # the pack of another thread's window is not this one's
    events.append(_x("user_annotation", "fleet.pack", 200, 90,
                     tid=AUTOGRAD))
    r = reading(events, windows=2)
    assert spec.metric("host_pack_ms").read(r) == pytest.approx(40e-3)
    assert spec.metric("host_pack_ms").read(reading(events, windows=0)) \
        is None
