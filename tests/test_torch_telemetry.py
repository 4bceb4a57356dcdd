"""The port's span plane (``kepler_tpu_torch.telemetry.spans``) and its
profiler mirror: the disabled path's cost with the profiler gate (the
< 1 µs contract ``tests/test_telemetry.py`` pins for the JAX package),
no profiler range without a recording profiler, spans as nested
``user_annotation`` ranges under a CPU ``torch.profiler`` with the
recorder enabled and disabled, an exception closing both, and the fleet
program's ``fleet.*`` spans: present under a profiler, stages of an
enclosing ``aggregator.window`` cycle, and the published tensors
bit-equal traced and untraced; the temporal estimator's
``temporal.ticks`` and ``temporal.attention``: once each a step inside
``train.forward``, on the full trunk too, and the estimator's output and
a train step's loss and params bit-equal traced and untraced; the
mixture's ``moe.experts``, ``moe.gate`` and ``moe.combine``: once each
a step inside ``train.forward``, in that order, ``moe.experts`` in the
expert-parallel step too, and outputs bit-equal traced and untraced."""

from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kepler_tpu_torch import telemetry
from kepler_tpu_torch.models.mlp import init_mlp
from kepler_tpu_torch.models.moe import init_moe, predict_moe
from kepler_tpu_torch.models.temporal import (
    init_temporal,
    predict_temporal,
    temporal_trunk,
)
from kepler_tpu_torch.models.train import (
    create_train_state,
    make_optimizer,
    make_temporal_train_step,
    make_train_step,
)
from kepler_tpu_torch.parallel import aggregator_core
from kepler_tpu_torch.parallel.fleet import MODE_MODEL, MODE_RATIO, FleetBatch
from kepler_tpu_torch.parallel.mesh import make_mesh
from kepler_tpu_torch.telemetry import SpanRecorder

FLEET_SPANS = ("fleet.pack", "fleet.h2d", "fleet.launch", "fleet.attribute",
               "fleet.estimator", "fleet.mix")
TEMPORAL_SPANS = ("temporal.ticks", "temporal.attention")
MOE_SPANS = ("moe.experts", "moe.gate", "moe.combine")


def ranges(prof, tmp_path) -> list[dict]:
    """The ``user_annotation`` events of a finished profiler's Chrome
    trace, in start order."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted((e for e in events if e.get("cat") == "user_annotation"),
                  key=lambda e: e["ts"])


def within(inner: dict, outer: dict) -> bool:
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


class CountingRange:
    """Stands in for ``torch.profiler.record_function``: counts the
    ranges opened and closed, and opens the real one."""

    opened = closed = 0

    def __init__(self, name: str) -> None:
        from torch.autograd.profiler import record_function

        self._real = record_function(name)

    def __enter__(self):
        CountingRange.opened += 1
        self._real.__enter__()
        return self

    def __exit__(self, *exc):
        CountingRange.closed += 1
        return self._real.__exit__(*exc)


@pytest.fixture
def counted(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", CountingRange)
    CountingRange.opened = CountingRange.closed = 0
    return CountingRange


def test_disabled_span_with_the_profiler_gate_is_sub_microsecond():
    """As the JAX package's contract, and timed its way: with the
    recorder disabled and no profiler recording, one ``with span(...)``
    round trip, the gate included, costs < 1 µs, the best of 300
    rounds of 1,000 calls (rounds short enough that on a busy test
    host the scheduler leaves some of them alone)."""
    assert not telemetry.recorder().enabled  # module default
    assert not torch.autograd.profiler._is_profiler_enabled
    n = 1_000
    best = float("inf")
    for _ in range(300):
        t0 = time.perf_counter()
        for _ in range(n):
            with telemetry.span("train.forward"):
                pass
        best = min(best, (time.perf_counter() - t0) / n)
    assert best < 1e-6, f"disabled span cost {best * 1e9:.0f} ns/call"


@pytest.mark.parametrize("enabled", [False, True])
def test_no_profiler_no_range_and_the_recorder_still_observes(counted,
                                                              enabled):
    rec = SpanRecorder(enabled=enabled)
    with telemetry.installed(rec):
        with telemetry.span("train.step"):
            with telemetry.span("train.forward"):
                pass
            with telemetry.span("window.h2d_delta.s3",
                                stage="window.h2d_delta.shard"):
                pass
    assert counted.opened == 0
    if enabled:
        hist = rec._hist
        assert sorted(hist) == ["train.forward", "train.step",
                                "window.h2d_delta.shard"]
        assert all(h.count == 1 for h in hist.values())
        assert [t.name for t in rec.recent_traces()] == ["train.step"]
    else:
        assert rec.stats()["cycles"] == 0 and not rec._hist
    # the positive control: under a profiler the same spans open ranges
    with telemetry.installed(rec), profile(activities=[ProfilerActivity.CPU]):
        with telemetry.span("train.step"):
            with telemetry.span("train.forward"):
                pass
    assert counted.opened == counted.closed == 2


@pytest.mark.parametrize("enabled", [False, True])
def test_spans_are_nested_profiler_ranges(tmp_path, enabled):
    rec = SpanRecorder(enabled=enabled)
    with telemetry.installed(rec), \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        with telemetry.span("train.step"):
            with telemetry.span("train.forward"):
                torch.ones(8).sum()
            with telemetry.span("window.h2d_delta.s1",
                                stage="window.h2d_delta.shard"):
                torch.ones(8).sum()
    got = {e["name"]: e for e in ranges(prof, tmp_path)}
    # a per-instance name goes to the profiler under its trace name
    assert {"train.step", "train.forward", "window.h2d_delta.s1"} <= set(got)
    assert within(got["train.forward"], got["train.step"])
    assert within(got["window.h2d_delta.s1"], got["train.step"])
    assert (got["train.forward"]["ts"] + got["train.forward"]["dur"]
            <= got["window.h2d_delta.s1"]["ts"])
    if enabled:  # the recorder's cycle is as it was
        (trace,) = rec.recent_traces()
        assert [(e.name, e.depth) for e in trace.events] == [
            ("train.forward", 1), ("window.h2d_delta.s1", 1),
            ("train.step", 0)]
        assert "window.h2d_delta.shard" in rec.stats()["stages"]


@pytest.mark.parametrize("enabled", [False, True])
def test_an_exception_closes_the_span_and_its_range(tmp_path, counted,
                                                    enabled):
    rec = SpanRecorder(enabled=enabled)
    with telemetry.installed(rec), \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(RuntimeError):
            with telemetry.span("train.step"):
                with telemetry.span("train.backward"):
                    raise RuntimeError("boom")
        with telemetry.span("train.after"):
            pass
    assert counted.opened == counted.closed == 3
    got = {e["name"]: e for e in ranges(prof, tmp_path)}
    assert within(got["train.backward"], got["train.step"])
    # the next span opens at the top level, after both closed
    assert not within(got["train.after"], got["train.step"])
    assert rec.inflight() == []
    if enabled:
        assert [t.name for t in rec.recent_traces()] == ["train.step",
                                                         "train.after"]


# -- the fleet program's spans ---------------------------------------------------------------

def fleet_batch(seed: int, n: int = 8, w: int = 6, z: int = 3):
    """A padded batch, half its nodes served by the model."""
    rng = np.random.default_rng(seed)
    valid = rng.random((n, w)) > 0.25
    cpu = np.where(valid, rng.uniform(0.01, 2.0, (n, w)), 0.0)
    names = [f"node-{i}" for i in range(n)]
    return FleetBatch(
        node_names=names, n_nodes=n,
        workload_counts=[int(v.sum()) for v in valid],
        workload_ids=[[f"{m}/w{j}" for j in range(w)] for m in names],
        zone_deltas_uj=rng.uniform(1e6, 5e7, (n, z)).astype(np.float32),
        zone_valid=rng.random((n, z)) > 0.1,
        usage_ratio=rng.uniform(0.2, 0.95, n).astype(np.float32),
        cpu_deltas=cpu.astype(np.float32), workload_valid=valid,
        node_cpu_delta=(cpu.sum(1) * 1.3).astype(np.float32),
        dt_s=np.full(n, 5.0, np.float32),
        mode=np.where(np.arange(n) % 2, MODE_MODEL, MODE_RATIO).astype(
            np.int32))


def random_params(params: dict, seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {k: 0.1 * torch.randn(v.shape, generator=g)
            for k, v in params.items()}


def fleet_cases(seed: int):
    """(program, run_fleet_attribution's arguments) for the MLP program
    over a one-shard mesh, the temporal one over a one-shard mesh, and
    the MLP program on a device without a mesh."""
    batch = fleet_batch(seed)
    n, w, z = batch.shape
    mlp = random_params(init_mlp(z, hidden=16), seed)
    temporal = random_params(init_temporal(z, d_model=16, t_max=4), seed)
    rng = np.random.default_rng(seed + 1)
    t_valid = np.arange(4)[None, None] < rng.integers(1, 5, (n, w))[..., None]
    hist = np.where(t_valid[..., None],
                    rng.normal(0, 1, (n, w, 4, 7)), 0).astype(np.float32)
    mesh = make_mesh(devices=["cpu"])
    return [
        (aggregator_core.make_fleet_program(model_mode="mlp", mesh=mesh),
         (batch, mlp)),
        (aggregator_core.make_temporal_fleet_program(mesh=mesh),
         (batch, temporal, hist, t_valid)),
        (aggregator_core.make_fleet_program("cpu", model_mode="mlp"),
         (batch, mlp)),
    ]


def published(result) -> list[torch.Tensor]:
    blocks = ((result,) if isinstance(result, aggregator_core.FleetResult)
              else result)
    return [t for r in blocks for t in r]


@pytest.mark.parametrize("case", [0, 1, 2])
def test_fleet_spans_and_bit_equal_windows(tmp_path, case):
    program, args = fleet_cases(3)[case]
    plain = published(aggregator_core.run_fleet_attribution(program, *args))
    rec = SpanRecorder(enabled=True)
    with telemetry.installed(rec), \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        with telemetry.span("aggregator.window"):
            traced = published(aggregator_core.run_fleet_attribution(
                program, *args))
    assert len(traced) == len(plain) == 8  # one block
    for a, b in zip(traced, plain):
        assert torch.equal(a, b)
    got = {e["name"]: e for e in ranges(prof, tmp_path)}
    # no host pack without a mesh: the batch moves array by array
    want = FLEET_SPANS[1:] if case == 2 else FLEET_SPANS
    assert set(want) <= set(got)
    for name in ("fleet.attribute", "fleet.estimator", "fleet.mix"):
        assert within(got[name], got["fleet.launch"])
    # the temporal estimator's own spans, inside the estimator's
    if case == 1:
        for name in TEMPORAL_SPANS:
            assert within(got[name], got["fleet.estimator"])
        want = want + TEMPORAL_SPANS
    else:
        assert not set(TEMPORAL_SPANS) & set(got)
    # the operators' stages, nested in the window's cycle
    (trace,) = rec.recent_traces()
    assert trace.name == "aggregator.window"
    assert {e.name for e in trace.events if e.depth >= 1} == set(want)
    assert set(want) <= set(rec.stats()["stages"])


def test_the_debug_torch_trace_holds_the_window_thread_s_spans():
    """``/debug/pprof/torch`` profiles on the HTTP handler's thread; the
    window's spans, opened on another thread, are in its trace too."""
    from kepler_tpu_torch.server.debug import DebugService

    stop = threading.Event()

    def window() -> None:
        while not stop.is_set():
            with telemetry.span("fleet.launch"):
                torch.ones(4).sum()
            stop.wait(0.005)

    th = threading.Thread(target=window)
    th.start()
    try:
        code, _, body = DebugService(None, "cpu")._torch_trace()
    finally:
        stop.set()
        th.join()
    assert code == 200
    path = Path(body.decode().split("written to ", 1)[1].strip())
    try:
        events = json.loads(path.read_text())["traceEvents"]
    finally:
        shutil.rmtree(path.parent, ignore_errors=True)
    assert th.native_id in {e.get("tid") for e in events
                        if e.get("cat") == "user_annotation"
                        and e["name"] == "fleet.launch"}


# -- the temporal estimator's spans ------------------------------------------------------

def temporal_inputs(seed: int, n: int = 3, w: int = 5, t: int = 4):
    """(params, feat_hist [n, w, t, 7], workload_valid, t_valid, targets
    [n, w, 3]): right-padded histories of 1 … t ticks."""
    params = random_params(init_temporal(3, d_model=16, t_max=8), seed)
    rng = np.random.default_rng(seed)
    t_valid = np.arange(t)[None, None] < rng.integers(1, t + 1, (n, w))[
        ..., None]
    feat = np.where(t_valid[..., None], rng.normal(0, 1, (n, w, t, 7)), 0)
    return (params, torch.from_numpy(feat.astype(np.float32)),
            torch.from_numpy(rng.random((n, w)) > 0.2),
            torch.from_numpy(t_valid),
            torch.from_numpy(rng.uniform(0, 5, (n, w, 3)).astype(np.float32)))


def temporal_steps(seed: int, steps: int = 2):
    """``steps`` temporal train steps → (losses, params after them)."""
    params, feat, valid, t_valid, targets = temporal_inputs(seed)
    state = create_train_state(params, make_optimizer(1e-2))
    step = make_temporal_train_step()
    losses = []
    for _ in range(steps):
        state, loss = step(state, feat, valid, t_valid, targets)
        losses.append(loss)
    return losses, {k: v.detach() for k, v in state.params.items()}


@pytest.mark.parametrize("enabled", [False, True])
def test_temporal_spans_nest_in_the_forward_once_a_step(tmp_path, enabled):
    with telemetry.installed(SpanRecorder(enabled=enabled)), \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        temporal_steps(4)
    got = ranges(prof, tmp_path)
    forwards = [e for e in got if e["name"] == "train.forward"]
    assert len(forwards) == 2
    for name in TEMPORAL_SPANS:
        inner = [e for e in got if e["name"] == name]
        assert len(inner) == 2, name
        assert all(sum(within(e, f) for e in inner) == 1 for f in forwards)
    ticks, attention = ([e for e in got if e["name"] == n]
                        for n in TEMPORAL_SPANS)
    assert all(a["ts"] >= k["ts"] + k["dur"]
               for k, a in zip(ticks, attention))


def test_temporal_spans_on_the_full_trunk(tmp_path):
    """The full-sequence trunk (B3's seam) opens the same two names, the
    ticks' before the attention's."""
    params, feat, _, t_valid, _ = temporal_inputs(6)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        temporal_trunk(params, feat.flatten(0, 1), t_valid.flatten(0, 1))
    got = [e for e in ranges(prof, tmp_path) if e["name"] in TEMPORAL_SPANS]
    assert [e["name"] for e in got] == list(TEMPORAL_SPANS)
    assert got[1]["ts"] >= got[0]["ts"] + got[0]["dur"]


@pytest.mark.parametrize("path", ["predict", "train"])
def test_temporal_outputs_bit_equal_traced_and_untraced(path):
    def run():
        if path == "predict":
            params, feat, valid, t_valid, _ = temporal_inputs(8)
            return [predict_temporal(params, feat, valid, t_valid)]
        losses, params = temporal_steps(8)
        return losses + list(params.values())

    plain = run()
    with telemetry.installed(SpanRecorder(enabled=True)), \
            profile(activities=[ProfilerActivity.CPU]):
        traced = run()
    assert len(plain) == len(traced) > 0
    assert all(torch.equal(a, b) for a, b in zip(plain, traced))


# -- the mixture-of-experts estimator's spans ------------------------------------------

def moe_inputs(seed: int, n: int = 3, w: int = 5):
    """(params with every leaf non-zero, features [n, w, 7],
    workload_valid, targets [n, w, 3]) for a mixture of 4 experts, 16
    wide."""
    params = random_params(init_moe(3, n_experts=4, hidden=16), seed)
    rng = np.random.default_rng(seed)
    return (params,
            torch.from_numpy(rng.uniform(0, 2, (n, w, 7)).astype(np.float32)),
            torch.from_numpy(rng.random((n, w)) > 0.2),
            torch.from_numpy(rng.uniform(0, 5, (n, w, 3)).astype(np.float32)))


def moe_steps(seed: int, steps: int = 2):
    """``steps`` refit steps of the learned-gate mixture → (losses,
    params after them)."""
    params, feats, valid, targets = moe_inputs(seed)
    state = create_train_state(params, make_optimizer(1e-2))
    step = make_train_step(predict_moe)
    losses = []
    for _ in range(steps):
        state, loss = step(state, feats, valid, targets)
        losses.append(loss)
    return losses, {k: v.detach() for k, v in state.params.items()}


@pytest.mark.parametrize("enabled", [False, True])
def test_moe_spans_nest_in_the_forward_once_a_step(tmp_path, enabled):
    with telemetry.installed(SpanRecorder(enabled=enabled)), \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        moe_steps(4)
    got = ranges(prof, tmp_path)
    forwards = [e for e in got if e["name"] == "train.forward"]
    assert len(forwards) == 2
    for f in forwards:
        inner = [e for e in got if e["name"] in MOE_SPANS and within(e, f)]
        assert [e["name"] for e in inner] == list(MOE_SPANS)
        assert all(b["ts"] >= a["ts"] + a["dur"]
                   for a, b in zip(inner, inner[1:]))
    assert sum(e["name"] in MOE_SPANS for e in got) == 2 * len(MOE_SPANS)


def test_the_expert_parallel_step_opens_moe_experts(tmp_path):
    """``parallel/expert.py`` runs ``expert_forward`` once a shard: one
    ``moe.experts`` range each, and no gate or combine of the dense
    mixture."""
    from kepler_tpu_torch.parallel import (make_expert_parallel_moe,
                                           make_mesh, top1_route)

    params, feats, _, _ = moe_inputs(5, n=8, w=1)
    feats = feats[:, 0]
    eid, prob = top1_route(params, feats)
    step = make_expert_parallel_moe(make_mesh([2], ["expert"],
                                              devices=["cpu"] * 2))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = step(params, feats, eid, prob)
    assert out.shape == (8, 3)
    got = [e["name"] for e in ranges(prof, tmp_path)
           if e["name"] in MOE_SPANS]
    assert got == ["moe.experts"] * 2


@pytest.mark.parametrize("path", ["predict", "train"])
def test_moe_outputs_bit_equal_traced_and_untraced(path):
    def run():
        if path == "predict":
            params, feats, valid, _ = moe_inputs(8)
            return [predict_moe(params, feats, valid)]
        losses, params = moe_steps(8)
        return losses + list(params.values())

    plain = run()
    with telemetry.installed(SpanRecorder(enabled=True)), \
            profile(activities=[ProfilerActivity.CPU]):
        traced = run()
    assert len(plain) == len(traced) > 0
    assert all(torch.equal(a, b) for a, b in zip(plain, traced))
