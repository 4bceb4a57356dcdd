"""The temporal refit's plain reference (``reference/refit_temporal.py``)
against ``cmd.train --model temporal``, and the ``temporal-refit`` cell at
``tiny_cell`` sizes (8 nodes × 5 pods, 4 ticks, 3 windows; both sides
build d_model 128, whatever the configuration says): the start bit for
bit, the loss and its gradient within written tolerances, the blocks
adding up, the program correct, its control and the faults that can be
planted not, and the FLOP count of ``temporal_train_mfu_pct``.

The pinned readings were taken with this CPU build of torch.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest
import torch

from portbench import costs, faults, fleetgen, spec
from portbench.drivers.refit import BETA1
from portbench.harness import Check, Reading, Spans, Window
from portbench.reference import refit_temporal
from portbench.reference.precision import rounding
from portbench.run import run_cell

CPU = torch.device("cpu")
NAME = "temporal-refit"
# ``half`` cannot be planted: the temporal step closes over the
# histories, and the first of its inputs is None
FAULTS = ("stale", "altered")

# the tiny cell's readings after its checked steps and two window steps:
# the program's, then the control's
READINGS = {
    4: ({"loss_gap": 2.7702962464771355e-07,
         "change_gap": 2.1669535068282608e-05,
         "timed_change_gap": 2.8862797205218742e-05, "unmoved_leaves": 0.0},
        {"loss_gap": 0.002832766426835195,
         "change_gap": 0.07667136452497961,
         "timed_change_gap": 0.004188830998536694, "unmoved_leaves": 0.0}),
    2**31 + 7: ({"loss_gap": 1.3280677829450966e-06,
                 "change_gap": 0.0001572304128053286,
                 "timed_change_gap": 5.750231233721482e-05,
                 "unmoved_leaves": 0.0},
                {"loss_gap": 0.000765988633578641,
                 "change_gap": 0.02808598857148893,
                 "timed_change_gap": 0.0055397897481226826,
                 "unmoved_leaves": 0.0}),
}


def _session(cell, seed: int):
    return spec.driver("refit").setup(cell.config, cell.traffic, seed, CPU,
                                      Spans(False))


def _dumps(cell, seed: int) -> dict:
    return fleetgen.training_dump(cell.config, cell.traffic,
                                  torch.Generator().manual_seed(seed), CPU)


def _every_leaf_non_zero(seed: int) -> dict:
    """Params at the widths ``cmd.train`` builds with every leaf drawn
    non-zero (the served window's draws), so every gradient is reached."""
    est = {"d_model": 128, "n_features": 7, "mlp_ratio": 4, "t_max": 128}
    return fleetgen.temporal_params(est, 4,
                                    torch.Generator().manual_seed(seed), CPU)


def _leaf_gaps(got: dict, want: dict) -> dict[str, float]:
    """Each leaf's ‖got − want‖ over ‖want‖ (0 where both are 0)."""
    out = {}
    for k, w in want.items():
        diff, norm = float((got[k] - w).norm()), float(w.norm())
        out[k] = diff / norm if norm else diff
    return out


@pytest.mark.parametrize("seed", [5, 2**31 + 9])
def test_the_start_is_the_trainer_s(tiny, seed):
    cell = tiny(NAME)
    session = _session(cell, seed)
    start = refit_temporal.start(seed, cell.config)
    assert sorted(start) == sorted(session.start)
    for k, v in start.items():
        assert torch.equal(v, session.start[k]), k
    assert start["in_proj"].shape == (7, 128)
    assert start["pos_emb"].shape == (128, 128)


def test_the_first_step_s_loss_and_gradient(tiny):
    """The loss of the first step reads only the start (zero head and
    skip path: the output is 0), so it is the program's to f32 order;
    the gradient, AdamW's ``exp_avg ÷ (1 − β1)`` after the step as the
    driver's ``first_grad``, reaches only the head, its bias and the
    skip path, all read in f32 on both sides (within 1e-5 of each leaf's
    norm: f32 summation order); every trunk leaf's is exactly 0."""
    cell = tiny(NAME)
    seed = 2**31 + 3
    session = _session(cell, seed)
    data = refit_temporal.inputs(session.data, CPU)
    loss, grad = refit_temporal.loss_and_grad(
        refit_temporal.start(seed, cell.config), *data, rounding("bfloat16"))
    assert session.losses[0] == pytest.approx(loss, rel=1e-6)
    head = {"w_head", "b_head", "w_skip"}
    gaps = _leaf_gaps(session.first_grad, grad)
    for k, g in grad.items():
        if k in head:
            assert float(g.norm()) > 0 and gaps[k] <= 1e-5, k
        else:
            assert not g.any() and not session.first_grad[k].any(), k


@pytest.mark.parametrize("precision,dtype,tol", [
    # the same products, summed in another order in f32
    ("float32", torch.float32, 1e-5),
    # an f32 sum that lands on the other side of a bf16 rounding moves an
    # operand by 2^-8 of itself (0.4%); measured ≤ 1.2e-3 of a leaf
    ("bfloat16", torch.bfloat16, 1e-2),
])
def test_loss_and_gradient_at_params_with_every_leaf_non_zero(
        tiny, precision, dtype, tol):
    """The port's temporal step from params that reach every leaf, its
    gradient read from AdamW's ``exp_avg``, against the reference's at
    the same precision."""
    from kepler_tpu_torch.models import train as ptrain

    dumps = _dumps(tiny(NAME), 11)
    params = _every_leaf_non_zero(12)
    state = ptrain.create_train_state(params, ptrain.make_optimizer(1e-2))
    step = ptrain.make_temporal_train_step(compute_dtype=dtype)
    state, loss = step(state, *(torch.from_numpy(dumps[k]) for k in (
        "feat_hist", "workload_valid", "t_valid", "target_watts",
        "label_valid")))
    got = {k: state.opt_state.state[v]["exp_avg"] / (1 - BETA1)
           for k, v in state.params.items()}
    want_loss, want = refit_temporal.loss_and_grad(
        params, *refit_temporal.inputs(dumps, CPU), rounding(precision))
    assert float(loss) == pytest.approx(want_loss, rel=1e-6)
    gaps = _leaf_gaps(got, want)
    assert all(float(g.norm()) > 0 for g in want.values())
    assert max(gaps.values()) <= tol, gaps


def test_the_blocks_add_up(tiny, monkeypatch):
    """In f32 (no operand rounding to flip) the blocks' loss and gradient
    are the whole batch's to f32 summation order."""
    params = _every_leaf_non_zero(14)
    data = refit_temporal.inputs(_dumps(tiny(NAME), 13), CPU)
    assert 2 * 7 < data[0].shape[0] <= refit_temporal.BLOCK_ROWS
    whole = refit_temporal.loss_and_grad(params, *data, rounding("float32"))
    monkeypatch.setattr(refit_temporal, "BLOCK_ROWS", 7)
    blocks = refit_temporal.loss_and_grad(params, *data,
                                          rounding("float32"))
    assert blocks[0] == pytest.approx(whole[0], rel=1e-6)
    assert max(_leaf_gaps(blocks[1], whole[1]).values()) <= 1e-5


def test_the_inputs_are_the_labelled_rows(tiny):
    dumps = _dumps(tiny(NAME), 15)
    feat, t_valid, valid, targets, label_valid = refit_temporal.inputs(
        dumps, CPU)
    keep = dumps["label_valid"].any(-1)
    assert 0 < feat.shape[0] == int(keep.sum()) < keep.size
    assert feat.shape[1:] == (4, 7) and t_valid.shape[1:] == (4,)
    assert bool(valid.all()) and bool(label_valid.any(-1).all())
    assert targets.shape == label_valid.shape == (feat.shape[0], 4)


def test_the_program_is_correct(tiny):
    out, checks = run_cell(tiny(NAME), 2**31 + 7, 0.3, False, CPU,
                           time.perf_counter())
    assert out["correct"], checks
    assert out["attempted"] > 0 and out["failed"] == 0
    assert {"setup_s", "train_samples_per_s"} == set(out["metrics"])


def test_the_control_is_not(tiny):
    cell = tiny(NAME)
    for seed in (1, 2, 3):
        session = _session(cell, seed)
        session.run(0.1)
        control = session.control_gaps()
        checks = [Check(k, control[k], limit)
                  for k, limit in cell.limits.items()]
        assert not all(c.ok for c in checks), (seed, control)


@pytest.mark.parametrize("fault", FAULTS)
def test_a_planted_fault_is_not(tiny, fault):
    cell = tiny(NAME)
    with faults.planted("refit", fault):
        out, checks = run_cell(cell, 2**31 + 7, 0.3, False, CPU,
                               time.perf_counter())
    assert not out["correct"], checks


@pytest.mark.parametrize("seed", sorted(READINGS))
def test_the_readings_are_as_pinned(tiny, seed):
    session = _session(tiny(NAME), seed)
    for _ in range(2):  # a window of two steps
        session.state, _ = session.step_fn(session.state, *session.inputs)
    program, control = READINGS[seed]
    assert session.program_readings() == program
    assert session.control_gaps() == control


def test_train_flops_by_hand():
    read = spec.metric("temporal_train_mfu_pct")
    # one sequence of 2 ticks, F=1, D=2, MLP 4, Z=1: the forward 110
    # (test_portbench_costs); the backward a tick: dW_in 2·2, K and V
    # weight and input 2·2·(2·4) → 36; once: q and W_o 2·2·(2·4) = 32,
    # scores and P·V 2·2·(2·4) = 32, the MLP 2·2·(2·8) = 64, the head
    # 2·2·2 = 8, dW_skip 2 → 138; 110 + 2·36 + 138 = 320
    assert read.train_flops(1, 2, 1, 2, 4, 1) == 320
    assert read.train_flops(3, 2, 1, 2, 4, 1) == 960
    forward = costs.temporal_forward_flops(1, 16, 7, 128, 512, 4)
    assert read.train_flops(1, 16, 7, 128, 512, 4) == 4_213_872
    assert 4_213_872 - forward == 2_799_672  # 1.98× the forward


def test_temporal_mfu_counts_the_labelled_rows():
    read = spec.metric("temporal_train_mfu_pct")
    config = spec.cell(NAME).config
    trace = SimpleNamespace(window_s=2.0)
    window = Window(seconds=1.0, counts={"steps": 3, "samples": 3 * 1000},
                    attempted=3)
    want = (100 * 3 * read.train_flops(1000, 16, 7, 128, 512, 4)
            / (2.0 * 989e12))
    assert read.read(Reading(config, {}, 0.0, window, trace)) == \
        pytest.approx(want)
    assert read.read(Reading(config, {}, 0.0, window)) is None
    steps_only = Window(seconds=1.0, counts={"steps": 3}, attempted=3)
    assert read.read(Reading(config, {}, 0.0, steps_only, trace)) is None


def test_the_temporal_span_readers():
    """Two steps whose forward holds ``temporal.ticks`` (a 3 µs kernel)
    and ``temporal.attention`` (a 1 µs kernel) beside its own 10 µs one;
    ``temporal_backward_device_ms`` is ``backward_device_ms``'s reading;
    a trace without the spans reads nothing."""
    from portbench.tests.test_portbench_spans import (
        DEVICE,
        OUTSIDE,
        WINDOW,
        _x,
        reading,
        step_events,
    )

    events = [WINDOW] + OUTSIDE
    for t0, corr in ((0, 10), (100, 20)):
        events += step_events(t0, corr)
        events += [_x("user_annotation", "temporal.ticks", t0 + 1, 3),
                   _x("user_annotation", "temporal.attention", t0 + 8, 11)]
        for k, (at, dur) in enumerate(((2, 3), (13, 1))):
            events += [_x("cuda_runtime", "cudaLaunchKernel", t0 + at, 1,
                          corr=corr + 50 + k),
                       _x("kernel", f"t{k}", t0 + at + 2, dur, tid=DEVICE,
                          corr=corr + 50 + k)]
    r = reading(events, steps=2)
    got = {m: spec.metric(f"temporal_{m}_device_ms").read(r)
           for m in ("ticks", "attention", "backward")}
    assert got["ticks"] == pytest.approx(3e-3)
    assert got["attention"] == pytest.approx(1e-3)
    assert got["backward"] == spec.metric("backward_device_ms").read(r) \
        == pytest.approx(20e-3)
    # the forward's own kernel is under neither
    assert spec.metric("forward_device_ms").read(r) == pytest.approx(14e-3)
    bare = reading([WINDOW] + OUTSIDE, steps=2)
    for m in got:
        assert spec.metric(f"temporal_{m}_device_ms").read(bare) is None
