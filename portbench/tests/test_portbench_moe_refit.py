"""The mixture-of-experts refit's plain reference
(``reference/refit_moe.py``) against ``cmd.train --model moe``, and the
``moe-refit`` cell at ``tiny_cell`` sizes (8 nodes × 5 pods, 3 windows;
8 experts 128 wide, the widths ``cmd.train`` builds): the start bit for
bit, the first step's loss and gradient, the blocks adding up, the
program correct, its control and the three faults not, the readers, and
the FLOP count of ``moe_train_mfu_pct``.

The pinned readings were taken with this CPU build of torch.
"""

from __future__ import annotations

import subprocess
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from portbench import faults, fleetgen, spec
from portbench.harness import Check, Reading, Spans, Window
from portbench.reference import refit_moe
from portbench.reference.precision import rounding
from portbench.run import run_cell

CPU = torch.device("cpu")
NAME = "moe-refit"

# the tiny cell's readings after its checked steps and two window steps:
# the program's, then the control's
READINGS = {
    4: ({"loss_gap": 0.0, "change_gap": 3.100500784940798e-08,
         "timed_change_gap": 4.692886704722435e-08, "unmoved_leaves": 0.0},
        {"loss_gap": 0.0012642712496648484,
         "change_gap": 0.0059424917968931255,
         "timed_change_gap": 0.0008852894331285455, "unmoved_leaves": 0.0}),
    2**31 + 7: ({"loss_gap": 0.0, "change_gap": 1.932263108610963e-08,
                 "timed_change_gap": 2.6032397514892573e-08,
                 "unmoved_leaves": 0.0},
                {"loss_gap": 0.0003992589847509777,
                 "change_gap": 0.0014726025333993877,
                 "timed_change_gap": 0.0023697084231548457,
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
    non-zero, so every gradient is reached."""
    gen = torch.Generator().manual_seed(seed)
    return {k: 0.1 * torch.randn(v.shape, generator=gen)
            for k, v in refit_moe.start(seed, spec.cell(NAME).config).items()}


def _leaf_gaps(got: dict, want: dict) -> dict[str, float]:
    """Each leaf's ‖got − want‖ over ‖want‖ (0 where both are 0)."""
    out = {}
    for k, w in want.items():
        diff, norm = float((got[k] - w).norm()), float(w.norm())
        out[k] = diff / norm if norm else diff
    return out


@pytest.mark.parametrize("seed", [5, 2**31 + 9])
def test_the_start_is_init_moe_s(seed):
    """``start`` draws ``init_moe``'s params, bit for bit, as
    ``cmd.train`` builds them (a CPU generator seeded with the job's
    seed)."""
    from kepler_tpu_torch.models.moe import init_moe

    config = spec.cell(NAME).config
    start = refit_moe.start(seed, config)
    want = init_moe(len(config["zones"]),
                    generator=torch.Generator().manual_seed(seed))
    assert sorted(start) == sorted(want)
    for k, v in want.items():
        assert start[k].dtype == v.dtype and torch.equal(start[k], v), k
    assert start["gate_w"].shape == (7, 8)
    assert start["w0"].shape == (8, 7, 128)


def test_the_start_is_the_trainer_s(tiny):
    seed = 2**31 + 11
    session = _session(tiny(NAME), seed)
    start = refit_moe.start(seed, session.config)
    assert all(torch.equal(v, session.start[k]) for k, v in start.items())


def test_the_first_step_s_loss_and_gradient(tiny):
    """At the start ``w1``, ``b1`` and ``w_skip`` are zero, so the output
    is 0 and its loss is the program's to f32 order; the gradient (AdamW's
    ``exp_avg ÷ (1 − β1)`` after the step, the driver's ``first_grad``)
    reaches ``w1``, ``b1`` and ``w_skip`` alone, read in f32 on both sides
    but for ``w1``'s bf16 operands (within 1e-5 of each leaf's norm: f32
    summation order); ``gate_w``, ``w0`` and ``b0`` get exactly 0."""
    cell = tiny(NAME)
    seed = 2**31 + 3
    session = _session(cell, seed)
    data = refit_moe.inputs(session.data, CPU)
    loss, grad = refit_moe.loss_and_grad(
        refit_moe.start(seed, cell.config), *data, rounding("bfloat16"))
    assert session.losses[0] == pytest.approx(loss, rel=1e-6)
    head = {"w1", "b1", "w_skip"}
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
    # operand by 2^-8 of itself (0.4%)
    ("bfloat16", torch.bfloat16, 1e-2),
])
def test_loss_and_gradient_at_params_with_every_leaf_non_zero(
        tiny, precision, dtype, tol):
    """The port's mixture step from params that reach every leaf, its
    gradient read from AdamW's ``exp_avg``, against the reference's at
    the same precision."""
    import functools

    from kepler_tpu_torch.models import train as ptrain
    from kepler_tpu_torch.models.moe import predict_moe

    cell = tiny(NAME)
    dumps = _dumps(cell, 11)
    params = _every_leaf_non_zero(12)
    data = refit_moe.inputs(dumps, CPU)
    state = ptrain.create_train_state(params, ptrain.make_optimizer(1e-2))
    step = ptrain.make_train_step(functools.partial(predict_moe,
                                                    compute_dtype=dtype))
    state, loss = step(state, *data)
    got = {k: state.opt_state.state[v]["exp_avg"] / 0.1
           for k, v in state.params.items()}
    want_loss, want = refit_moe.loss_and_grad(params, *data,
                                              rounding(precision))
    assert float(loss) == pytest.approx(want_loss, rel=1e-6)
    gaps = _leaf_gaps(got, want)
    assert all(float(g.norm()) > 0 for g in want.values())
    assert max(gaps.values()) <= tol, gaps


def test_the_blocks_add_up(tiny, monkeypatch):
    """In f32 (no operand rounding to flip) the blocks' loss and gradient
    are the whole batch's to f32 summation order."""
    params = _every_leaf_non_zero(14)
    data = refit_moe.inputs(_dumps(tiny(NAME), 13), CPU)
    rows = int((data[1][..., None] & data[3]).any(-1).sum())
    assert 2 * 7 < rows <= refit_moe.BLOCK_ROWS
    whole = refit_moe.loss_and_grad(params, *data, rounding("float32"))
    monkeypatch.setattr(refit_moe, "BLOCK_ROWS", 7)
    blocks = refit_moe.loss_and_grad(params, *data, rounding("float32"))
    assert blocks[0] == pytest.approx(whole[0], rel=1e-6)
    assert max(_leaf_gaps(blocks[1], whole[1]).values()) <= 1e-5


def test_the_inputs_are_the_mlp_s():
    from portbench.reference import refit_mlp

    assert refit_moe.inputs is refit_mlp.inputs


def test_the_reference_imports_nothing_of_the_port():
    """Loaded alone, the plain refit brings in no module of the port or
    of the JAX package (it runs where neither is importable)."""
    code = ("import sys; import portbench.reference.refit_moe; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('kepler_tpu', 'kepler_tpu_torch', "
            "'jax')))")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True,
                         cwd=str(spec.ROOT)).stdout
    assert out.strip() == "[]"


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


@pytest.mark.parametrize("fault", faults.REFIT_FAULTS)
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
    read = spec.metric("moe_train_mfu_pct")
    # one row, E=1, F=1, H=2, Z=1: the forward 2·(2 + 2 + 1) = 10, the
    # gate 2, the combine 2 → 14; the backward: dW0 2·2, W1's two 2·2·2,
    # dW_skip 2 → 14, the gate's dW 2, the combine's two 4 → 20; 34
    assert read.train_flops(1, 1, 1, 2, 1) == 34
    assert read.train_flops(3, 1, 1, 2, 1) == 102
    assert read.train_flops(1, 8, 7, 128, 4) == 54_560


def test_moe_mfu_counts_the_labelled_rows():
    read = spec.metric("moe_train_mfu_pct")
    config = spec.cell(NAME).config
    trace = SimpleNamespace(window_s=2.0)
    window = Window(seconds=1.0, counts={"steps": 3, "samples": 3 * 1000},
                    attempted=3)
    want = 100 * 3 * read.train_flops(1000, 8, 7, 128, 4) / (2.0 * 989e12)
    assert read.read(Reading(config, {}, 0.0, window, trace)) == \
        pytest.approx(want)
    assert read.read(Reading(config, {}, 0.0, window)) is None
    steps_only = Window(seconds=1.0, counts={"steps": 3}, attempted=3)
    assert read.read(Reading(config, {}, 0.0, steps_only, trace)) is None


def test_the_moe_span_readers():
    """Two steps whose forward holds ``moe.gate`` (a 1 µs kernel),
    ``moe.experts`` (a 3 µs kernel) and ``moe.combine`` (a 2 µs kernel)
    beside its own 10 µs one, launched between the gate and the experts; ``moe_backward_device_ms`` is
    ``backward_device_ms``'s reading; a trace without the spans reads
    nothing."""
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
        events += [_x("user_annotation", "moe.gate", t0 + 1, 3),
                   _x("user_annotation", "moe.experts", t0 + 6, 6),
                   _x("user_annotation", "moe.combine", t0 + 12, 7)]
        for k, (at, dur) in enumerate(((2, 1), (7, 3), (14, 2))):
            events += [_x("cuda_runtime", "cudaLaunchKernel", t0 + at, 1,
                          corr=corr + 50 + k),
                       _x("kernel", f"m{k}", t0 + at + 2, dur, tid=DEVICE,
                          corr=corr + 50 + k)]
    r = reading(events, steps=2)
    got = {m: spec.metric(f"moe_{m}_device_ms").read(r)
           for m in ("experts", "routing", "backward")}
    assert got["experts"] == pytest.approx(3e-3)
    assert got["routing"] == pytest.approx(3e-3)
    assert got["backward"] == spec.metric("backward_device_ms").read(r) \
        == pytest.approx(20e-3)
    bare = reading([WINDOW] + OUTSIDE, steps=2)
    for m in got:
        assert spec.metric(f"moe_{m}_device_ms").read(bare) is None
