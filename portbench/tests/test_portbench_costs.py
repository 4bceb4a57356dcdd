"""The frozen counts equal small cases worked by hand."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from portbench import costs, spec
from portbench.harness import Reading, Window


def test_b1_bytes_and_operations():
    # N=1, W=2, Z=3: the share plane (2) and two zone planes (2·3) read,
    # two [1, 2, 3] planes written → 20 floats; one multiply an output
    assert costs.b1_cost(1, 2, 3) == (80, 12)


def test_b1_bound_at_the_fleet_shape():
    # 1,024 × 256 × 4: 9.47 MB at 3.35 TB/s
    nbytes, ops = costs.b1_cost(1024, 256, 4)
    assert nbytes == 4 * (1024 * 256 + 2 * 1024 * 4 + 2 * 1024 * 256 * 4)
    assert costs.bound_s(nbytes, ops) == pytest.approx(nbytes / 3.35e12)


def test_temporal_forward_flops():
    # one sequence of 2 ticks, F=1, D=2, MLP 4, Z=1:
    # a tick: in-proj 2·1·2 + K and V 2·2·(2·2) = 4 + 16 = 20
    # once: q and W_o 2·2·(2·2) = 16, scores and P·V 2·2·(2·2) = 16,
    #       MLP 2·2·(2·4) = 32, head 2·2·1 = 4, skip 2·1·1 = 2 → 70
    assert costs.temporal_forward_flops(1, 2, 1, 2, 4, 1) == 2 * 20 + 70
    assert costs.temporal_forward_flops(3, 2, 1, 2, 4, 1) == 3 * 110


def test_temporal_forward_at_the_fleet_shape():
    # by hand: ≈ 0.37 TFLOP a window at 1,024 × 256 slots × 16 ticks
    flops = costs.temporal_forward_flops(1024 * 256, 16, 7, 128, 512, 4)
    assert flops == pytest.approx(0.37e12, rel=0.01)


def test_mlp_train_flops():
    # one row, F=1, H=2, Z=1: forward 2·(2 + 4 + 2 + 1) = 18;
    # backward dW0 2·2, dW1 and dh0 2·2·4, dW2 and dh1 2·2·2, dW_skip 2
    # → 4 + 16 + 8 + 2 = 30
    assert costs.mlp_train_flops(1, 1, 2, 1) == 48
    assert costs.mlp_train_flops(1, 7, 128, 4) == 105_072


def test_bound_takes_the_larger_side():
    assert costs.bound_s(0, int(67e12)) == pytest.approx(1.0)
    assert costs.bound_s(int(3.35e12), 0) == pytest.approx(1.0)


def test_train_mfu_counts_the_rows_the_step_computes_on():
    """``samples ÷ steps`` rows a step (the labelled rows), not every
    padded slot of the dumps; nothing without samples or a trace."""
    read = spec.metric("train_mfu_pct").read
    config = spec.cell("mlp-refit").config
    trace = SimpleNamespace(window_s=2.0)
    window = Window(seconds=1.0, counts={"steps": 3, "samples": 3 * 1000},
                    attempted=3)
    want = 100 * 3 * costs.mlp_train_flops(1000, 7, 128, 4) / (2.0 * 989e12)
    assert read(Reading(config, {}, 0.0, window, trace)) == pytest.approx(
        want)
    assert read(Reading(config, {}, 0.0, window)) is None
    steps_only = Window(seconds=1.0, counts={"steps": 3}, attempted=3)
    assert read(Reading(config, {}, 0.0, steps_only, trace)) is None
