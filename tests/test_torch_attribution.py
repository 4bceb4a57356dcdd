"""The port's attribution math against the JAX package's.

``attribute``, ``attribute_fleet`` and ``attribute_fleet_pallas`` of
``kepler_tpu_torch.ops`` take the same numpy inputs as their JAX
counterparts (the Pallas kernel in interpret mode) and must agree to
rtol 1e-6: each output is one f32 multiply or divide of the same
operands. The conservation invariant of ``tests/test_attribution.py``
(Σ workload energy == node active energy) is held on the port itself.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kepler_tpu.ops import attribution as ja
from kepler_tpu.ops.pallas_attribution import attribute_fleet_pallas as jpal
from kepler_tpu_torch.ops import attribution as ta
from kepler_tpu_torch.ops.cuda_attribution import attribute_fleet_pallas
from kepler_tpu_torch.parallel.aggregator_core import resolve_attribute_fn

RTOL = 1e-6


def fleet_inputs(seed: int, n: int, w: int, z: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    wl_valid = rng.random((n, w)) > 0.2
    cpu = np.where(wl_valid, rng.uniform(0, 10, (n, w)), 0.0)
    denom = cpu.sum(axis=1)
    denom[0] = 0.0  # a node with no cpu: ratios 0, never NaN
    dt = np.full(n, 5.0)
    dt[-1] = 0.0  # first window: power 0, never inf
    return [
        rng.uniform(1e6, 5e8, (n, z)).astype(np.float32),
        rng.random((n, z)) > 0.1,
        rng.uniform(-0.2, 1.2, n).astype(np.float32),
        cpu.astype(np.float32),
        wl_valid,
        denom.astype(np.float32),
        dt.astype(np.float32),
    ]


def assert_results_close(port, ref) -> None:
    for a, b in zip(port.node, ref.node):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL)
    for a, b in zip(port.workloads, ref.workloads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL)


@pytest.mark.parametrize("port_fn,jax_fn", [
    (ta.attribute_fleet, ja.attribute_fleet),
    (attribute_fleet_pallas, functools.partial(jpal, interpret=True)),
], ids=["einsum", "pallas"])
@pytest.mark.parametrize("n,w,z", [(1, 1, 1), (5, 33, 3), (8, 64, 4)])
def test_fleet_matches_jax(port_fn, jax_fn, n, w, z):
    inputs = fleet_inputs(n * 31 + w, n, w, z)
    ref = jax_fn(*[jnp.asarray(x) for x in inputs])
    port = port_fn(*[torch.from_numpy(x) for x in inputs])
    assert port.workloads.energy_uj.shape == (n, w, z)
    assert_results_close(port, ref)


def test_single_node_matches_jax():
    zones, zvalid, ratio, cpu, wvalid, denom, dt = fleet_inputs(3, 1, 40, 4)
    args = [zones[0], zvalid[0], ratio[0], cpu[0], wvalid[0], denom[0],
            dt[0]]
    ref = ja.attribute(*[jnp.asarray(x) for x in args])
    port = ta.attribute(*[torch.as_tensor(x) for x in args])
    assert_results_close(port, ref)


def test_conservation():
    """Σ workload energy == node active energy (the core invariant)."""
    rng = np.random.default_rng(0)
    n, w, z = 8, 257, 4
    cpu = rng.uniform(0, 10, (n, w)).astype(np.float32)
    zones = rng.uniform(1e6, 5e8, (n, z)).astype(np.float32)
    args = [torch.from_numpy(zones), torch.ones((n, z), dtype=torch.bool),
            torch.full((n,), 0.7), torch.from_numpy(cpu),
            torch.ones((n, w), dtype=torch.bool),
            torch.from_numpy(cpu.sum(axis=1)), torch.full((n,), 5.0)]
    for fn in (ta.attribute_fleet, attribute_fleet_pallas):
        r = fn(*args)
        np.testing.assert_allclose(r.workloads.energy_uj.sum(dim=1).numpy(),
                                   r.node.active_uj.numpy(), rtol=1e-5)
        np.testing.assert_allclose(r.workloads.power_uw.sum(dim=1).numpy(),
                                   r.node.active_power_uw.numpy(),
                                   rtol=1e-5)


def test_masks_and_guards():
    r = ta.attribute_fleet(
        torch.full((2, 2), 1e8), torch.tensor([[True, False]] * 2),
        torch.tensor([1.5, -0.5]), torch.full((2, 3), 1.0),
        torch.tensor([[True, True, False]] * 2), torch.tensor([2.0, 0.0]),
        torch.tensor([5.0, 0.0]))
    assert r.node.energy_uj[:, 1].eq(0).all()
    # usage ratio clamped to [0, 1]
    assert r.node.active_uj[0, 0] == 1e8 and r.node.active_uj[1, 0] == 0
    assert r.workloads.cpu_ratio[0, 2] == 0 and r.workloads.cpu_ratio[1].eq(
        0).all()
    assert not torch.isnan(r.workloads.power_uw).any()
    assert r.node.power_uw[1].eq(0).all()


def test_pad_to_bucket_and_backends():
    for n, b in [(0, 8), (1, 8), (8, 8), (9, 8), (300, 256)]:
        assert ta.pad_to_bucket(n, b) == ja.pad_to_bucket(n, b)
    assert resolve_attribute_fn("einsum") is ta.attribute_fleet
    assert resolve_attribute_fn("pallas") is attribute_fleet_pallas
    with pytest.raises(ValueError, match="backend"):
        resolve_attribute_fn("cuda")


def test_scatter_rows_drops_pads():
    resident = torch.zeros((4, 3))
    rows = torch.arange(9, dtype=torch.float32).reshape(3, 3)
    ta.scatter_rows_(resident, rows, torch.tensor([2, 4, 0]))
    np.testing.assert_array_equal(resident.numpy(),
                                  [[6, 7, 8], [0, 0, 0], [0, 1, 2],
                                   [0, 0, 0]])
