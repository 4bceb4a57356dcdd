"""The port's packed programs and packing helpers against the JAX package.

- ``pack_fleet_inputs`` and ``pack_reports_into`` write bit-equal rows.
- ``make_packed_fleet_program`` (ratio, linear, mlp × einsum, pallas, and
  the sparse estimator gather) over the five ``SWEEP`` shapes of
  ``tests/test_numpy_mirror.py``: ratio rows bit-equal; model rows within
  rtol 1e-3 on the f16 plane — one f16 ulp plus matmul summation order
  (both sides compute the estimator in f32).
- ``make_fused_window_program`` over K intervals, against the JAX scan.
- ``numpy_fleet_window`` is the same function in both packages.

Estimator params come from the JAX initialisers (with a non-zero output
head, so model rows carry real watts) through ``params_from_numpy``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kepler_tpu.models.linear import init_linear
from kepler_tpu.models.mlp import init_mlp
from kepler_tpu.parallel.fleet import NodeReport as JaxReport
from kepler_tpu.parallel.fleet import assemble_fleet_batch as jax_assemble
from kepler_tpu.parallel.mesh import make_mesh
from kepler_tpu.parallel import packed as jp
from kepler_tpu_torch.models.estimator import params_from_numpy
from kepler_tpu_torch.parallel import packed as tp
from kepler_tpu_torch.parallel.fleet import (MODE_MODEL, NodeReport,
                                             assemble_fleet_batch)
from tests.test_numpy_mirror import SWEEP, _random_packed

SWEEP_IDS = [f"n{c[0]}of{c[1]}_w{c[3]}_z{c[4]}_m{int(c[5] * 100)}"
             for c in SWEEP]


def one_device_mesh():
    return make_mesh(devices=jax.devices()[:1])


def jax_params(mode: str | None, z: int, seed: int = 7) -> dict | None:
    """JAX-initialised params as numpy, with a non-zero output head."""
    if mode is None:
        return None
    rng = np.random.default_rng(seed)
    key = jax.random.PRNGKey(seed)
    if mode == "linear":
        p = {k: np.asarray(v) for k, v in init_linear(key, z).items()}
        p["weight"] = rng.normal(0.0, 0.5, p["weight"].shape).astype(
            np.float32)
        p["bias"] = np.full(z, 0.25, np.float32)
        return p
    p = {k: np.asarray(v) for k, v in init_mlp(key, z).items()}
    p["w2"] = rng.normal(0.0, 0.05, p["w2"].shape).astype(np.float32)
    p["w_skip"] = rng.normal(0.0, 0.01, p["w_skip"].shape).astype(np.float32)
    p["b2"] = np.full(z, 0.5, np.float32)
    return p


def reports(seed: int, n: int, z: int) -> list[tuple]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        w = int(rng.integers(0, 9))
        cpu = rng.uniform(0.1, 5.0, w).astype(np.float32)
        out.append(dict(
            node_name=f"n{i}",
            zone_deltas_uj=rng.uniform(1e7, 1e8, z).astype(np.float32),
            zone_valid=rng.uniform(size=z) > 0.2,
            usage_ratio=float(rng.uniform(-0.1, 1.1)),
            cpu_deltas=cpu,
            workload_ids=[f"n{i}-w{j}" for j in range(w)],
            node_cpu_delta=float(cpu.sum()),
            dt_s=float(rng.choice([0.0, 5.0, 2.5])),
            mode=MODE_MODEL if i % 3 == 0 else 0,
        ))
    return out


def test_pack_fleet_inputs_bit_equal():
    reps = reports(1, 13, 3)
    jb = jax_assemble([JaxReport(**r) for r in reps], n_zones=3,
                      node_bucket=8, workload_bucket=8)
    tb = assemble_fleet_batch([NodeReport(**r) for r in reps], n_zones=3,
                              node_bucket=8, workload_bucket=8)
    a, b = jp.pack_fleet_inputs(jb), tp.pack_fleet_inputs(tb)
    assert a.shape == b.shape == (16, 8 + 2 * 3 + 4)
    assert a.tobytes() == b.tobytes()


def test_pack_reports_into_bit_equal():
    reps = reports(2, 9, 2)
    zd = np.stack([r["zone_deltas_uj"] for r in reps])
    zv = np.stack([r["zone_valid"] for r in reps])
    width = tp.packed_width(8, 2)
    a = np.full((12, width), 7.0, np.float32)
    b = a.copy()
    jp.pack_reports_into(a, [JaxReport(**r) for r in reps], zd, zv, 8)
    tp.pack_reports_into(b, [NodeReport(**r) for r in reps], zd, zv, 8)
    assert a.tobytes() == b.tobytes()


def assert_plane_matches(out: np.ndarray, ref: np.ndarray,
                         mode: np.ndarray) -> None:
    assert out.dtype == np.float16 and out.shape == ref.shape
    ratio = mode != MODE_MODEL
    np.testing.assert_array_equal(out[ratio], ref[ratio])
    np.testing.assert_allclose(out[~ratio].astype(np.float32),
                               ref[~ratio].astype(np.float32),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("n_live,nb,w_max,wb,z,model_fraction", SWEEP,
                         ids=SWEEP_IDS)
@pytest.mark.parametrize("mode", [None, "linear", "mlp"])
@pytest.mark.parametrize("backend", ["einsum", "pallas"])
def test_packed_program_matches_jax(n_live, nb, w_max, wb, z,
                                    model_fraction, mode, backend):
    rng = np.random.default_rng(nb * 1000 + wb * 10 + z)
    packed = _random_packed(rng, n_live, nb, w_max, wb, z, model_fraction)
    params = jax_params(mode, z)
    jprog = jp.make_packed_fleet_program(one_device_mesh(), n_workloads=wb,
                                         n_zones=z, model_mode=mode,
                                         backend=backend)
    ref = np.asarray(jprog(params, jnp.asarray(packed)))
    tprog = tp.make_packed_fleet_program(wb, z, model_mode=mode,
                                         backend=backend, device="cpu")
    tparams = params_from_numpy(mode, params) if mode else None
    out = tprog(tparams, torch.from_numpy(packed)).numpy()
    assert_plane_matches(out, ref,
                         packed[:, jp.PackedLayout(wb, z).col_mode])


@pytest.mark.parametrize("n_live,nb,w_max,wb,z,model_fraction", SWEEP,
                         ids=SWEEP_IDS)
@pytest.mark.parametrize("mode", ["linear", "mlp"])
def test_sparse_program_matches_jax(n_live, nb, w_max, wb, z,
                                    model_fraction, mode):
    rng = np.random.default_rng(nb * 1000 + wb * 10 + z + 1)
    packed = _random_packed(rng, n_live, nb, w_max, wb, z, model_fraction)
    col_mode = packed[:, jp.PackedLayout(wb, z).col_mode]
    model_idx = np.flatnonzero(col_mode == MODE_MODEL)
    mb = 8
    rows = np.full(mb, nb, np.int32)
    rows[:len(model_idx)] = model_idx
    params = jax_params(mode, z)
    jprog = jp.make_packed_fleet_program(one_device_mesh(), n_workloads=wb,
                                         n_zones=z, model_mode=mode,
                                         model_bucket=mb)
    ref = np.asarray(jprog(params, jnp.asarray(packed), jnp.asarray(rows)))
    tprog = tp.make_packed_fleet_program(wb, z, model_mode=mode,
                                         model_bucket=mb, device="cpu")
    out = tprog(params_from_numpy(mode, params), torch.from_numpy(packed),
                torch.from_numpy(rows)).numpy()
    assert_plane_matches(out, ref, col_mode)


@pytest.mark.parametrize("mode,backend,sparse", [
    (None, "pallas", False),
    (None, "einsum", False),
    ("mlp", "pallas", False),
    ("mlp", "einsum", True),
])
def test_fused_program_matches_jax_scan(mode, backend, sparse):
    wb, z, nb, k, db = 8, 2, 8, 3, 4
    rng = np.random.default_rng(5)
    resident = _random_packed(rng, 6, nb, 6, wb, z, 0.5)
    deltas = np.stack([_random_packed(rng, db, db, 6, wb, z, 0.5)
                       for _ in range(k)])
    idx = np.stack([rng.permutation(nb)[:db] for _ in range(k)]).astype(
        np.int32)
    idx[1, 0] = nb  # a pad entry: dropped
    mb = 8 if sparse else None
    params = jax_params(mode, z)
    jprog = jp.make_fused_window_program(
        one_device_mesh(), n_workloads=wb, n_zones=z, model_mode=mode,
        backend=backend, model_bucket=mb)
    tprog = tp.make_fused_window_program(wb, z, model_mode=mode,
                                         backend=backend, model_bucket=mb,
                                         device="cpu")
    args = [jnp.asarray(resident), jnp.asarray(deltas), jnp.asarray(idx)]
    targs = [torch.from_numpy(resident.copy()), torch.from_numpy(deltas),
             torch.from_numpy(idx)]
    if sparse:
        mrows = np.full((k, mb), nb, np.int32)
        mrows[:, :3] = [0, 2, 4]
        args.append(jnp.asarray(mrows))
        targs.append(torch.from_numpy(mrows))
    j_res, j_outs = jprog(params, *args)
    tparams = params_from_numpy(mode, params) if mode else None
    t_res, t_outs = tprog(tparams, *targs)
    assert t_res is targs[0]  # the resident block is updated in place
    np.testing.assert_array_equal(t_res.numpy(), np.asarray(j_res))
    assert t_outs.shape == (k, nb, wb + 2, z)
    # replay the scatters on the host for each step's row modes
    lay = jp.PackedLayout(wb, z)
    replay = resident.copy()
    for s in range(k):
        hit = idx[s] < nb
        replay[idx[s][hit]] = deltas[s][hit]
        step_mode = (replay[:, lay.col_mode] if mode
                     else np.zeros(nb, np.float32))
        assert_plane_matches(t_outs[s].numpy(), np.asarray(j_outs[s]),
                             step_mode)


@pytest.mark.parametrize("n_live,nb,w_max,wb,z,model_fraction", SWEEP,
                         ids=SWEEP_IDS)
def test_numpy_fleet_window_unchanged(n_live, nb, w_max, wb, z,
                                      model_fraction):
    rng = np.random.default_rng(nb + wb + z)
    packed = _random_packed(rng, n_live, nb, w_max, wb, z, model_fraction)
    params = jax_params("mlp", z)
    a = jp.numpy_fleet_window(packed, wb, z, params=params, model_mode="mlp")
    b = tp.numpy_fleet_window(packed, wb, z, params=params, model_mode="mlp")
    assert a.tobytes() == b.tobytes()
    for x, y in zip(jp.unpack_fleet_window(a), tp.unpack_fleet_window(b)):
        np.testing.assert_array_equal(x, y)


def test_builders_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tp.make_packed_fleet_program(8, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tp.make_fused_window_program(8, 2, backend="pallas")


def test_sparse_needs_einsum():
    with pytest.raises(ValueError, match="einsum"):
        tp.make_packed_fleet_program(8, 2, model_mode="mlp",
                                     backend="pallas", model_bucket=8,
                                     device="cpu")
