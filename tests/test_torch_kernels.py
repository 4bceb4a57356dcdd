"""Kernels B1 and B2 of the port against the JAX package's Pallas kernels.

On the CPU each wrapper of ``kepler_tpu_torch.ops.cuda_attribution``
takes its plain PyTorch version, and the Pallas kernels run in interpret
mode. Both see the same inputs, made with numpy from a seed, including
the edge cases the fleet window produces: pad index N in ``delta_idx``,
NaN cpu slots, ``dt <= 0``, ``denom = 0``, ``ratio`` outside [0, 1] and
invalid zones. The results must be BIT-EQUAL: ``resident'`` exactly and
the f16 plane with zero mismatches (the bar allows one f16 ulp; none is
seen, because both sides run the same f32 operations in the same order).

The CUDA kernels themselves run only on the card: ``test_torch_cuda.py``
compares them with the plain versions there.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kepler_tpu.ops.pallas_attribution import (fused_window_step,
                                               outer_product_attribution)
from kepler_tpu.parallel.packed import PackedLayout as JaxLayout
from kepler_tpu_torch.ops import cuda_attribution as ca
from kepler_tpu_torch.parallel.packed import PackedLayout
from tests.test_torch_cuda import f16_ulps, outer_inputs, window_inputs


@pytest.mark.parametrize("n,w,z", [(1, 1, 1), (8, 16, 2), (12, 130, 4),
                                   (16, 256, 3)])
def test_outer_product_plain_equals_pallas(n, w, z):
    ratio, active, power = outer_inputs(n * 100 + w, n, w, z)
    e_j, p_j = outer_product_attribution(
        jnp.asarray(ratio), jnp.asarray(active), jnp.asarray(power),
        interpret=True)
    e_t, p_t = ca.outer_product_attribution(
        torch.from_numpy(ratio), torch.from_numpy(active),
        torch.from_numpy(power))
    assert e_t.shape == (n, w, z) and e_t.dtype == torch.float32
    np.testing.assert_array_equal(e_t.numpy(), np.asarray(e_j))
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))


@pytest.mark.parametrize("n,w,z", [(8, 4, 2), (16, 17, 4), (24, 256, 4)])
@pytest.mark.parametrize("db_kind", ["one", "eight", "n"])
def test_fused_window_step_plain_equals_pallas(n, w, z, db_kind):
    db = {"one": 1, "eight": 8, "n": n}[db_kind]
    resident, delta, idx = window_inputs(n * 7 + w + db, n, w, z, db)
    res_j, plane_j = fused_window_step(
        jnp.asarray(resident), jnp.asarray(delta), jnp.asarray(idx),
        JaxLayout(w, z), interpret=True)
    res_t = torch.from_numpy(resident.copy())
    out_res, plane_t = ca.fused_window_step(
        res_t, torch.from_numpy(delta), torch.from_numpy(idx),
        PackedLayout(w, z))
    assert out_res is res_t  # resident is updated in place
    assert plane_t.shape == (n, w + 2, z)
    assert plane_t.dtype == torch.float16
    # resident': exact, NaN slots included
    np.testing.assert_array_equal(res_t.numpy(), np.asarray(res_j))
    # f16 plane: ≤ 1 ulp is the bar; count what exceeds 0
    ulps = f16_ulps(plane_t.numpy(), np.asarray(plane_j))
    assert int((ulps > 1).sum()) == 0
    assert int((ulps > 0).sum()) == 0, (
        f"{int((ulps > 0).sum())} f16 values differ by one ulp")


def test_fused_window_step_drops_pad_and_applies_hits():
    n, w, z = 8, 4, 2
    lay = PackedLayout(w, z)
    resident = np.tile(lay.empty_row(), (n, 1))
    delta = np.zeros((2, lay.width), np.float32)
    delta[:, lay.cpu] = 1.0
    delta[:, lay.col_denom] = float(w)
    delta[:, lay.col_dt] = 1.0
    delta[:, lay.zone] = 4e6
    delta[:, lay.zone_valid] = 1.0
    delta[:, lay.col_ratio] = 0.5
    res = torch.from_numpy(resident)
    _, plane = ca.fused_window_step(
        res, torch.from_numpy(delta), torch.tensor([3, n], dtype=torch.int32),
        lay)
    np.testing.assert_array_equal(res[3].numpy(), delta[0])
    assert torch.isnan(res[[0, 1, 2, 4, 5, 6, 7], :w]).all()
    out = plane.float().numpy()
    # node active = 4e6 µJ × 0.5 / 1 s = 2 W; each of 4 workloads gets ¼
    np.testing.assert_allclose(out[3, :w], 0.5)
    np.testing.assert_allclose(out[3, w], 2.0)
    np.testing.assert_allclose(out[3, w + 1], 4.0)
    assert not out[[0, 1, 2, 4, 5, 6, 7]].any()


def test_wrappers_refuse_other_devices():
    ratio = torch.zeros((2, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ca.outer_product_attribution(ratio, ratio[:, :1], ratio[:, :1])


def test_cost_model_byte_counts():
    """B1 at N=1024, W=256, Z=4 moves ≈ 9.4 MB. B2 reads resident once
    and writes back only the rows a delta replaced: ≈ 5.41 MB at DB=N,
    ≈ 3.49 MB at DB=128, and a pad entry moves only its index."""
    nbytes, _ = ca.outer_product_cost(1024, 256, 4)
    assert abs(nbytes - 9.47e6) < 0.1e6
    width, plane = 256 + 2 * 4 + 4, 2 * 1024 * 258 * 4
    nbytes, _ = ca.fused_window_step_cost(1024, 1024, 256, 4)
    assert nbytes == 4 * (1024 * width + 2 * 1024 * width + 1024) + plane
    assert abs(nbytes - 5.41e6) < 0.01e6
    nbytes, _ = ca.fused_window_step_cost(1024, 128, 256, 4)
    assert abs(nbytes - 3.49e6) < 0.01e6
    padded, _ = ca.fused_window_step_cost(1024, 128, 256, 4, hits=120)
    assert nbytes - padded == 4 * 2 * 8 * width
    ms, by = ca.bound_ms(*ca.outer_product_cost(1024, 256, 4))
    assert by == "bytes" and 2e-3 < ms < 4e-3
