"""Kernels B1 and B2 on the card, against their plain versions there.

These tests need an NVIDIA card and the CUDA toolkit: they build
``kepler_tpu_torch/ops/csrc`` at first launch and skip elsewhere. They
import no JAX, so they run on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

B1 must equal its plain version exactly; B2's resident block must equal
it exactly and its f16 plane within one f16 ulp (none is expected: the
kernel runs the plain version's f32 operations in the same order, with
IEEE division and round-to-nearest conversion).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from kepler_tpu_torch.ops import cuda_attribution as ca
from kepler_tpu_torch.parallel.packed import PackedLayout


def f16_ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in f16 units in the last place, elementwise (equal bit
    patterns, NaN included, are 0 apart)."""
    ia = a.astype(np.float16).view(np.int16).astype(np.int32)
    ib = b.astype(np.float16).view(np.int16).astype(np.int32)
    # map sign-magnitude to a monotone integer line
    ia = np.where(ia < 0, -32768 - ia, ia)
    ib = np.where(ib < 0, -32768 - ib, ib)
    return np.abs(ia - ib)


def outer_inputs(seed: int, n: int, w: int, z: int):
    rng = np.random.default_rng(seed)
    ratio = rng.uniform(0.0, 1.0, (n, w)).astype(np.float32)
    ratio[0, : min(w, 3)] = 0.0
    active = rng.uniform(0.0, 5e8, (n, z)).astype(np.float32)
    power = rng.uniform(0.0, 1e8, (n, z)).astype(np.float32)
    return ratio, active, power




def window_inputs(seed: int, n: int, w: int, z: int, db: int):
    """A resident block, DB delta rows and their target indices with
    every edge case of the packed layout."""
    rng = np.random.default_rng(seed)
    lay = PackedLayout(w, z)

    def rows(k: int) -> np.ndarray:
        out = np.zeros((k, lay.width), np.float32)
        out[:, lay.cpu] = rng.uniform(0.0, 5e5, (k, w))
        out[:, lay.cpu][rng.uniform(size=(k, w)) < 0.3] = np.nan
        out[:, lay.zone] = rng.uniform(0.0, 5e8, (k, z))
        out[:, lay.zone_valid] = (rng.uniform(size=(k, z)) > 0.2)
        out[:, lay.col_ratio] = rng.uniform(-0.5, 1.5, k)
        out[:, lay.col_denom] = rng.uniform(1.0, 2e6, k)
        out[:, lay.col_dt] = rng.uniform(0.5, 5.0, k)
        out[:, lay.col_mode] = 0.0
        # edge rows: dt <= 0, denom = 0, a whole empty row
        out[rng.uniform(size=k) < 0.15, lay.col_dt] = 0.0
        out[rng.uniform(size=k) < 0.1, lay.col_dt] = -1.0
        out[rng.uniform(size=k) < 0.15, lay.col_denom] = 0.0
        if k > 2:
            out[1] = lay.empty_row()
        return out

    resident = rows(n)
    delta = rows(db)
    targets = rng.permutation(n)[:db].astype(np.int32)
    idx = np.where(rng.uniform(size=db) < 0.25, n, targets).astype(np.int32)
    return resident, delta, idx


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,w,z", [(1, 1, 1), (64, 256, 4), (1024, 256, 4),
                                   (33, 300, 3)])
def test_outer_product_kernel_equals_plain(cuda_device, n, w, z):
    args = [torch.from_numpy(a).to(cuda_device)
            for a in outer_inputs(n + w, n, w, z)]
    before = ca.LAUNCHES["outer_product_attribution"]
    e, p = ca.outer_product_attribution(*args)
    e_ref, p_ref = ca.outer_product_attribution_ref(*args)
    torch.cuda.synchronize()
    assert ca.LAUNCHES["outer_product_attribution"] == before + 1
    assert torch.equal(e, e_ref) and torch.equal(p, p_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("n,w,z", [(8, 4, 2), (64, 256, 4), (1024, 256, 4),
                                   (37, 17, 3)])
@pytest.mark.parametrize("db_kind", ["one", "eight", "n"])
def test_fused_window_kernel_equals_plain(cuda_device, n, w, z, db_kind):
    db = {"one": 1, "eight": 8, "n": n}[db_kind]
    resident, delta, idx = window_inputs(n + db, n, w, z, db)
    lay = PackedLayout(w, z)
    r_kernel = torch.from_numpy(resident).to(cuda_device)
    r_plain = r_kernel.clone()
    d = torch.from_numpy(delta).to(cuda_device)
    i = torch.from_numpy(idx).to(cuda_device)
    before = ca.LAUNCHES["fused_window_step"]
    _, plane = ca.fused_window_step(r_kernel, d, i, lay)
    _, plane_ref = ca.fused_window_step_ref(r_plain, d, i, lay)
    torch.cuda.synchronize()
    assert ca.LAUNCHES["fused_window_step"] == before + 1
    np.testing.assert_array_equal(r_kernel.cpu().numpy(),
                                  r_plain.cpu().numpy())
    ulps = f16_ulps(plane.cpu().numpy(), plane_ref.cpu().numpy())
    assert int(ulps.max()) <= 1
    assert int((ulps > 0).sum()) == 0


@pytest.mark.cuda
def test_wrapper_checks_dtype_and_contiguity(cuda_device):
    ratio = torch.rand((4, 8), device=cuda_device)
    zones = torch.rand((4, 2), device=cuda_device)
    with pytest.raises(TypeError, match="float32"):
        ca.outer_product_attribution(ratio.double(), zones, zones)
    with pytest.raises(ValueError, match="contiguous"):
        ca.outer_product_attribution(ratio.t().contiguous().t(), zones,
                                     zones)
