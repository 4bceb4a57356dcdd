"""Kernels B1, B2 and B3 on the card, against their plain versions there.

These tests need an NVIDIA card and the CUDA toolkit: they build
``kepler_tpu_torch/ops/csrc`` at first launch and skip elsewhere. They
import no JAX, so they run on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

B1 must equal its plain version exactly; B2's resident block must equal
it exactly and its f16 planes within one f16 ulp (none is expected: the
kernel runs the plain version's f32 operations in the same order, with
IEEE division and round-to-nearest conversion), for one step and for K
steps in one launch. B3's two variants (tensor cores, SIMT) differ from
the plain version only in summation order: at f32 compute within rtol =
atol = 1e-5; at bf16 compute ``m`` and ``l`` within rtol 1e-5 and ``pv``
within 1e-2 · max|v| (products of bf16 values are exact and sums are f32;
one bf16 rounding of ``p`` may flip). Each test asserts which variant
launched.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from kepler_tpu_torch.ops import cuda_attention as cat
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


def attention_inputs(seed: int, b: int, tq: int, tk: int, h: int, d: int,
                     device: torch.device):
    """q, k, v [B, T, H, D] and a ragged KV-validity mask with one fully
    masked sequence."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, t, h, d)).astype(
        np.float32)).to(device) for t in (tq, tk, tk))
    lengths = rng.integers(0, tk + 1, b)
    lengths[0] = 0
    valid = torch.from_numpy(np.arange(tk)[None, :] < lengths[:, None])
    return q, k, v, valid.to(device)


def assert_b3_close(got, want, v: torch.Tensor, cd: torch.dtype) -> None:
    pv, m, l = (t.cpu().numpy() for t in got)
    pv_r, m_r, l_r = (t.cpu().numpy() for t in want)
    np.testing.assert_allclose(m, m_r, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(l, l_r, rtol=1e-5, atol=1e-5)
    if cd == torch.float32:
        np.testing.assert_allclose(pv, pv_r, rtol=1e-5, atol=1e-5)
    else:
        atol = 1e-2 * float(v.abs().max())
        np.testing.assert_allclose(pv, pv_r, rtol=0, atol=atol)


def launched_variant(before: dict) -> str:
    """The one B3 variant launched since ``before`` (a LAUNCHES copy)."""
    grew = [name for name in ("flash_block_tc", "flash_block_simt")
            if cat.LAUNCHES[name] == before[name] + 1]
    assert cat.LAUNCHES["flash_block"] == before["flash_block"] + 1
    assert len(grew) == 1 and sum(cat.LAUNCHES[n] - before[n] for n in (
        "flash_block_tc", "flash_block_simt")) == 1
    return grew[0].removeprefix("flash_block_")


@pytest.mark.cuda
@pytest.mark.parametrize("b,tq,tk,h,d", [
    (1, 1, 1, 1, 8), (7, 16, 16, 4, 32), (5, 9, 13, 4, 16),
    (3, 128, 128, 4, 32), (4, 32, 20, 2, 64), (300, 16, 16, 4, 32),
    (4, 32, 32, 2, 64), (5, 64, 64, 4, 16)])
@pytest.mark.parametrize("cd", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_block_kernel_matches_plain(cuda_device, b, tq, tk, h, d, cd,
                                          causal):
    """Both variants against the plain version; the tensor-core one takes
    every bf16 shape with Tq == Tk a multiple of 16 (up to 128) and D in
    {16, 32, 64}, the SIMT one the rest."""
    q, k, v, valid = attention_inputs(b + tq + d, b, tq, tk, h, d,
                                      cuda_device)
    before = dict(cat.LAUNCHES)
    got = cat.flash_block_pallas(q, k, v, valid, 0, 0, causal=causal,
                                 compute_dtype=cd)
    want = cat.flash_block_ref(q, k, v, valid, 0, 0, causal=causal,
                               compute_dtype=cd)
    torch.cuda.synchronize()
    tc = cat.takes_tensor_cores(tq, tk, d, cd)
    assert launched_variant(before) == ("tc" if tc else "simt")
    assert_b3_close(got, want, v, cd)
    # the fully masked sequence: m = -1e30, l = 0, pv = 0
    assert torch.all(got[1][0] == -1e30) and torch.all(got[2][0] == 0)
    assert torch.all(got[0][0] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cd", [torch.bfloat16, torch.float32])
def test_flash_block_kernel_offsets_and_strides(cuda_device, cd):
    """Block offsets move the causal mask (kv after q: all masked; kv
    before q: nothing masked), and q/k/v views with other strides give
    the same partials: strides that are multiples of 4 floats (16-byte
    copies) and strides that are not (4-byte copies). At bf16 every call
    runs on tensor cores, the views through cp.async, at f32 on SIMT."""
    variant = "tc" if cd == torch.bfloat16 else "simt"
    q, k, v, _ = attention_inputs(1, 6, 16, 16, 4, 32, cuda_device)
    valid = torch.ones((6, 16), dtype=torch.bool, device=cuda_device)
    before = dict(cat.LAUNCHES)
    _, _, l = cat.flash_block_pallas(q, k, v, valid, 0, 16, compute_dtype=cd)
    assert launched_variant(before) == variant
    assert torch.all(l == 0)
    got = cat.flash_block_pallas(q, k, v, valid, 16, 0, compute_dtype=cd)
    assert torch.all(got[2] > 0)
    assert_b3_close(got, cat.flash_block_ref(
        q, k, v, valid, 16, 0, compute_dtype=cd), v, cd)
    wide = torch.randn((6, 16, 5, 33), device=cuda_device)
    qs = wide[:, :, :4, 1:]  # strides not multiples of 4 floats
    aligned = torch.randn((6, 16, 6, 32), device=cuda_device)[:, :, 1:5]
    for view in (qs, aligned):
        before = dict(cat.LAUNCHES)
        got = cat.flash_block_pallas(view, k, v, valid, 0, 0,
                                     compute_dtype=cd)
        assert launched_variant(before) == variant
        want = cat.flash_block_ref(view, k, v, valid, 0, 0, compute_dtype=cd)
        assert_b3_close(got, want, v, cd)
        got = cat.flash_block_pallas(q, view, view, valid, 3, 1,
                                     compute_dtype=cd)
        want = cat.flash_block_ref(q, view, view, valid, 3, 1,
                                   compute_dtype=cd)
        assert_b3_close(got, want, view, cd)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("db_kind", ["one", "eight", "n"])
def test_fused_window_steps_kernel_equals_plain(cuda_device, k, db_kind):
    """One launch of K steps against K calls of the plain version: resident
    bit-equal and 0 f16 mismatches, with a row hit in two steps."""
    n, w, z = 1024, 256, 4
    db = {"one": 1, "eight": 8, "n": n}[db_kind]
    lay = PackedLayout(w, z)
    resident, _, _ = window_inputs(k + db, n, w, z, 1)
    deltas, idx = [], []
    for s in range(k):
        _, d, i = window_inputs(k * 100 + db + s, n, w, z, db)
        if db > 1:
            i[i == 5] = n
            if s < 2:
                i[s] = 5  # row 5 hit in steps 0 and 1
        deltas.append(d)
        idx.append(i)
    d = torch.from_numpy(np.stack(deltas)).to(cuda_device)
    i = torch.from_numpy(np.stack(idx).astype(np.int32)).to(cuda_device)
    r_kernel = torch.from_numpy(resident).to(cuda_device)
    r_plain = r_kernel.clone()
    before = ca.LAUNCHES["fused_window_step"]
    _, planes = ca.fused_window_steps(r_kernel, d, i, lay)
    _, planes_ref = ca.fused_window_steps_ref(r_plain, d, i, lay)
    torch.cuda.synchronize()
    assert ca.LAUNCHES["fused_window_step"] == before + 1
    np.testing.assert_array_equal(r_kernel.cpu().numpy(),
                                  r_plain.cpu().numpy())
    assert planes.shape == (k, n, w + 2, z)
    ulps = f16_ulps(planes.cpu().numpy(), planes_ref.cpu().numpy())
    assert int((ulps > 0).sum()) == 0


@pytest.mark.cuda
def test_flash_block_wrapper_rejects_what_the_kernel_does_not_take(
        cuda_device):
    q = torch.randn((2, 8, 2, 12), device=cuda_device)
    valid = torch.ones((2, 8), dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError, match="head dims"):
        cat.flash_block_pallas(q, q, q, valid, 0, 0)
    q = torch.randn((2, 8, 2, 32), device=cuda_device)
    with pytest.raises(TypeError, match="float32"):
        cat.flash_block_pallas(q.double(), q, q, valid, 0, 0)
    with pytest.raises(TypeError, match="bf16 or f32"):
        cat.flash_block_pallas(q, q, q, valid, 0, 0,
                               compute_dtype=torch.float16)
