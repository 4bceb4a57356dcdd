"""Kernels B1, B2 and B3 and the delta update's row scatter on the card,
against their plain versions there.

These tests need an NVIDIA card and the CUDA toolkit: they build
``kepler_tpu_torch/ops/csrc`` at first launch and skip elsewhere. They
import no JAX, so they run on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

B1 must equal its plain version exactly; B2's resident block must equal
it exactly and its f16 planes within one f16 ulp (none is expected: the
kernel runs the plain version's f32 operations in the same order, with
IEEE division and round-to-nearest conversion), for one step and for K
steps in one launch, and per node block of a mesh bit for bit. B3's two variants (tensor cores, KV-tiled) differ from
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
from kepler_tpu_torch.ops.attribution import scatter_rows_ as ta_scatter_rows_
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
@pytest.mark.parametrize("shape,axes", [([8], ("node",)),
                                        ([4, 2], ("node", "model"))])
def test_fused_program_per_node_block_equals_plain(cuda_device, shape, axes):
    """The fused loop over a mesh of virtual shards of the card, with
    ``backend="pallas"``: one B2 launch per node block per flush, and
    every block's resident and K planes bit-equal to the plain version
    of B2 on the same block-local inputs."""
    from kepler_tpu_torch.parallel.mesh import make_mesh
    from kepler_tpu_torch.parallel.packed import (block_delta_width,
                                                  cut_deltas_by_block,
                                                  make_fused_window_program)

    n, w, z, k, db = 1024, 256, 4, 4, 128
    mesh = make_mesh(shape, axes, devices=[cuda_device] * 8)
    n_blocks = shape[0]
    sb = n // n_blocks
    resident, _, _ = window_inputs(5, n, w, z, 1)
    rng = np.random.default_rng(6)
    deltas = np.stack([window_inputs(7 + s, db, w, z, 1)[0]
                       for s in range(k)])
    idx = np.stack([rng.permutation(n)[:db] for _ in range(k)]).astype(
        np.int32)
    idx[rng.uniform(size=idx.shape) < 0.2] = n  # pads
    dbb = block_delta_width(list(idx), n, n_blocks)
    cut_rows = np.empty((n_blocks, k, dbb, deltas.shape[-1]), np.float32)
    cut_idx = np.empty((n_blocks, k, dbb), np.int32)
    cut_deltas_by_block(list(zip(deltas, idx)), n, cut_rows, cut_idx)
    cuts = list(zip(cut_rows, cut_idx))
    lay = PackedLayout(w, z)
    fused = make_fused_window_program(w, z, backend="pallas", mesh=mesh)

    def blocks():
        return [torch.from_numpy(resident[b * sb:(b + 1) * sb].copy()).to(
            cuda_device) for b in range(n_blocks)]

    rows = [torch.from_numpy(r).to(cuda_device) for r, _ in cuts]
    idxs = [torch.from_numpy(i).to(cuda_device) for _, i in cuts]
    before = ca.LAUNCHES["fused_window_step"]
    res, outs = fused([None] * n_blocks, blocks(), rows, idxs)
    torch.cuda.synchronize()
    assert ca.LAUNCHES["fused_window_step"] == before + n_blocks
    for b, plain in enumerate(blocks()):
        _, plane = ca.fused_window_steps_ref(plain, rows[b], idxs[b], lay)
        # bit for bit (the resident's empty workload slots are NaN)
        assert torch.equal(res[b].view(torch.int32), plain.view(torch.int32))
        assert outs[b].shape == (k, sb, w + 2, z)
        assert torch.equal(outs[b].view(torch.int16),
                           plane.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("n,width,db", [(16_384, 268, 8), (16_384, 268, 512),
                                        (16_384, 268, 1024), (1024, 268, 1024),
                                        (37, 17, 5)])
def test_scatter_rows_kernel_equals_plain(cuda_device, n, width, db):
    """The row scatter in one launch against its plain version on the
    same inputs: pads (N and beyond) dropped, a duplicate index (the
    later row wins), NaN copied as is — bit-equal."""
    rng = np.random.default_rng(n + db)
    resident = torch.from_numpy(rng.normal(size=(n, width)).astype(
        np.float32)).to(cuda_device)
    rows = rng.normal(size=(db, width)).astype(np.float32)
    rows[0, 0] = np.nan
    idx = rng.permutation(n)[:db].astype(np.int32)
    idx[rng.uniform(size=db) < 0.25] = n
    idx[-1] = n + 7
    if db >= 3:
        idx[1] = idx[2] = rng.integers(0, n)  # a duplicate: row 2 wins
    rows_d = torch.from_numpy(rows).to(cuda_device)
    idx_d = torch.from_numpy(idx).to(cuda_device)
    plain = resident.clone()
    before = ca.LAUNCHES["scatter_rows"]
    version = resident._version
    out = ca.scatter_rows(resident, rows_d, idx_d)
    ta_scatter_rows_(plain, rows_d, idx_d)
    torch.cuda.synchronize()
    assert out is resident and resident._version > version
    assert ca.LAUNCHES["scatter_rows"] == before + 1
    assert torch.equal(resident.view(torch.int32), plain.view(torch.int32))
    ca.scatter_rows(resident, rows_d[:0], idx_d[:0])  # DB = 0: no launch
    assert ca.LAUNCHES["scatter_rows"] == before + 1


@pytest.mark.cuda
def test_scatter_rows_raises_without_its_library(cuda_device, monkeypatch):
    """No fallback: on a CUDA tensor the wrapper launches its kernel or
    raises, and a failed build leaves the batch untouched."""
    from kepler_tpu_torch.ops import build

    def missing(name):
        raise RuntimeError(f"nvcc not found: cannot build {name}.cu")

    monkeypatch.setattr(build, "load", missing)
    resident = torch.zeros((8, 4), device=cuda_device)
    rows = torch.ones((2, 4), device=cuda_device)
    idx = torch.tensor([1, 8], dtype=torch.int32, device=cuda_device)
    before = ca.LAUNCHES["scatter_rows"]
    with pytest.raises(RuntimeError, match="nvcc not found"):
        ca.scatter_rows(resident, rows, idx)
    assert ca.LAUNCHES["scatter_rows"] == before
    assert bool((resident == 0).all())
    with pytest.raises(TypeError, match="int32"):
        ca.scatter_rows(resident, rows, idx.long())


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
    grew = [name for name in ("flash_block_tc", "flash_block_tiled")
            if cat.LAUNCHES[name] == before[name] + 1]
    assert cat.LAUNCHES["flash_block"] == before["flash_block"] + 1
    assert len(grew) == 1 and sum(cat.LAUNCHES[n] - before[n] for n in (
        "flash_block_tc", "flash_block_tiled")) == 1
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
    {16, 32, 64}, the KV-tiled one the rest."""
    q, k, v, valid = attention_inputs(b + tq + d, b, tq, tk, h, d,
                                      cuda_device)
    before = dict(cat.LAUNCHES)
    got = cat.flash_block_pallas(q, k, v, valid, 0, 0, causal=causal,
                                 compute_dtype=cd)
    want = cat.flash_block_ref(q, k, v, valid, 0, 0, causal=causal,
                               compute_dtype=cd)
    torch.cuda.synchronize()
    tc = cat.takes_tensor_cores(tq, tk, d, cd)
    assert launched_variant(before) == ("tc" if tc else "tiled")
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
    runs on tensor cores, the views through cp.async, at f32 on the
    KV-tiled variant."""
    variant = "tc" if cd == torch.bfloat16 else "tiled"
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


TILED_CASES = {
    # (b, tq, tk, h, d, q_start, kv_start): blocks only the tiled variant
    # takes -- T = 300 with a D that is padded to 16 (bf16) or 32 (f32),
    # the ring's 512-row block at D = 128, a short q block against a long
    # KV block at offsets, and D = 5 (4-byte copies, scalar stores)
    "t300_d12": (3, 300, 300, 2, 12, 0, 0),
    "t512_d128": (2, 512, 512, 2, 128, 0, 0),
    "tq64_tk640_offsets": (3, 64, 640, 2, 32, 512, 100),
    "t20_tk33_d5": (4, 20, 33, 3, 5, 3, 0),
    "t48_d256": (2, 48, 40, 2, 256, 0, 0),
    # the wide path: D above 256 in chunks of 64 columns
    "t40_d320": (3, 40, 48, 2, 320, 0, 0),
    "t24_d512": (3, 24, 24, 2, 512, 8, 0),
    # each branch of its design: one pass at the served T = 16, a KV row
    # streamed in two passes over 64-key tiles, D = 1000 (16 chunks, the
    # last one partial) and rows that see no key (causal, KV from 8)
    "t16_d512_one_pass": (3, 16, 16, 2, 512, 0, 0),
    "t20_tk100_d320_streamed": (3, 20, 100, 2, 320, 80, 0),
    "t16_d1000_chunks": (3, 16, 16, 2, 1000, 0, 0),
    "t16_d384_masked_rows": (3, 16, 32, 2, 384, 0, 8),
    # either side of the one-pass boundary at DP 32: 128 keys in one tile,
    # 144 keys two tiles (f32) or resident (bf16)
    "t96_tk128_one_pass": (3, 96, 128, 2, 32, 32, 0),
    "t96_tk144_past_one_pass": (3, 96, 144, 2, 32, 48, 0),
    # the 2-shard ring's 512-row bf16 block, K and V resident
    "t512_d32_resident": (3, 512, 512, 4, 32, 512, 512),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(TILED_CASES))
@pytest.mark.parametrize("cd", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
def test_tiled_kernel_matches_plain_at_every_block(cuda_device, case, cd,
                                                   causal):
    """The KV-tiled variant against the plain version at blocks the
    tensor-core one does not take; sequence 0 has no valid key (m =
    -1e30, l = 0, pv = 0). The launch counter shows "flash_block_tiled"
    and no other variant key."""
    b, tq, tk, h, d, q_start, kv_start = TILED_CASES[case]
    q, k, v, valid = attention_inputs(b + tq + d, b, tq, tk, h, d,
                                      cuda_device)
    assert set(cat.LAUNCHES) == {"flash_block", "flash_block_tc",
                                 "flash_block_tiled"}
    before = dict(cat.LAUNCHES)
    got = cat.flash_block_pallas(q, k, v, valid, q_start, kv_start,
                                 causal=causal, compute_dtype=cd)
    want = cat.flash_block_ref(q, k, v, valid, q_start, kv_start,
                               causal=causal, compute_dtype=cd)
    torch.cuda.synchronize()
    assert launched_variant(before) == "tiled"
    assert_b3_close(got, want, v, cd)
    assert torch.all(got[1][0] == -1e30) and torch.all(got[2][0] == 0)
    assert torch.all(got[0][0] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cd", [torch.bfloat16, torch.float32])
def test_tiled_kernel_takes_strided_views_and_forced_plans(cuda_device, cd):
    """Strided q/k/v views (4-byte copies where strides are not multiples
    of 4 floats, 16-byte ones where they are) at a padded D and a long
    block, and on the wide path at D = 320, and the tiled variant forced
    where tensor cores would run (the ring's 128-row block at bf16), all
    against the plain version; the instances' registers and spills."""
    q, k, v, valid = attention_inputs(5, 3, 144, 144, 4, 24, cuda_device)
    wide = torch.randn((3, 144, 5, 25), device=cuda_device)
    odd = wide[:, :, 1:, 1:]  # strides not multiples of 4 floats
    aligned = torch.randn((3, 144, 6, 28), device=cuda_device)[:, :, 1:5, 4:]
    for view in (odd, aligned):
        before = dict(cat.LAUNCHES)
        got = cat.flash_block_pallas(view, k, v, valid, 0, 0,
                                     compute_dtype=cd)
        assert launched_variant(before) == "tiled"
        assert_b3_close(got, cat.flash_block_ref(
            view, k, v, valid, 0, 0, compute_dtype=cd), v, cd)
        got = cat.flash_block_pallas(q, view, view, valid, 7, 3,
                                     compute_dtype=cd)
        assert_b3_close(got, cat.flash_block_ref(
            q, view, view, valid, 7, 3, compute_dtype=cd), view, cd)
    q, k, v, valid = attention_inputs(6, 8, 128, 128, 4, 32, cuda_device)
    plan = cat.tiled_plan(8, 128, 128, 32, cd)
    before = dict(cat.LAUNCHES)
    got = cat.flash_block_launch(plan, q, k, v, valid, 256, 128,
                                 compute_dtype=cd)
    torch.cuda.synchronize()
    assert launched_variant(before) == "tiled"
    assert_b3_close(got, cat.flash_block_ref(
        q, k, v, valid, 256, 128, compute_dtype=cd), v, cd)
    info = cat.flash_block_info("tiled", 16, 32, cd)
    assert info["local_bytes"] == 0 and info["max_threads"] >= 256
    # the one-pass instance keeps a 128-key row in registers and two
    # blocks an SM (at f32 with 32 bytes of spill); the streaming, resident
    # and wide instances spill nothing
    assert cat.flash_block_info("tiled", 128, 32, cd)["registers"] <= 128
    for t, d in ((512, 32), (16, 512)):
        assert cat.flash_block_info("tiled", t, d, cd)["local_bytes"] == 0
    # the wide instance: one warp a block, at most 255 registers
    info = cat.flash_block_info("tiled", 16, 512, cd)
    assert info["registers"] <= 255 and info["max_threads"] >= 32
    # the wide path on strided views: 4-byte copies where the view is
    # misaligned and its strides are not multiples of 4 floats, 16-byte
    # ones where they are
    q, k, v, valid = attention_inputs(7, 3, 16, 16, 2, 320, cuda_device)
    odd = torch.randn((3, 16, 3, 321), device=cuda_device)[:, :, :2, 1:]
    aligned = torch.randn((3, 16, 4, 324), device=cuda_device)[:, :, 1:3, 4:]
    for view in (odd, aligned):
        before = dict(cat.TILED_PATH_LAUNCHES)
        got = cat.flash_block_pallas(view, k, v, valid, 0, 0,
                                     compute_dtype=cd)
        assert cat.TILED_PATH_LAUNCHES["wide"] == before["wide"] + 1
        assert_b3_close(got, cat.flash_block_ref(
            view, k, v, valid, 0, 0, compute_dtype=cd), v, cd)
        got = cat.flash_block_pallas(q, view, view, valid, 3, 1,
                                     compute_dtype=cd)
        assert_b3_close(got, cat.flash_block_ref(
            q, view, view, valid, 3, 1, compute_dtype=cd), view, cd)


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
    valid = torch.ones((2, 8), dtype=torch.bool, device=cuda_device)
    q = torch.randn((2, 8, 2, 32), device=cuda_device)
    with pytest.raises(ValueError, match="Tq, Tk >= 1"):
        cat.flash_block_pallas(q[:, :0], q, q, valid, 0, 0,
                               compute_dtype=torch.float32)
    with pytest.raises(TypeError, match="float32"):
        cat.flash_block_pallas(q.double(), q, q, valid, 0, 0)
    with pytest.raises(TypeError, match="bf16 or f32"):
        cat.flash_block_pallas(q, q, q, valid, 0, 0,
                               compute_dtype=torch.float16)


@pytest.mark.cuda
def test_copy_to_host_async_waits_on_its_event(cuda_device):
    """The pinned D2H copy is read only after its event, from another
    thread whose current stream is not the one the copy was queued on."""
    import threading

    from kepler_tpu_torch.fleet.window import copy_to_host_async

    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        x = torch.randn((4096, 4096), device=cuda_device)
        y = (x @ x).to(torch.float16)  # long enough to still be running
        copy = copy_to_host_async(y, x[:8])
    out: list = []
    worker = threading.Thread(target=lambda: out.extend(copy.wait()))
    worker.start()
    worker.join(timeout=120)
    torch.cuda.synchronize()
    assert len(out) == 2
    assert np.array_equal(out[0], y.cpu().numpy())
    assert np.array_equal(out[1], x[:8].cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("axis", [0, 1])
def test_copy_blocks_to_host_async_joins_blocks_in_one_buffer(cuda_device,
                                                             axis):
    """Per-block results on the card land in one pinned buffer, each
    field joined over the blocks along ``axis``, equal to the blocks
    joined on the card."""
    from kepler_tpu_torch.fleet.window import copy_blocks_to_host_async

    gen = torch.Generator(device=cuda_device).manual_seed(4)
    blocks = [(torch.randn((4, 128, 6, 4), generator=gen,
                           device=cuda_device).to(torch.float16),
               torch.randn((4, 128), generator=gen, device=cuda_device))
              for _ in range(8)]
    copy = copy_blocks_to_host_async(blocks, axis=axis)
    got = copy.wait()
    assert len(copy.events) == 1
    assert all(h.is_pinned() for h in copy.host)
    for f in range(2):
        want = torch.cat([b[f] for b in blocks], dim=axis).cpu().numpy()
        assert np.array_equal(got[f].view(np.uint8), want.view(np.uint8))


@pytest.mark.cuda
def test_aggregator_fused_tier_on_the_card_equals_the_cpu(cuda_device):
    """The Aggregator's fused tier (K = 2, kernel B2) on the card
    publishes the same windows as on the CPU, one launch per flush."""
    from kepler_tpu_torch.fleet.aggregator import Aggregator, _Stored
    from kepler_tpu_torch.parallel.fleet import NodeReport
    from kepler_tpu_torch.server.http import APIServer

    zones = ("package", "dram")

    def run(device):
        ticks = [1e9]
        agg = Aggregator(APIServer(), device=device, backend="pallas",
                         model_mode=None, fused_window_k=2, node_bucket=16,
                         workload_bucket=16, stale_after=1e9,
                         clock=lambda: ticks[0])
        agg.init()
        published = []
        publish = agg._publish
        agg._publish = lambda p: published.append(publish(p)) or \
            published[-1]
        for win in range(6):
            ticks[0] += 5.0
            rng = np.random.default_rng(win)
            for i in range(10 + win):
                cpu = rng.uniform(0.1, 5.0, 12).astype(np.float32)
                rep = NodeReport(
                    node_name=f"n{i}", zone_valid=np.ones(2, bool),
                    zone_deltas_uj=rng.uniform(1e7, 5e8, 2).astype(
                        np.float32),
                    usage_ratio=float(rng.uniform(0.2, 0.9)),
                    cpu_deltas=cpu,
                    workload_ids=[f"n{i}-w{k}" for k in range(12)],
                    node_cpu_delta=float(cpu.sum()), dt_s=5.0, mode=0,
                    workload_kinds=np.ones(12, np.int8))
                agg._reports[rep.node_name] = _Stored(
                    report=rep, zone_names=zones, received=ticks[0],
                    seq=win + 1, run="r1")
            agg.aggregate_once()
        assert agg.window_health()["rung_name"] == "packed-fused-scan"
        return published

    ref = run("cpu")
    before = ca.LAUNCHES["fused_window_step"]
    got = run(cuda_device)
    assert ca.LAUNCHES["fused_window_step"] - before == 3
    assert len(got) == len(ref) == 6
    for a, b in zip(got, ref):
        assert a.names == b.names
        assert np.array_equal(a._wl_watts_f16, b._wl_watts_f16)
        assert np.array_equal(a.node_joules_total, b.node_joules_total)


def stable_top_k(energies: np.ndarray, k: int, min_energy: float):
    """The reference selection rule in numpy: f32 compare, descending,
    lower index first among equal values."""
    masked = np.where(energies >= min_energy, energies.astype(np.float32),
                      np.float32(-np.inf))
    order = np.argsort(-masked, kind="stable")[:k]
    return order[masked[order] > -np.inf]


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,levels", [(500, 100, 3), (20_000, 500, 4),
                                        (1000, 999, 1)])
def test_top_k_on_the_card_takes_the_lower_index_among_ties(
        cuda_device, n, k, levels):
    from kepler_tpu_torch.ops.topk import top_k_by_energy

    rng = np.random.default_rng(n)
    energies = rng.integers(0, levels, n).astype(np.float64)
    energies[: n // 10] += 1e8 + rng.uniform(0, 4, n // 10)  # f32 ties
    want = stable_top_k(energies, k, 1.0)
    got = top_k_by_energy(energies, k, 1.0, device=cuda_device)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        top_k_by_energy(energies, k, 1.0, device="cpu"), want)


@pytest.mark.cuda
def test_monitor_on_the_card_equals_the_cpu_bit_for_bit(cuda_device,
                                                        tmp_path):
    """The node stack on two identical fake hosts, one monitor on the
    card and one on the CPU: every array of every snapshot is equal (each
    is one IEEE f32 operation per element in both)."""
    import chip_smoke as host

    clock = host.FakeClock()
    sides = []
    for side, dev in enumerate((cuda_device, "cpu")):
        monitor, _, _, proc, sysfs, pids = host.node_host(
            str(tmp_path / f"host-{side}"), dev, 400, 11, clock,
            max_terminated=30, min_terminated_energy_uj=0.0)
        sides.append((monitor, proc, sysfs, list(pids)))
    for tick in range(6):
        clock.t += 5.0
        for monitor, proc, sysfs, live in sides:
            if tick == 2:
                live += host.spawn_burst(proc, 90_000, 120)
            if tick == 3:
                host.kill_procs(proc, live[:100])
                del live[:100]
            host.advance_host(proc, sysfs, live, tick)
            monitor.refresh()
        got, ref = (host.node_state(s[0]._snapshot) for s in sides)
        host.same_state(got, ref, f"tick {tick}")
    assert len(ref["terminated_processes.ids"]) == 30


# -- estimators and training on the card ----------------------------------------

def seeded_family_params(family: str) -> dict:
    """Small params of ``family`` from a seeded generator, with non-zero
    output layers (the initialisers zero them)."""
    from kepler_tpu_torch.models import initializer

    gen = torch.Generator().manual_seed(3)
    kw = {"moe": dict(n_experts=3, hidden=16),
          "deep": dict(n_stages=2, d_model=16),
          "mlp": dict(hidden=16),
          "temporal": dict(d_model=16, t_max=8)}.get(family, {})
    p = initializer(family)(4, generator=gen, **kw)
    for k in ("w1", "w2", "w_head", "w_skip"):
        if k in p and not (family == "mlp" and k == "w1"):
            p[k] = torch.randn(p[k].shape, generator=gen) * 0.3
    return p


def family_batch(family: str, seed: int, n: int = 64, w: int = 32):
    gen = torch.Generator().manual_seed(seed)
    valid = torch.rand((n, w), generator=gen) > 0.25
    targets = torch.rand((n, w, 4), generator=gen) * 3.0
    label_valid = torch.rand((n, w, 4), generator=gen) > 0.2
    if family == "temporal":
        hist = torch.rand((n, w, 8, 7), generator=gen)
        tv = (torch.arange(8)[None, None, :]
              < torch.randint(0, 9, (n, w), generator=gen)[..., None])
        return (hist, valid, tv), targets, label_valid
    return (torch.rand((n, w, 7), generator=gen) * 4.0, valid), targets, \
        label_valid


@pytest.mark.cuda
def test_lstsq_min_norm_on_the_card_equals_the_cpu(cuda_device):
    """The SVD solve (``torch.linalg.lstsq`` on CUDA has only the
    full-rank driver) on rank-deficient and all-zero systems, batched:
    rtol 1e-4."""
    from kepler_tpu_torch.models.linear import (fit_linear_exact,
                                                lstsq_min_norm)

    gen = torch.Generator().manual_seed(4)
    a = torch.randn((3, 100_000, 7), generator=gen)
    a[1, :, 4] = a[1, :, 2] * 3.0
    a[2] = 0.0
    b = torch.randn((3, 100_000, 2), generator=gen)
    want = lstsq_min_norm(a, b)
    got = lstsq_min_norm(a.to(cuda_device), b.to(cuda_device)).cpu()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)
    assert not got[2].any()
    (feats, valid), targets, lv = family_batch("linear", 5)
    lv[..., 2] = False  # a zone with no labels
    for label_valid in (None, lv):
        ref = fit_linear_exact(feats, valid, targets, label_valid)
        out = fit_linear_exact(
            feats.to(cuda_device), valid.to(cuda_device),
            targets.to(cuda_device),
            None if label_valid is None else label_valid.to(cuda_device))
        torch.testing.assert_close(out["weight"].cpu(), ref["weight"],
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["moe", "deep"])
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
def test_moe_and_deep_on_the_card_match_the_cpu(cuda_device, family, cd):
    """f32 compute within rtol 1e-5 (atol 1e-5 · max|watts|); the bf16
    trunk within atol 1e-2 · max|watts|."""
    from kepler_tpu_torch.models.estimator import params_to, predictor

    params = seeded_family_params(family)
    (feats, valid), _, _ = family_batch(family, 6)
    fn = predictor(family)
    want = fn(params, feats, valid, compute_dtype=cd)
    got = fn(params_to(params, cuda_device), feats.to(cuda_device),
             valid.to(cuda_device), compute_dtype=cd).cpu()
    top = float(want.abs().max())
    assert top > 0.1
    if cd == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * top)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-2 * top)


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["linear", "mlp", "moe", "deep",
                                    "temporal"])
def test_train_steps_on_the_card_match_the_cpu(cuda_device, family):
    """Five AdamW steps at f32 compute: every loss within rtol 1e-4; a
    checkpoint saved on the card restores onto the CPU and the next step
    agrees there too."""
    import functools

    from kepler_tpu_torch.models import train
    from kepler_tpu_torch.models.checkpoint import TrainCheckpointer
    from kepler_tpu_torch.models.estimator import params_to, predictor

    args, targets, lv = family_batch(family, 7)
    if family == "temporal":
        step = train.make_temporal_train_step(torch.float32)
    else:
        fn = predictor(family)
        if family != "linear":
            fn = functools.partial(fn, compute_dtype=torch.float32)
        step = train.make_train_step(fn)
    losses = {}
    states = {}
    for dev in ("cpu", cuda_device):
        state = train.create_train_state(
            params_to(seeded_family_params(family), dev),
            train.make_optimizer(1e-2))
        put = [a.to(dev) for a in (*args, targets, lv)]
        out = []
        for _ in range(5):
            state, loss = step(state, *put)
            out.append(float(loss))
        losses[str(dev)] = out
        states[str(dev)] = state
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        ck = TrainCheckpointer(d)
        assert ck.save(states["cuda"])
        like = train.create_train_state(
            params_to(seeded_family_params(family), "cpu"),
            train.make_optimizer(1e-2))
        back = ck.restore_latest(like)
    assert back.step == 5
    for a, b in zip(train.param_leaves(back.params),
                    train.param_leaves(states["cuda"].params)):
        assert a.device.type == "cpu"
        assert torch.equal(a, b.detach().cpu())
    _, loss = step(back, *args, targets, lv)
    _, ref = step(states["cuda"], *[a.to(cuda_device)
                                    for a in (*args, targets, lv)])
    np.testing.assert_allclose(float(loss), float(ref), rtol=1e-4)


def sharded_rows(n: int, win: int, w: int = 40):
    """``n`` nodes' RowInputs for window ``win`` (mixed modes; the ids
    move every window, so every row restages)."""
    from kepler_tpu_torch.fleet.window import RowInput
    from kepler_tpu_torch.parallel.fleet import NodeReport

    zones = ("package", "core", "dram", "uncore")
    rng = np.random.default_rng(win)
    rows = []
    for i in range(n):
        cpu = rng.uniform(0.1, 5.0, w).astype(np.float32)
        rows.append(RowInput(
            name=f"n{i:03d}", zone_names=zones, ident=("r1", win),
            report=NodeReport(
                node_name=f"n{i:03d}", zone_valid=np.ones(4, bool),
                zone_deltas_uj=rng.uniform(1e7, 5e8, 4).astype(np.float32),
                usage_ratio=float(rng.uniform(0.2, 0.9)), cpu_deltas=cpu,
                workload_ids=[f"n{i}-w{k}" for k in range(w)],
                node_cpu_delta=float(cpu.sum()), dt_s=5.0, mode=i % 2,
                workload_kinds=np.ones(w, np.int8))))
    return rows, zones


@pytest.mark.cuda
@pytest.mark.parametrize("model_mode", [None, "mlp"])
def test_sharded_engine_on_8_virtual_shards_equals_the_cpu(cuda_device,
                                                           model_mode):
    """``ShardedWindowEngine`` over 8 virtual shards of the card with
    ``backend="pallas"``: B1 once per shard per window, every plane's
    ratio rows bit-equal to the same engine on ``device="cpu"``, model
    rows within rtol 1e-3, and the same sticky map."""
    from kepler_tpu_torch.fleet.window import (ShardedWindowEngine,
                                               fetch_plane)
    from kepler_tpu_torch.models.mlp import init_mlp
    from kepler_tpu_torch.parallel.mesh import make_mesh

    params = None
    if model_mode:
        gen = torch.Generator().manual_seed(3)
        params = init_mlp(4, generator=gen)
        params["w2"] = torch.randn(params["w2"].shape, generator=gen) * 0.05
    engines = {dev: ShardedWindowEngine(
        make_mesh([8], devices=[dev] * 8), backend="pallas",
        model_mode=model_mode, node_bucket=64, workload_bucket=64)
        for dev in ("cpu", cuda_device)}
    assert engines[cuda_device]._devices == [cuda_device] * 8
    for win, n in enumerate((50, 50, 47, 70)):  # drop, then overflow
        rows, zones = sharded_rows(n, win)
        planes = {}
        for dev, eng in engines.items():
            before = ca.LAUNCHES["outer_product_attribution"]
            plan = eng.plan_window(rows, zones, params)
            planes[dev] = (fetch_plane(eng.dispatch_window(plan)), plan)
            launched = ca.LAUNCHES["outer_product_attribution"] - before
            assert launched == (8 if dev == cuda_device else 0)
        (got, plan), (ref, ref_plan) = planes[cuda_device], planes["cpu"]
        assert plan.h2d_shards == ref_plan.h2d_shards
        assert engines[cuda_device]._shard_of == engines["cpu"]._shard_of
        ratio = plan.meta.mode != 1
        assert np.array_equal(got[ratio], ref[ratio])
        np.testing.assert_allclose(got[~ratio].astype(np.float32),
                                   ref[~ratio].astype(np.float32),
                                   rtol=1e-3, atol=1e-3)


# -- the parallel families on virtual shards of the card -------------------------

def card_mesh(dev, n: int, axes=("seq",), shape=None):
    from kepler_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(list(shape or [n]), list(axes), devices=[dev] * n)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 8])
def test_pallas_ring_launches_b3_tc_n_squared_times(cuda_device, n):
    """The ring at Tq = Tk = 128 a block, bf16: n² launches, all on
    tensor cores, against the einsum ring within B3's bound (1e-2 ·
    max|v|), and fully masked sequences exactly zero."""
    from kepler_tpu_torch.parallel.ring import make_ring_attention

    q, k, v, valid = attention_inputs(n, 6, 128 * n, 128 * n, 4, 32,
                                      cuda_device)
    before = dict(cat.LAUNCHES)
    got = make_ring_attention(card_mesh(cuda_device, n), backend="pallas")(
        q, k, v, valid)
    torch.cuda.synchronize()
    assert cat.LAUNCHES["flash_block_tc"] - before["flash_block_tc"] == n * n
    assert cat.LAUNCHES["flash_block"] - before["flash_block"] == n * n
    assert cat.LAUNCHES["flash_block_tiled"] == before["flash_block_tiled"]
    want = make_ring_attention(card_mesh(cuda_device, n))(q, k, v, valid)
    atol = 1e-2 * float(v.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=atol)
    assert torch.all(got[0] == 0)  # attention_inputs masks sequence 0


@pytest.mark.cuda
@pytest.mark.parametrize("n,cd", [(2, torch.bfloat16), (8, torch.float32)])
def test_pallas_ring_runs_long_and_f32_blocks_on_the_tiled_variant(
        cuda_device, n, cd):
    """The ring at T = 1024: 512-row blocks on 2 shards at bf16 and
    128-row blocks on 8 shards at f32 — n² launches of the tiled variant,
    none of the tensor-core one — against the einsum ring (f32: 1e-5;
    bf16: 1e-2 · max|v|)."""
    from kepler_tpu_torch.parallel.ring import make_ring_attention

    q, k, v, valid = attention_inputs(n + 40, 6, 1024, 1024, 4, 32,
                                      cuda_device)
    mesh = card_mesh(cuda_device, n)
    before = dict(cat.LAUNCHES)
    got = make_ring_attention(mesh, backend="pallas", compute_dtype=cd)(
        q, k, v, valid)
    torch.cuda.synchronize()
    assert cat.LAUNCHES["flash_block_tiled"] - before["flash_block_tiled"] \
        == n * n
    assert cat.LAUNCHES["flash_block_tc"] == before["flash_block_tc"]
    want = make_ring_attention(mesh, compute_dtype=cd)(q, k, v, valid)
    if cd == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-2 * float(v.abs().max()))
    assert torch.all(got[0] == 0)


@pytest.mark.cuda
def test_flash_block_refuses_autograd_on_the_card(cuda_device):
    q, k, v, valid = attention_inputs(3, 2, 16, 16, 4, 32, cuda_device)
    before = dict(cat.LAUNCHES)
    with pytest.raises(ValueError, match="no backward"):
        cat.flash_block_pallas(q.requires_grad_(True), k, v, valid, 0, 0)
    assert cat.LAUNCHES == before
    with torch.no_grad():
        cat.flash_block_pallas(q, k, v, valid, 0, 0)
    assert cat.LAUNCHES["flash_block"] == before["flash_block"] + 1


@pytest.mark.cuda
def test_parallel_families_on_the_card_match_the_cpu(cuda_device):
    """Each family on virtual shards of the card against the same family
    on ``cpu`` shards, at f32 compute: rtol 1e-4, atol 1e-5 · max|out|
    (summation order only); the trainer's five losses rtol 1e-4."""
    from kepler_tpu_torch.models import train
    from kepler_tpu_torch.models.deep import init_deep
    from kepler_tpu_torch.models.estimator import params_to
    from kepler_tpu_torch.models.mlp import init_mlp
    from kepler_tpu_torch.models.moe import init_moe
    from kepler_tpu_torch.models.temporal import init_temporal
    from kepler_tpu_torch.parallel import (gather_params,
                                           make_distributed_train_step,
                                           make_expert_parallel_moe,
                                           make_pipelined_deep,
                                           make_sequence_parallel_train_step,
                                           make_temporal_program,
                                           make_ulysses_temporal_program,
                                           shard_train_state, top1_route)

    f32 = torch.float32
    gen = torch.Generator().manual_seed(9)
    tp = init_temporal(4, d_model=32, t_max=64, generator=gen)
    tp["w_head"] = torch.randn((32, 4), generator=gen) * 0.2
    hist = torch.rand((6, 64, 7), generator=gen)
    wv = torch.tensor([True] * 5 + [False])
    tv = torch.arange(64)[None, :] < torch.tensor([64, 9, 33, 1, 0, 64])[:, None]
    targets = torch.rand((6, 4), generator=gen) * 30
    mp = init_moe(4, n_experts=8, hidden=32, generator=gen)
    mp["w1"] = torch.randn(mp["w1"].shape, generator=gen) * 0.3
    rows = torch.rand((64, 7), generator=gen)
    dp = init_deep(4, n_stages=4, d_model=32, generator=gen)
    dp["w_head"] = torch.randn(dp["w_head"].shape, generator=gen) * 0.2
    lp = init_mlp(4, hidden=32, generator=gen)
    lp["w2"] = torch.randn(lp["w2"].shape, generator=gen) * 0.3
    feats = torch.rand((16, 8, 7), generator=gen)
    fvalid = torch.rand((16, 8), generator=gen) > 0.3
    ftargets = torch.rand((16, 8, 4), generator=gen) * 10

    def run(dev):
        put = lambda *xs: [x.to(dev) for x in xs]  # noqa: E731
        out = {}
        out["sequence"] = make_temporal_program(
            card_mesh(dev, 8), compute_dtype=f32)(
            params_to(tp, dev), *put(hist, wv, tv))
        out["ulysses"] = make_ulysses_temporal_program(
            card_mesh(dev, 4), compute_dtype=f32)(
            params_to(tp, dev), *put(hist, wv, tv))
        state = train.create_train_state(params_to(tp, dev),
                                         train.make_optimizer(1e-3))
        step = make_sequence_parallel_train_step(card_mesh(dev, 8),
                                                 remat=True)
        losses = []
        for _ in range(3):
            state, loss = step(state, *put(hist, wv, tv, targets))
            losses.append(float(loss))
        out["sp_losses"] = torch.tensor(losses)
        ep = make_expert_parallel_moe(card_mesh(dev, 8, ("expert",)),
                                      compute_dtype=f32)
        eid, prob = top1_route(params_to(mp, dev), rows.to(dev))
        out["expert"] = ep(params_to(mp, dev), rows.to(dev), eid, prob)
        out["pipeline"] = make_pipelined_deep(
            card_mesh(dev, 4, ("stage",)), compute_dtype=f32)(
            params_to(dp, dev), *put(rows[:, None].expand(64, 2, 7)
                                     .reshape(128, 7), torch.ones(128,
                                                                  dtype=torch.bool)))
        mesh = card_mesh(dev, 8, ("node", "model"), (4, 2))
        sstate = shard_train_state(train.create_train_state(
            params_to(lp, dev), train.make_optimizer(1e-2)), mesh)
        tstep = make_distributed_train_step(mesh, compute_dtype=f32)
        losses = []
        for _ in range(5):
            sstate, loss = tstep(sstate, *put(feats, fvalid, ftargets))
            losses.append(float(loss))
        out["trainer_losses"] = torch.tensor(losses)
        out["trainer_w1"] = gather_params(sstate)["w1"]
        return {k: v.detach().cpu() for k, v in out.items()}

    got, want = run(cuda_device), run("cpu")
    for key, ref in want.items():
        rtol = 1e-4
        atol = 1e-5 * float(ref.abs().max())
        if key == "trainer_w1":
            atol = max(atol, 1e-6)
        torch.testing.assert_close(got[key], ref, rtol=rtol, atol=atol,
                                   msg=key)


def dist_worker():
    """``tests/torch_dist_worker.py``, loaded by path: the card's machine
    may have another package named tests."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).with_name("torch_dist_worker.py")
    spec = importlib.util.spec_from_file_location("torch_dist_worker", path)
    worker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(worker)
    return worker


def nccl_spawn(worker, suite: str, layout: str, inputs, tmp_path
               ) -> list[dict]:
    """``suite`` on two NCCL ranks of the card: if NCCL refuses two ranks
    on one device ("Duplicate GPU detected"), again with a host id each
    (``NCCL_HOSTID``), which NCCL takes."""
    ranks = worker.spawn(suite, layout, inputs, tmp_path)
    if "error" in ranks[0]:
        for out in ranks:
            assert "Duplicate GPU" in str(out["error"]), str(out["error"])
        ranks = worker.spawn(suite, layout, inputs, tmp_path, host_ids=True)
    for out in ranks:
        assert "error" not in out, str(out.get("error"))
    return ranks


@pytest.mark.cuda
def test_ring_across_two_nccl_ranks_on_the_card(cuda_device, tmp_path):
    """Two ranks share the card (``tests/torch_dist_worker.py``, each
    spawn under its own 60 s limit), each launching B3 for its 4 of the
    pallas ring's 8 shards, the KV hops between them over NCCL. NCCL may
    refuse two ranks on one device; its words are then the result of the
    first spawn ("Duplicate GPU detected"), and the ranks run again with
    a host id each (``NCCL_HOSTID``), which NCCL takes. Either way, both
    ranks' outputs equal the one-process ring's on the card bit for bit,
    and each rank made 32 tensor-core launches."""
    worker = dist_worker()
    rng = np.random.default_rng(41)
    q, k, v = (rng.normal(size=(4, 128, 4, 32)).astype(np.float32)
               for _ in range(3))
    valid = np.arange(128)[None, :] < np.array([128, 70, 0, 9])[:, None]
    arrays = {"ring/q": q, "ring/k": k, "ring/v": v, "ring/tv": valid}
    np.savez(tmp_path / "in.npz", **arrays)
    want = worker.run_ring_cuda(arrays, None)["ring"]
    for out in nccl_spawn(worker, "ring_cuda", "blocks", tmp_path / "in.npz",
                          tmp_path):
        assert int(out["launches/flash_block"]) == 32
        assert int(out["launches/flash_block_tc"]) == 32
        np.testing.assert_array_equal(out["ring"], want)


@pytest.mark.cuda
def test_pipeline_and_experts_across_two_nccl_ranks_on_the_card(
        cuda_device, tmp_path):
    """Two ranks share the card, shard k of each 8-shard mesh on rank
    k % 2 (every pipeline hop crosses): the pipelined deep estimator (f32)
    and expert parallelism (explicit ids, f32), the hops, the broadcast
    of the last stage's output, the all-to-alls and the all-gather of the
    row blocks over NCCL. Both ranks' outputs equal the one-process mesh's
    on the card bit for bit."""
    from kepler_tpu_torch.models.deep import init_deep
    from kepler_tpu_torch.models.moe import init_moe

    worker = dist_worker()
    gen = torch.Generator().manual_seed(43)
    rng = np.random.default_rng(43)
    arrays = {}
    for key, val in init_deep(2, n_stages=8, d_model=32,
                              generator=gen).items():
        if key == "blocks":
            arrays.update({f"pp/blocks/{k}": v.numpy()
                           for k, v in val.items()})
        else:
            arrays[f"pp/{key}"] = val.numpy()
    arrays.update({f"ep/{k}": v.numpy() for k, v in init_moe(
        2, n_experts=8, hidden=32, generator=gen).items()})
    # non-zero heads: the initialisers zero them
    for key, scale in (("pp/w_head", 0.2), ("pp/w_skip", 0.2),
                       ("ep/w1", 0.3), ("ep/w_skip", 0.2)):
        arrays[key] = rng.normal(0, scale, arrays[key].shape).astype(
            np.float32)
    arrays["pp_in/feats"] = rng.uniform(0, 2, (24, 7)).astype(np.float32)
    arrays["pp_in/valid"] = np.arange(24) % 5 != 0
    arrays["ep_in/feats"] = rng.uniform(0, 2, (64, 7)).astype(np.float32)
    arrays["ep_in/eid"] = (np.arange(64) * 7 % 8).astype(np.int32)
    np.savez(tmp_path / "in.npz", **arrays)
    want = worker.run_stages_cuda(arrays, None)
    assert np.abs(want["deep_f32"]).max() > 0
    for out in nccl_spawn(worker, "stages_cuda", "interleaved",
                          tmp_path / "in.npz", tmp_path):
        for key in ("deep_f32", "expert_explicit_f32"):
            np.testing.assert_array_equal(out[key], want[key], err_msg=key)
        for name in ("ppermute", "broadcast", "all_to_all", "all_gather"):
            assert int(out[f"crossing/{name}/calls"]) > 0, name


# -- the half-operand product on tensor cores ------------------------------

def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 unit in the last place at ``|x|`` (8 significant bits)."""
    _, exp = torch.frexp(x.abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(x), exp - 8)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(10_000, 128), (10_000, 4), (999, 512),
                                   (655, 4, 16), (1001, 7), (3, 5)])
def test_hi_lo_kernel_equals_plain(cuda_device, shape):
    """The pair's kernel equals its plain version bit for bit, on every
    path (8 and 4 elements a thread, one element) and with infinities,
    zeros of both signs and an unaligned ``g``."""
    from kepler_tpu_torch.ops import hi_lo as hl

    gen = torch.Generator().manual_seed(17)
    g = (torch.randn(shape, generator=gen)
         * torch.exp(5 * torch.randn(shape, generator=gen)))
    g.view(-1)[:3] = torch.tensor([float("inf"), 0.0, -0.0])
    g = g.to(cuda_device)
    before = hl.LAUNCHES["hi_lo"]
    got = hl.hi_lo(g, torch.bfloat16)
    assert hl.LAUNCHES["hi_lo"] == before + 1
    want = hl.hi_lo_ref(g, torch.bfloat16)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    flat = torch.cat([torch.zeros(1, device=cuda_device),
                      g.reshape(-1)])[1:].view(shape)  # 4-byte offset
    assert torch.equal(hl.hi_lo(flat, torch.bfloat16).view(torch.int16),
                       want.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mlp_hidden", "mlp_out", "temporal_kv",
                                  "temporal_scores", "temporal_values"])
def test_acc_matmul_on_tensor_cores_matches_plain(cuda_device, case):
    """The card's route at bf16 against the plain route (``round_to`` and
    an f32 product, TF32 off) on the card, at the refits' shapes: the
    forward to f32 summation error; every gradient bf16-valued and within
    one bf16 ulp, plus what the hi/lo pair (2⁻¹⁷ of the incoming gradient)
    and f32 sums may move a sum that cancels."""
    from kepler_tpu_torch.device import resolve_device
    from kepler_tpu_torch.models import nn, temporal
    from kepler_tpu_torch.ops.attention import round_to

    dev = resolve_device(cuda_device)
    bf = torch.bfloat16
    shapes = {"mlp_hidden": ((20_000, 128), (128, 128)),
              "mlp_out": ((20_000, 128), (128, 4)),
              "temporal_kv": ((2_000 * 16, 128), (128, 128)),
              "temporal_scores": ((2_000, 4, 32), (2_000, 16, 4, 32)),
              "temporal_values": ((2_000, 4, 16), (2_000, 16, 4, 32))}
    run = {"temporal_scores": temporal._query_scores,
           "temporal_values": temporal._weighted_values}.get(
               case, nn.acc_matmul)
    sa, sb = shapes[case]
    k = sa[-1] if run is nn.acc_matmul else sb[-1] * sb[-2]
    gen = torch.Generator().manual_seed(23)
    a = torch.randn(sa, generator=gen).to(dev).requires_grad_()
    b = (torch.randn(sb, generator=gen) / sb[-2] ** 0.5).to(
        dev).requires_grad_()
    g = (torch.randn(run(a, b, bf).shape, generator=gen) * 3).to(dev)
    from kepler_tpu_torch.ops import hi_lo as hl

    before = hl.LAUNCHES["hi_lo"]
    got = run(a, b, bf)
    grads = torch.autograd.grad(got, (a, b), g)
    assert hl.LAUNCHES["hi_lo"] == before + 1  # the route ran
    # the plain route: a bf16 compute dtype off the card's route
    plain = {"temporal_scores": lambda q, kk, cd: torch.einsum(
                 "bhd,bthd->bht", round_to(q, cd), round_to(kk, cd)),
             "temporal_values": lambda p, v, cd: torch.einsum(
                 "bht,bthd->bhd", round_to(p, cd),
                 round_to(v, cd)).reshape(p.shape[0], -1)}.get(
                     case, lambda x, y, cd: torch.matmul(round_to(x, cd),
                                                         round_to(y, cd)))
    want = plain(a, b, bf)
    wants = torch.autograd.grad(want, (a, b), g)
    ar, br = round_to(a, bf).detach(), round_to(b, bf).detach()
    abs_a, abs_b = ar.abs().requires_grad_(), br.abs().requires_grad_()
    mag = plain(abs_a, abs_b, torch.float32)
    assert (got - want).abs().le(k * 2.0 ** -23 * mag + 1e-30).all()
    spread = torch.autograd.grad(mag, (abs_a, abs_b), g.abs())
    for got_g, want_g, room in zip(grads, wants, spread):
        assert torch.equal(got_g, got_g.to(bf).float())
        diff = (got_g - want_g).abs()
        limit = (bf16_ulp(torch.maximum(got_g.abs(), want_g.abs()))
                 + (2.0 ** -16 + k * 2.0 ** -23) * room)
        assert diff.le(limit).all(), float((diff - limit).max())
        assert diff.le(bf16_ulp(want_g.abs())).float().mean() > 0.99


class _Products(torch.utils._python_dispatch.TorchDispatchMode):
    """Every matrix product a block dispatches: (op, operand dtypes,
    operand shapes, result dtype), its backward included."""

    OPS = ("mm", "bmm", "addmm", "baddbmm", "addbmm", "dot", "mv")

    def __init__(self) -> None:
        super().__init__()
        self.seen: list[tuple] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name in self.OPS:
            ins = [t for t in args if isinstance(t, torch.Tensor)]
            self.seen.append((name, tuple(t.dtype for t in ins),
                              tuple(tuple(t.shape) for t in ins), out.dtype))
        return out


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["mlp", "temporal"])
@pytest.mark.parametrize("cd", [torch.bfloat16, torch.float32])
def test_refit_step_runs_bf16_products_on_tensor_cores(cuda_device, family,
                                                       cd):
    """One refit step of each family at a small size. At bf16 every
    product with f32 operands is one the model keeps in f32 or an edge
    that keeps the plain route (a 7-wide feature side, the 4-wide head and
    skip path), every bf16 product gives an f32 result, and the step's
    kernels hold no more f32 GEMMs (``f32f32``, ``sgemm``) than those
    products; accuracy mode (f32) takes no bf16 product at all."""
    import functools

    from torch.profiler import ProfilerActivity, profile

    from kepler_tpu_torch.device import resolve_device
    from kepler_tpu_torch.models import mlp, temporal, train

    dev = resolve_device(cuda_device)
    gen = torch.Generator().manual_seed(29)
    if family == "mlp":
        params = mlp.init_mlp(4, generator=gen)
        params["w2"] = torch.randn(128, 4, generator=gen) * 0.1
        args = (torch.rand(4096, 100, 7, generator=gen),
                torch.rand(4096, 100, generator=gen) < 0.5)
        step = train.make_train_step(
            functools.partial(mlp.predict_mlp, compute_dtype=cd))
    else:
        params = temporal.init_temporal(4, generator=gen)
        params["w_head"] = torch.randn(128, 4, generator=gen) * 0.1
        args = (torch.rand(256, 100, 16, 7, generator=gen),
                torch.rand(256, 100, generator=gen) < 0.5,
                torch.rand(256, 100, 16, generator=gen) < 0.9)
        step = train.make_temporal_train_step(cd)
    targets = torch.rand(*args[1].shape, 4, generator=gen) * 5
    put = [a.to(dev) for a in (*args, targets)]
    state = train.create_train_state(
        {k: v.to(dev) for k, v in params.items()}, train.make_optimizer())
    state, _ = step(state, *put)  # builds and warms what the step runs
    torch.cuda.synchronize()
    rec = _Products()
    with profile(activities=[ProfilerActivity.CUDA]) as prof, rec:
        state, _ = step(state, *put)
        torch.cuda.synchronize()
    f32 = [p for p in rec.seen if set(p[1]) == {torch.float32}]
    half = [p for p in rec.seen if torch.bfloat16 in p[1]]
    if cd == torch.float32:
        assert not half and f32
        return
    assert half and all(p[3] == torch.float32 for p in half), half
    for p in f32:
        assert any(d in (4, 7) for shape in p[2] for d in shape), p
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    sgemm = [n for n in kernels if "f32f32" in n or "sgemm" in n]
    assert len(sgemm) <= len(f32), (sgemm, f32)
    assert any("hi_lo" in n for n in kernels)


@pytest.mark.cuda
def test_device_tier_records_one_program_on_the_card_and_the_cpu(
        cuda_device):
    """Every registered device program's fingerprint on the card equals
    the CPU's, whose bf16 products take the card's route
    (``models.nn.card_route``): the same casts, one product
    op a product and ``kernel:hi_lo`` a split; on the card the train
    step's entry launches the split."""
    from kepler_tpu_torch.analysis.device import DEVICE_PROGRAMS
    from kepler_tpu_torch.analysis.device.trace import (fingerprint,
                                                        trace_case)
    from kepler_tpu_torch.ops import hi_lo as hl

    before = hl.LAUNCHES["hi_lo"]
    for spec in DEVICE_PROGRAMS:
        for case in spec.cases:
            card = fingerprint(trace_case(spec, case, cuda_device))
            cpu = fingerprint(trace_case(spec, case, "cpu"))
            assert card == cpu, (spec.name, case.name, {
                k: (card[k], cpu[k]) for k in card if card[k] != cpu[k]})
            if spec.name == "trainer.train_step":
                assert card["ops"]["kernel:hi_lo"] > 0
    assert hl.LAUNCHES["hi_lo"] > before
