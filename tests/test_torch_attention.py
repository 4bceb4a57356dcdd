"""The port's attention primitives and kernel B3's wrappers against the
JAX package's.

Inputs are seeded numpy arrays handed to both packages. JAX's Pallas
kernel runs as its own tests run it on the CPU (interpret mode); the
port's wrappers take their plain versions for CPU tensors. Tolerances:

- f32 compute: rtol = atol = 1e-5 (summation order only);
- bf16 compute: ``m`` and ``l`` rtol = atol = 1e-5, ``pv`` and
  attention outputs within 1e-2 · max|v| (one bf16 rounding of ``p`` may
  flip between the two).

The block plan (which variant, tensor-core or KV-tiled, and its
blocking) and cost model that the CUDA wrapper uses are checked here too;
the kernels themselves run only on the card
(``tests/test_torch_cuda.py``). The plan takes every block JAX's kernel
takes (any Tq, Tk and D), and at the blocks the card's first kernels
refused (Tq > 256, Tk of a thousand, D of 12, 128 or above 256) the port
still agrees with JAX's interpret-mode kernel.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kepler_tpu.ops import attention as jatt
from kepler_tpu.ops import pallas_attention as jpal
from kepler_tpu_torch.ops import attention as tatt
from kepler_tpu_torch.ops import cuda_attention as tcat

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def qkv(seed: int, b: int, tq: int, tk: int, h: int = 4, d: int = 16):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, tq, h, d)).astype(np.float32),
            rng.normal(size=(b, tk, h, d)).astype(np.float32),
            rng.normal(size=(b, tk, h, d)).astype(np.float32))


def ragged_valid(seed: int, b: int, t: int) -> np.ndarray:
    """Right-padded lengths 0..t (row 0 empty, row 1 full) plus one
    gapped row."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, t + 1, b)
    lengths[0], lengths[1] = 0, t
    valid = np.arange(t)[None, :] < lengths[:, None]
    if b > 2:
        valid[2] = rng.random(t) > 0.5
    return valid


def to_t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def assert_partials(got, want, v: np.ndarray, cd: str) -> None:
    pv, m, l = (np.asarray(x) for x in got)
    pv_r, m_r, l_r = (np.asarray(x) for x in want)
    np.testing.assert_allclose(m, m_r, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(l, l_r, rtol=1e-5, atol=1e-5)
    if cd == "f32":
        np.testing.assert_allclose(pv, pv_r, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(pv, pv_r, rtol=0,
                                   atol=1e-2 * np.abs(v).max())


@pytest.mark.parametrize("cd", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_block_attn_matches_jax(cd, causal):
    q, k, v = qkv(1, 3, 12, 12)
    valid = ragged_valid(2, 3, 12)
    mask = valid[:, None, None, :]
    if causal:
        mask = mask & (np.arange(12)[:, None] >= np.arange(12)[None, :])
    jcd, tcd = DTYPES[cd]
    want = jatt.block_attn(*(jnp.asarray(x) for x in (q, k, v, mask)),
                           0.25, jcd)
    got = tatt.block_attn(*to_t(q, k, v, mask), 0.25, tcd)
    assert all(x.dtype == torch.float32 for x in got)
    assert_partials([x.numpy() for x in got], want, v, cd)


@pytest.mark.parametrize("cd", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_full_attention_matches_jax(cd, causal):
    q, k, v = qkv(3, 4, 16, 16)
    valid = ragged_valid(4, 4, 16)
    jcd, tcd = DTYPES[cd]
    want = np.asarray(jatt.full_attention(
        *(jnp.asarray(x) for x in (q, k, v)), causal=causal,
        t_valid=jnp.asarray(valid), compute_dtype=jcd))
    got = tatt.full_attention(*to_t(q, k, v), causal=causal,
                              t_valid=torch.from_numpy(valid),
                              compute_dtype=tcd).numpy()
    tol = 1e-5 if cd == "f32" else 1e-2 * np.abs(v).max()
    np.testing.assert_allclose(got, want, rtol=1e-5 if cd == "f32" else 0,
                               atol=tol)
    # the fully masked row gives exact zeros, not NaN
    assert np.all(got[0] == 0.0)


def test_merge_blocks_folds_two_halves_into_the_whole():
    """Two KV halves merged with merge_blocks equal one block over all of
    them, as in JAX."""
    q, k, v = qkv(5, 2, 8, 8)
    mask = np.ones((2, 1, 8, 8), bool)
    tq, tk, tv, tmask = to_t(q, k, v, mask)
    whole = tatt.block_attn(tq, tk, tv, tmask, 0.25, torch.float32)
    a = tatt.block_attn(tq, tk[:, :4], tv[:, :4], tmask[..., :4], 0.25,
                        torch.float32)
    b = tatt.block_attn(tq, tk[:, 4:], tv[:, 4:], tmask[..., 4:], 0.25,
                        torch.float32)
    o, m, l = tatt.merge_blocks(a[0], a[1], a[2], *b)
    np.testing.assert_allclose(o.numpy(), whole[0].numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(l.numpy(), whole[2].numpy(), rtol=1e-5)
    jo, jm, jl = jatt.merge_blocks(*(jnp.asarray(x.numpy())
                                     for x in (a[0], a[1], a[2], *b)))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(
        tatt.stats_to_out(l).numpy(),
        np.asarray(jatt.stats_to_out(jnp.asarray(l.numpy()))))


FLASH_CASES = {
    # (b, tq, tk, q_start, kv_start)
    "square": (3, 16, 16, 0, 0),
    "tq_lt_tk": (2, 8, 20, 0, 0),
    "tq_gt_tk": (2, 20, 8, 0, 0),
    "kv_after_q": (1, 8, 8, 0, 8),
    "kv_before_q": (1, 8, 8, 8, 0),
    "partial_overlap": (2, 8, 8, 4, 2),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
@pytest.mark.parametrize("cd", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_block_matches_jax_pallas(case, cd, causal):
    b, tq, tk, q_start, kv_start = FLASH_CASES[case]
    q, k, v = qkv(b * tq + tk, b, tq, tk)
    valid = ragged_valid(tk, b, tk) if b > 1 else np.ones((1, tk), bool)
    jcd, tcd = DTYPES[cd]
    want = jpal.flash_block_pallas(
        *(jnp.asarray(x) for x in (q, k, v, valid)), q_start, kv_start,
        causal=causal, compute_dtype=jcd)
    before = tcat.LAUNCHES["flash_block"]
    got = tcat.flash_block_pallas(*to_t(q, k, v, valid), q_start, kv_start,
                                  causal=causal, compute_dtype=tcd)
    assert tcat.LAUNCHES["flash_block"] == before  # CPU: plain version
    assert [tuple(x.shape) for x in got] == [(b, tq, 4, 16), (b, 4, tq),
                                             (b, 4, tq)]
    assert_partials([x.numpy() for x in got], want, v, cd)
    if case == "kv_after_q" and causal:
        assert np.all(got[2].numpy() == 0.0)  # nothing attendable
        assert np.all(got[1].numpy() == np.float32(-1e30))
        assert np.all(got[0].numpy() == 0.0)
    if case == "kv_before_q":
        assert np.all(got[2].numpy() > 0.0)  # everything attendable


def test_flash_block_takes_float_kv_valid():
    """kv_valid may be a float mask (> 0.5 is valid), as in JAX."""
    q, k, v = qkv(7, 2, 6, 6)
    valid = ragged_valid(8, 2, 6)
    a = tcat.flash_block_pallas(*to_t(q, k, v, valid), 0, 0)
    b = tcat.flash_block_pallas(*to_t(q, k, v), torch.from_numpy(
        valid.astype(np.float32)), 0, 0)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("cd", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_full_attention_pallas_matches_jax_and_dense(cd, causal):
    q, k, v = qkv(9, 3, 16, 16)
    valid = ragged_valid(10, 3, 16)
    jcd, tcd = DTYPES[cd]
    want = np.asarray(jpal.full_attention_pallas(
        *(jnp.asarray(x) for x in (q, k, v, valid)), causal=causal,
        compute_dtype=jcd))
    got = tcat.full_attention_pallas(*to_t(q, k, v, valid), causal=causal,
                                     compute_dtype=tcd).numpy()
    tol = 1e-5 if cd == "f32" else 1e-2 * np.abs(v).max()
    np.testing.assert_allclose(got, want, rtol=1e-5 if cd == "f32" else 0,
                               atol=tol)
    dense = tatt.full_attention(*to_t(q, k, v), causal=causal,
                                t_valid=torch.from_numpy(valid),
                                compute_dtype=tcd).numpy()
    np.testing.assert_allclose(got, dense, rtol=1e-5 if cd == "f32" else 0,
                               atol=tol)
    fn = tcat.pallas_attention_fn(causal=causal, compute_dtype=tcd)
    assert torch.equal(fn(*to_t(q, k, v, valid)),
                       torch.from_numpy(got))
    # no t_valid: every key valid
    np.testing.assert_allclose(
        tcat.full_attention_pallas(*to_t(q, k, v), causal=causal,
                                   compute_dtype=tcd).numpy(),
        np.asarray(jpal.full_attention_pallas(
            *(jnp.asarray(x) for x in (q, k, v)), causal=causal,
            compute_dtype=jcd)), rtol=1e-5 if cd == "f32" else 0, atol=tol)


BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("b,tq,tk,h,d,cd,contiguous,want", [
    # the temporal trunk's serving shape: tensor cores, 2 sequences × all
    # 4 heads an item, bulk copies
    (262144, 16, 16, 4, 32, BF16, True, ("tc", 2, 4, 256, True)),
    # T = t_max: one (sequence, head) an item, 8 warps
    (16384, 128, 128, 4, 32, BF16, True, ("tc", 1, 1, 256, False)),
    (4, 32, 32, 2, 64, BF16, True, ("tc", 1, 2, 128, True)),
    (5, 64, 64, 4, 16, BF16, True, ("tc", 2, 1, 256, False)),
    (3, 128, 128, 4, 64, BF16, True, ("tc", 1, 1, 256, False)),
    # a strided view: one head an item, cp.async copies
    (6, 16, 16, 4, 32, BF16, False, ("tc", 6, 1, 192, False)),
    (9, 16, 16, 4, 32, BF16, False, ("tc", 8, 1, 256, False)),
    (2, 16, 16, 4, 32, BF16, True, ("tc", 2, 4, 256, True)),
    (1, 16, 16, 4, 32, BF16, True, ("tc", 1, 4, 128, True)),
    # f32 compute and the shapes tensor cores do not take: KV-tiled,
    # (variant, g, hb, threads, bulk, padded D, query rows, KV tile keys,
    # path)
    (262144, 16, 16, 4, 32, F32, True,
     ("tiled", 2, 1, 64, False, 32, 16, 16, "one-pass")),
    (16384, 128, 128, 4, 32, F32, True,
     ("tiled", 1, 1, 256, False, 32, 128, 128, "one-pass")),
    (5, 9, 13, 4, 16, BF16, True,
     ("tiled", 4, 1, 128, False, 16, 16, 16, "one-pass")),
    (4, 32, 20, 2, 64, BF16, True,
     ("tiled", 1, 1, 64, False, 64, 32, 32, "one-pass")),
    (2, 256, 256, 4, 8, BF16, True,
     ("tiled", 1, 1, 256, False, 16, 128, 256, "resident")),
    (1, 1, 1, 1, 8, BF16, True,
     ("tiled", 1, 1, 32, False, 16, 16, 16, "one-pass")),
    (2, 144, 144, 4, 32, BF16, True,
     ("tiled", 1, 1, 256, False, 32, 128, 144, "resident")),
    # the one-pass boundary at DP 32: 128 visible keys in one tile, 144
    # streamed in 64-key tiles (f32) or resident (bf16)
    (4, 128, 128, 4, 32, F32, True,
     ("tiled", 1, 1, 256, False, 32, 128, 128, "one-pass")),
    (4, 128, 144, 4, 32, F32, True,
     ("tiled", 1, 1, 256, False, 32, 128, 64, "two-pass")),
    (4, 96, 128, 4, 32, BF16, True,
     ("tiled", 1, 1, 192, False, 32, 96, 128, "one-pass")),
    (4, 128, 144, 4, 32, BF16, True,
     ("tiled", 1, 1, 256, False, 32, 128, 144, "resident")),
    # D above 256: the wide path, one warp a block, D in chunks of 64
    # columns; one KV tile of Tk rounded up to 16 keys up to 64 keys (one
    # pass: T = 16, Tq = Tk = 48), else tiles of 64 (two passes)
    (4, 48, 48, 2, 320, F32, True,
     ("tiled", 1, 1, 32, False, 320, 16, 48, "wide")),
    (4, 16, 16, 4, 1000, BF16, True,
     ("tiled", 1, 1, 32, False, 1024, 16, 16, "wide")),
    (4096, 16, 16, 4, 512, BF16, True,
     ("tiled", 1, 1, 32, False, 512, 16, 16, "wide")),
    (4096, 16, 16, 4, 512, F32, True,
     ("tiled", 1, 1, 32, False, 512, 16, 16, "wide")),
    (4096, 16, 16, 4, 320, F32, False,
     ("tiled", 1, 1, 32, False, 320, 16, 16, "wide")),
    (4, 48, 48, 2, 512, BF16, True,
     ("tiled", 1, 1, 32, False, 512, 16, 48, "wide")),
    (4, 48, 48, 2, 1000, F32, True,
     ("tiled", 1, 1, 32, False, 1024, 16, 48, "wide")),
    (4, 16, 100, 2, 320, BF16, True,
     ("tiled", 1, 1, 32, False, 320, 16, 64, "wide")),
    (4, 20, 65, 2, 512, F32, True,
     ("tiled", 1, 1, 32, False, 512, 16, 64, "wide")),
    (2, 512, 512, 4, 1000, BF16, True,
     ("tiled", 1, 1, 32, False, 1024, 16, 64, "wide")),
    # D = 128 at T = 16 (the d_model-512 trunk): f32 packs sequences to
    # MAX_SMEM, bf16 takes one an item
    (65536, 16, 16, 4, 128, F32, True,
     ("tiled", 4, 1, 128, False, 128, 16, 16, "one-pass")),
    (65536, 16, 16, 4, 128, BF16, True,
     ("tiled", 1, 1, 32, False, 128, 16, 16, "one-pass")),
])
def test_flash_block_plan_fits_the_kernel(b, tq, tk, h, d, cd, contiguous,
                                          want):
    plan = tcat.flash_block_plan(b, tq, tk, h, d, cd, contiguous)
    got = (plan.variant, plan.g, plan.hb, plan.threads, plan.bulk, plan.dp,
           plan.qr, plan.tk, plan.path)
    assert got[:len(want)] == want
    assert h % plan.hb == 0 and plan.threads <= tcat.MAX_THREADS
    assert plan.smem <= tcat.MAX_SMEM
    assert tcat.takes_tensor_cores(tq, tk, d, cd) == (plan.variant == "tc")
    if plan.variant == "tc":
        # a stage holds q, k, v of g sequences × hb heads, rows padded
        # by 4 floats unless bulk copies land them; two stages
        assert plan.smem == tcat.tc_smem_bytes(plan.g, plan.hb, tq, d,
                                               plan.bulk)
        row = plan.hb * d if plan.bulk else d + 4
        assert plan.smem == 2 * (3 * 4 * plan.g * tq * row + 8)
        assert plan.threads == 32 * plan.g * plan.hb * tq // 16
        assert not plan.bulk or plan.hb == h
        return
    assert not plan.bulk and plan.hb == 1
    if plan.path == "resident":
        # bf16 K and V rows of dp + 8 values, Tk rounded up to 16, the
        # visibility bits, 8 ints and the next item's validity bytes; 8
        # warps walk the q rows
        assert cd == BF16 and plan.dp in tcat.RESIDENT_DIMS
        assert plan.tk == (tk + 15) // 16 * 16 and tk > 128
        assert plan.smem == tcat.resident_smem_bytes(plan.tk, plan.dp)
        assert plan.smem == (4 * plan.tk * (plan.dp + 8)
                             + 4 * -(-plan.tk // 32) + 32 + plan.tk)
        assert plan.threads == 256 and plan.g == 1
        return
    if plan.path == "wide":
        # one warp a block: three stages of a 64-column chunk of 16 q rows
        # and tk K (or V) rows padded by 4 floats, at f32 a p^T tile of tk
        # keys, 12 header ints a stage; a tile of several starts at a
        # multiple of 32 keys
        assert d > 256 and plan.dp == -(-d // 64) * 64
        assert plan.threads == 32 and plan.qr == 16 and plan.g == 1
        assert plan.tk == min((tk + 15) // 16 * 16, 64)
        assert plan.smem == tcat.wide_smem_bytes(plan.tk, cd)
        pt = plan.tk * 20 if cd == F32 else 0
        assert plan.smem == 4 * (3 * (16 + plan.tk) * 68 + pt) + 4 * 3 * 12
        # eight blocks an SM (1 KB of shared memory reserved each) where a
        # sequence's keys fit one 16-key tile: the served windows
        if tk <= 16:
            assert 8 * (plan.smem + 1024) <= 232448
        return
    # the ring: two q slots and two K and V stages of rows padded by 4
    # floats, f32's p^T tiles where an item streams tiles, the stages'
    # validity bytes and the ints; one warp a 16 query rows; D
    # zero-padded; several sequences an item only where one tile holds
    # each
    multi = plan.path == "two-pass"
    assert multi == (tk > plan.tk)
    assert plan.smem == tcat.tiled_smem_bytes(plan.g, plan.qr, plan.tk,
                                              plan.dp, cd, multi)
    pt = plan.g * plan.qr * 20 if cd == F32 and multi else 0
    assert plan.smem == 4 * (2 * plan.g * (plan.qr + 2 * plan.tk)
                             * (plan.dp + 4) + pt) \
        + 2 * plan.g * plan.tk + 4 * 12
    assert plan.threads == 32 * plan.g * plan.qr // 16
    assert d <= plan.dp and plan.dp in tcat.TILED_DIMS[cd]
    assert plan.qr % 16 == 0 and plan.qr <= tcat.TILED_Q_ROWS
    keys = tcat.TILED_STREAM_KEYS if multi else tcat.TILED_KEYS
    assert plan.tk % 16 == 0 and plan.tk <= keys[plan.dp]
    assert plan.g == 1 or (tq <= plan.qr and tk <= plan.tk)


def _jax_parity(b, tq, tk, h, d, cd, causal, q_start, kv_start, seed,
                masked_row=False):
    """The port's B3 (its plain version on the CPU) against JAX's Pallas
    kernel in interpret mode on seeded inputs with half the keys (or,
    ``masked_row``, every key of sequence 0 too) masked."""
    q, k, v = qkv(seed, b, tq, tk, h=h, d=d)
    rng = np.random.default_rng(seed + 1)
    valid = rng.random((b, tk)) > 0.5
    if masked_row:
        valid[0] = False
    jcd, tcd = DTYPES[cd]
    want = jpal.flash_block_pallas(
        *(jnp.asarray(x) for x in (q, k, v, valid)), q_start, kv_start,
        causal=causal, compute_dtype=jcd, interpret=True)
    got = tcat.flash_block_pallas(*to_t(q, k, v, valid), q_start, kv_start,
                                  causal=causal, compute_dtype=tcd)
    pv, m, l = (x.numpy() for x in got)
    pv_r, m_r, l_r = (np.asarray(x) for x in want)
    np.testing.assert_allclose(m, m_r, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(l, l_r, rtol=1e-5, atol=1e-5)
    bound = (1e-5 if cd == "f32" else 1e-2) * np.abs(v).max()
    np.testing.assert_allclose(pv, pv_r, rtol=0, atol=bound)
    return pv, m, l


@pytest.mark.parametrize("cd", ["f32", "bf16"])
@pytest.mark.parametrize("tq,tk,d", [(8, 8, 12), (300, 8, 32),
                                     (8, 1000, 64), (256, 256, 12)])
def test_flash_block_plan_takes_what_jax_takes(tq, tk, d, cd):
    """Blocks the card's first B3 kernels refused (D = 12, Tq = 300, Tk =
    1000): the plan takes them, on the tiled variant, and the port agrees
    with JAX's kernel there."""
    tcd = DTYPES[cd][1]
    plan = tcat.flash_block_plan(4, tq, tk, 4, d, tcd)
    assert plan.variant == "tiled" and d <= plan.dp
    assert plan.smem <= tcat.MAX_SMEM and plan.threads <= tcat.MAX_THREADS
    _jax_parity(2, tq, tk, 2, d, cd, True, 0, 0, tq + tk + d)


@pytest.mark.parametrize("cd", ["f32", "bf16"])
@pytest.mark.parametrize("d", [257, 320, 512])
def test_flash_block_plan_takes_head_dims_past_256(d, cd):
    """D above 256, which the plan refused until the wide path: the plan
    fits the kernel's threads and shared memory, and the port agrees with
    JAX's interpret-mode kernel on a small causal block with a ragged
    mask (m, l rtol 1e-5; pv 1e-5 or 1e-2 · max|v|)."""
    tcd = DTYPES[cd][1]
    plan = tcat.flash_block_plan(4, 48, 48, 4, d, tcd)
    assert plan.variant == "tiled" and plan.path == "wide"
    assert plan.smem <= tcat.MAX_SMEM and plan.threads <= tcat.MAX_THREADS
    assert d <= plan.dp
    _jax_parity(2, 48, 48, 2, d, cd, True, 0, 0, d)
    with pytest.raises(ValueError, match="D >= 1"):
        tcat.flash_block_plan(4, 16, 16, 4, 0, tcd)


PARITY_CASES = {
    # (b, tq, tk, h, d, q_start, kv_start, masked_row)
    "t300_d12": (2, 300, 300, 2, 12, 0, 0, False),
    "t512_d128": (2, 512, 512, 1, 128, 0, 0, False),
    "tq64_tk640_offsets": (2, 64, 640, 2, 32, 512, 100, False),
    "fully_masked_row": (3, 40, 72, 2, 24, 8, 0, True),
    "t40_d320": (2, 40, 48, 2, 320, 8, 0, False),
    # the wide path at a ring block (Tq != Tk, both starts nonzero) and
    # with a KV row past its one-pass limit of 64 keys (two passes)
    "t16_tk24_d512_ring_block": (2, 16, 24, 2, 512, 24, 16, False),
    "t16_tk100_d320_two_pass": (2, 16, 100, 2, 320, 90, 0, False),
}


@pytest.mark.parametrize("case", list(PARITY_CASES))
@pytest.mark.parametrize("cd", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_block_matches_jax_at_every_block_it_takes(case, cd, causal):
    """Long, ragged and wide blocks against JAX's interpret-mode kernel:
    m and l rtol 1e-5, pv within 1e-5 · max|v| (f32) or 1e-2 · max|v|
    (bf16); a sequence with no valid key gives m = -1e30, l = 0, pv = 0."""
    b, tq, tk, h, d, q_start, kv_start, masked = PARITY_CASES[case]
    plan = tcat.flash_block_plan(b, tq, tk, h, d, DTYPES[cd][1])
    assert plan.variant == "tiled"
    pv, m, l = _jax_parity(b, tq, tk, h, d, cd, causal, q_start, kv_start,
                           tq * 7 + tk + d, masked_row=masked)
    if masked:
        assert np.all(m[0] == np.float32(-1e30)) and np.all(l[0] == 0)
        assert np.all(pv[0] == 0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("q_start,kv_start", [(0, 0), (0, 8), (8, 0),
                                              (3, 5)])
def test_attended_pairs_counts_the_unmasked_scores(causal, q_start,
                                                   kv_start):
    valid = ragged_valid(11, 6, 8)
    mask = tcat._position_mask(torch.from_numpy(valid), 6, q_start,
                               kv_start, causal)
    brute = int(mask.expand(6, 1, 6, 8).sum())
    assert tcat.attended_pairs(torch.from_numpy(valid), 6, q_start,
                               kv_start, causal) == brute


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("q_start,kv_start", [(0, 0), (0, 8), (8, 0),
                                              (3, 5), (0, 3)])
def test_needed_rows_counts_what_the_output_depends_on(causal, q_start,
                                                       kv_start):
    """Query rows that see a key and keys that a row sees, against the
    position mask (ragged lengths, sequences with no valid key, and a
    mask with holes)."""
    valid = ragged_valid(11, 6, 8)
    valid[1, :3] = 0  # a sequence whose first valid key is not key 0
    mask = tcat._position_mask(torch.from_numpy(valid), 6, q_start,
                               kv_start, causal).expand(6, 1, 6, 8)[:, 0]
    want = (int(mask.any(dim=2).sum()), int(mask.any(dim=1).sum()))
    assert tcat.needed_rows(torch.from_numpy(valid), 6, q_start, kv_start,
                            causal) == want


def test_flash_block_bound_counts_only_the_bytes_the_output_needs():
    """Half the sequences with no valid key: q, K and V of those cost
    nothing, the outputs of every row still count."""
    b, t, h, d = 8, 16, 4, 32
    valid = torch.zeros((b, t), dtype=torch.bool)
    valid[: b // 2] = True
    q = torch.zeros((b, t, h, d))
    pairs = tcat.attended_pairs(valid, t, 0, 0, True)
    nbytes, _, _ = tcat.flash_block_cost(b, t, t, h, d, pairs, b // 2 * t,
                                         b // 2 * t)
    assert nbytes == 4 * h * d * 3 * (b // 2) * t + b * t \
        + 4 * (b * t * h * d + 2 * b * h * t)
    assert tcat.needed_rows(valid, t, 0, 0, True) == (b // 2 * t, b // 2 * t)
    ms, _ = tcat.flash_block_bound_ms(q, q, valid, 0, 0)
    assert ms == tcat.bound_ms(nbytes, 4 * d * h * pairs,
                               tcat.BF16_OPS_PER_S)[0]


def test_flash_block_cost_at_the_serving_shape():
    """B = 262,144, T = 16, H = 4, D = 32: ~8.7 GB to move, bound by
    bytes at ~2.6 ms on an H100 SXM; the all-valid causal pairs need
    ~18 GFLOP (the full 16 × 16 scores would be ~34)."""
    b, t, h, d = 262144, 16, 4, 32
    pairs = b * t * (t + 1) // 2
    nbytes, ops, rate = tcat.flash_block_cost(b, t, t, h, d, pairs, b * t,
                                              b * t)
    assert nbytes == 4 * 4 * b * t * h * d + b * t + 8 * b * h * t
    assert abs(nbytes / 8.7e9 - 1) < 0.01
    assert ops == 4 * d * h * pairs and abs(ops / 18.25e9 - 1) < 0.01
    assert rate == tcat.BF16_OPS_PER_S
    valid = torch.ones((4, t), dtype=torch.bool)
    q = torch.zeros((4, t, h, d))
    ms, by = tcat.flash_block_bound_ms(q, q, valid, 0, 0)
    assert by == "bytes" and ms > 0
    _, _, rate32 = tcat.flash_block_cost(b, t, t, h, d, pairs, b * t,
                                         b * t, torch.float32)
    assert rate32 == 67e12


def test_flash_block_launch_refuses_a_plan_its_inputs_do_not_fit():
    """A tensor-core plan computes in bf16 only, and a bulk-copy plan
    needs contiguous q, k and v; both are refused before any launch."""
    q, k, v = to_t(*qkv(12, 2, 16, 16, d=32))
    valid = torch.ones((2, 16), dtype=torch.bool)
    plan = tcat.flash_block_plan(2, 16, 16, 4, 32)
    assert plan.variant == "tc" and plan.bulk
    with pytest.raises(ValueError, match="bf16 only"):
        tcat.flash_block_launch(plan, q, k, v, valid, 0, 0,
                                compute_dtype=torch.float32)
    strided = torch.zeros((2, 16, 5, 32))[:, :, 1:]
    with pytest.raises(ValueError, match="contiguous"):
        tcat.flash_block_launch(plan, strided, k, v, valid, 0, 0)
    assert tcat.tiled_plan(2, 16, 16, 32).variant == "tiled"
