"""The port's attention primitives and kernel B3's wrappers against the
JAX package's.

Inputs are seeded numpy arrays handed to both packages. JAX's Pallas
kernel runs as its own tests run it on the CPU (interpret mode); the
port's wrappers take their plain versions for CPU tensors. Tolerances:

- f32 compute: rtol = atol = 1e-5 (summation order only);
- bf16 compute: ``m`` and ``l`` rtol = atol = 1e-5, ``pv`` and
  attention outputs within 1e-2 · max|v| (one bf16 rounding of ``p`` may
  flip between the two).

The block plan (which variant, tensor-core or SIMT, and its blocking)
and cost model that the CUDA wrapper uses are checked here too; the
kernels themselves run only on the card (``tests/test_torch_cuda.py``).
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
    # f32 compute and the shapes tensor cores do not take: SIMT
    (262144, 16, 16, 4, 32, F32, True, ("simt", 3, 4, 192, False)),
    (16384, 128, 128, 4, 32, F32, True, ("simt", 1, 2, 256, False)),
    (5, 9, 13, 4, 16, BF16, True, ("simt", 5, 4, 180, False)),
    (4, 32, 20, 2, 64, BF16, True, ("simt", 2, 2, 128, False)),
    (2, 256, 256, 4, 8, BF16, True, ("simt", 1, 1, 256, False)),
    (1, 1, 1, 1, 8, BF16, True, ("simt", 1, 1, 1, False)),
    (2, 144, 144, 4, 32, BF16, True, ("simt", 1, 1, 144, False)),
])
def test_flash_block_plan_fits_the_kernel(b, tq, tk, h, d, cd, contiguous,
                                          want):
    plan = tcat.flash_block_plan(b, tq, tk, h, d, cd, contiguous)
    assert (plan.variant, plan.g, plan.hb, plan.threads, plan.bulk) == want
    assert h % plan.hb == 0 and plan.threads <= tcat.MAX_THREADS
    assert plan.smem == tcat.smem_bytes(plan.g, plan.hb, tq, tk, d,
                                        plan.variant, plan.bulk)
    assert plan.smem <= tcat.MAX_SMEM
    assert tcat.takes_tensor_cores(tq, tk, d, cd) == (plan.variant == "tc")
    if plan.variant == "tc":
        # a stage holds q, k, v of g sequences × hb heads, rows padded
        # by 4 floats unless bulk copies land them; two stages
        row = plan.hb * d if plan.bulk else d + 4
        assert plan.smem == 2 * (3 * 4 * plan.g * tq * row + 8)
        assert plan.threads == 32 * plan.g * plan.hb * tq // 16
        assert not plan.bulk or plan.hb == h
    else:
        assert plan.threads == plan.g * plan.hb * tq


@pytest.mark.parametrize("tq,tk,d", [(8, 8, 12), (300, 8, 32),
                                     (8, 1000, 64), (256, 256, 12)])
def test_flash_block_plan_rejects_what_the_kernel_does_not_take(tq, tk, d):
    with pytest.raises(ValueError, match="B3"):
        tcat.flash_block_plan(4, tq, tk, 4, d)


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


def test_flash_block_cost_at_the_serving_shape():
    """B = 262,144, T = 16, H = 4, D = 32: ~8.7 GB to move, bound by
    bytes at ~2.6 ms on an H100 SXM; the all-valid causal pairs need
    ~18 GFLOP (the full 16 × 16 scores would be ~34)."""
    b, t, h, d = 262144, 16, 4, 32
    pairs = b * t * (t + 1) // 2
    nbytes, ops, rate = tcat.flash_block_cost(b, t, t, h, d, pairs)
    assert nbytes == 4 * 4 * b * t * h * d + b * t + 8 * b * h * t
    assert abs(nbytes / 8.7e9 - 1) < 0.01
    assert ops == 4 * d * h * pairs and abs(ops / 18.25e9 - 1) < 0.01
    assert rate == tcat.BF16_OPS_PER_S
    valid = torch.ones((4, t), dtype=torch.bool)
    q = torch.zeros((4, t, h, d))
    ms, by = tcat.flash_block_bound_ms(q, q, valid, 0, 0)
    assert by == "bytes" and ms > 0
    _, _, rate32 = tcat.flash_block_cost(b, t, t, h, d, pairs,
                                         torch.float32)
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
    assert tcat.simt_plan(2, 16, 16, 4, 32).variant == "simt"
