"""The port's ring attention and sequence parallelism against the JAX
package's, on 8 shards.

The port runs on 8 virtual ``cpu`` shards (``make_mesh([8], ["seq"],
devices=["cpu"] * 8)``), JAX on the 8 CPU devices ``tests/conftest.py``
forces; inputs are seeded numpy. Tolerances:

- the ring (einsum and pallas; JAX runs its Pallas kernel in interpret
  mode, the port B3's plain version on the CPU): f32 compute rtol 1e-5,
  atol 1e-5 (``tests/test_ring.py``'s own); bf16 compute rtol 1e-2, atol
  1e-2 · max|out| (a bf16 rounding of p may flip between the packages);
- the sequence-parallel program at f32: rtol 1e-4, atol 1e-4 against
  JAX's and against the port's dense ``predict_temporal`` (JAX's own
  test's bound);
- the sequence-parallel train step at f32: loss and gradients through
  the ring against ``jax.value_and_grad`` of JAX's ring, rtol 1e-5 (atol
  1e-5 · max|grad| per leaf); one step against the port's dense step,
  loss rtol 1e-5 and params rtol 1e-4, atol 1e-5 (JAX's
  ``test_grads_flow_through_ring_and_match_dense``); five steps' losses
  against JAX's step, rtol 1e-4 (``test_torch_train``'s f32 bound); remat
  equal to no remat.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kepler_tpu.models import train as jtrain
from kepler_tpu.models.temporal import predict_temporal as jpredict_temporal
from kepler_tpu.parallel import make_mesh as jmake_mesh
from kepler_tpu.parallel import make_ring_attention as jring
from kepler_tpu.parallel import make_sequence_parallel_train_step as jsp_step
from kepler_tpu.parallel import make_temporal_program as jsp_program
from kepler_tpu.parallel.ring import ring_attention_shardmap as jring_fn
from kepler_tpu_torch.models import estimator as port_est
from kepler_tpu_torch.models import train as ptrain
from kepler_tpu_torch.models.temporal import predict_temporal
from kepler_tpu_torch.ops import cuda_attention as cat
from kepler_tpu_torch.parallel import (full_attention, make_mesh,
                                       make_ring_attention,
                                       make_sequence_parallel_train_step,
                                       make_temporal_program)
from kepler_tpu_torch.parallel import ring as pring
from tests.test_torch_temporal import jax_params

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
LENGTHS = {"full": [32, 32, 32], "ragged": [5, 32, 17],
           "fully_masked": [0, 9, 0]}


def seq_mesh(n: int = 8):
    return make_mesh([n], ["seq"], devices=["cpu"] * n)


def qkv(seed: int, b: int = 3, t: int = 32, h: int = 4, d: int = 16):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, t, h, d)).astype(np.float32)
                 for _ in range(3))


def valid_of(lengths: list[int], t: int = 32) -> np.ndarray:
    return np.arange(t)[None, :] < np.asarray(lengths)[:, None]


def t_(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def assert_out(got: np.ndarray, want: np.ndarray, cd: str) -> None:
    if cd == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-2,
                                   atol=1e-2 * float(np.abs(want).max()))


@pytest.mark.parametrize("backend", ["einsum", "pallas"])
@pytest.mark.parametrize("cd", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("lengths", list(LENGTHS))
def test_ring_matches_jax(backend, cd, causal, lengths):
    q, k, v = qkv(len(lengths) + 7 * causal)
    tv = valid_of(LENGTHS[lengths])
    jcd, tcd = DTYPES[cd]
    want = np.asarray(jring(jmake_mesh([8], ["seq"]), causal=causal,
                            compute_dtype=jcd, backend=backend)(
        *(jnp.asarray(x) for x in (q, k, v, tv))))
    got = make_ring_attention(seq_mesh(), causal=causal, compute_dtype=tcd,
                              backend=backend)(*(t_(x) for x in
                                                 (q, k, v, tv)))
    assert got.shape == q.shape and got.dtype == torch.float32
    assert_out(got.numpy(), want, cd)
    dense = full_attention(*(t_(x) for x in (q, k, v)), causal=causal,
                           t_valid=t_(tv), compute_dtype=tcd)
    assert_out(got.numpy(), dense.numpy(), cd)
    # a sequence with no valid key: exactly zero rows, as JAX's
    empty = np.asarray(LENGTHS[lengths]) == 0
    assert np.all(got.numpy()[empty] == 0.0)
    assert np.all(want[empty] == 0.0)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_pallas_ring_reaches_b3_n_squared_times(monkeypatch, n):
    """Each shard's query block meets every KV block once: n² B3 calls,
    block starts ``i · T/n`` (query) and ``src · T/n`` (KV), every
    block a contiguous ``[B, T/n, H, D]``."""
    calls = []

    def counting(q, k, v, kv_valid, q_start, kv_start, **kw):
        calls.append((q_start, kv_start))
        assert q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
        assert q.shape == (3, 32 // n, 4, 16)
        return real(q, k, v, kv_valid, q_start, kv_start, **kw)

    real = cat.flash_block_pallas
    monkeypatch.setattr(cat, "flash_block_pallas", counting)
    q, k, v = qkv(3)
    tv = valid_of(LENGTHS["ragged"])
    ring = make_ring_attention(seq_mesh(n), backend="pallas",
                               compute_dtype=torch.float32)
    got = ring(*(t_(x) for x in (q, k, v, tv)))
    t_loc = 32 // n
    assert sorted(calls) == sorted((i * t_loc, s * t_loc)
                                   for i in range(n) for s in range(n))
    einsum = make_ring_attention(seq_mesh(n), compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), einsum(*(t_(x) for x in (
        q, k, v, tv))).numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cd", ["f32", "bf16"])
def test_pallas_ring_on_two_shards_takes_512_row_blocks(cd):
    """The ring on 2 shards at T = 1024: B3 meets 512-row blocks (Tq = Tk
    = 512, block starts 0 and 512), which the tiled variant plans on the
    card, against JAX's ring on 2 CPU devices (its Pallas kernel in
    interpret mode) and dense attention."""
    b, t, h, d = 2, 1024, 2, 8
    q, k, v = qkv(61, b=b, t=t, h=h, d=d)
    tv = valid_of([700, 1024], t=t)
    jcd, tcd = DTYPES[cd]
    assert cat.flash_block_plan(b, t // 2, t // 2, h, d, tcd).variant == \
        "tiled"
    jmesh = jmake_mesh([2], ["seq"], devices=jax.devices()[:2])
    want = np.asarray(jring(jmesh, compute_dtype=jcd, backend="pallas")(
        *(jnp.asarray(x) for x in (q, k, v, tv))))
    got = make_ring_attention(seq_mesh(2), compute_dtype=tcd,
                              backend="pallas")(*(t_(x) for x in
                                                  (q, k, v, tv)))
    assert got.shape == q.shape
    assert_out(got.numpy(), want, cd)
    dense = full_attention(*(t_(x) for x in (q, k, v)), t_valid=t_(tv),
                           compute_dtype=tcd)
    assert_out(got.numpy(), dense.numpy(), cd)


def test_ring_rejects_what_it_does_not_take():
    q, k, v = qkv(4, t=12)
    tv = np.ones((3, 12), bool)
    with pytest.raises(ValueError, match="does not divide"):
        make_ring_attention(seq_mesh())(*(t_(x) for x in (q, k, v, tv)))
    with pytest.raises(ValueError, match="1-D mesh over 'seq'"):
        make_ring_attention(make_mesh([8], ["node"], devices=["cpu"] * 8))
    with pytest.raises(ValueError, match="unknown ring backend"):
        make_ring_attention(seq_mesh(), backend="xla")(
            *(t_(x) for x in qkv(4) + (valid_of(LENGTHS["full"]),)))
    other = seq_mesh().with_processes(lambda k: k // 4)
    with pytest.raises(ValueError, match="cross-process collectives"):
        make_ring_attention(other)


def test_pallas_ring_refuses_autograd_as_jax_does():
    """JAX cannot differentiate through its Pallas kernel; the port's B3
    refuses autograd on every device, so a ring with ``backend="pallas"``
    gives no gradient anywhere. The einsum ring differentiates."""
    q, k, v = qkv(5, b=2, t=16)
    tv = valid_of([16, 9], t=16)

    def jloss(backend):
        ring = jring_fn(jmake_mesh([8], ["seq"]), backend=backend)
        return lambda q: jnp.sum(jax.jit(ring)(q, jnp.asarray(k),
                                               jnp.asarray(v),
                                               jnp.asarray(tv)))

    with pytest.raises(ValueError):
        jax.grad(jloss("pallas"))(jnp.asarray(q))
    assert np.isfinite(np.asarray(jax.grad(jloss("einsum"))(
        jnp.asarray(q)))).all()
    tq = t_(q).requires_grad_(True)
    args = (t_(k), t_(v), t_(tv))
    with pytest.raises(ValueError, match="no backward"):
        make_ring_attention(seq_mesh(), backend="pallas")(tq, *args)
    with pytest.raises(ValueError, match="no backward"):
        cat.pallas_attention_fn()(tq, *args)
    # serving (no grad mode) still reaches the kernel's plain version
    with torch.no_grad():
        make_ring_attention(seq_mesh(), backend="pallas")(tq, *args)
    make_ring_attention(seq_mesh())(tq, *args).sum().backward()
    assert torch.isfinite(tq.grad).all()


# -- sequence parallelism ------------------------------------------------------

def sp_inputs(seed: int, w: int = 6, t: int = 32):
    rng = np.random.default_rng(seed)
    hist = rng.uniform(0.0, 3.0, (w, t, 7)).astype(np.float32)
    wv = np.array([True, True, False, True, True, True])[:w]
    tv = valid_of([t, 8, t, 1, 17, 0][:w], t)
    targets = rng.uniform(0.0, 30.0, (w, 4)).astype(np.float32)
    return hist, wv, tv, targets


@pytest.mark.parametrize("cd", ["f32", "bf16"])
def test_temporal_program_matches_jax_and_dense(cd):
    params = jax_params(d_model=32, t_max=32, seed=11)
    hist, wv, tv, _ = sp_inputs(12)
    jcd, tcd = DTYPES[cd]
    want = np.asarray(jsp_program(jmake_mesh([8], ["seq"]),
                                  compute_dtype=jcd)(
        jax.tree.map(jnp.asarray, params),
        *(jnp.asarray(x) for x in (hist, wv, tv))))
    pp = port_est.params_from_numpy("temporal", params)
    got = make_temporal_program(seq_mesh(), compute_dtype=tcd)(
        pp, *(t_(x) for x in (hist, wv, tv))).numpy()
    dense = predict_temporal(pp, *(t_(x) for x in (hist, wv, tv)),
                             compute_dtype=tcd).numpy()
    if cd == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got, dense, rtol=1e-4, atol=1e-4)
    else:
        for ref in (want, dense):
            np.testing.assert_allclose(got, ref, rtol=1e-2,
                                       atol=1e-2 * float(np.abs(ref).max()))
    assert np.all(got[~wv] == 0.0) and np.all(got >= 0.0)


def test_sp_loss_and_gradients_match_jax_through_the_ring():
    params = jax_params(d_model=32, t_max=32, seed=13)
    hist, wv, tv, targets = sp_inputs(14)
    jmesh = jmake_mesh([8], ["seq"])
    jattn = jring_fn(jmesh, compute_dtype=jnp.float32)

    def jloss(p):
        pred = jpredict_temporal(p, jnp.asarray(hist), jnp.asarray(wv),
                                 jnp.asarray(tv), clamp=False,
                                 compute_dtype=jnp.float32,
                                 attention_fn=jattn)
        return jtrain.masked_mse(pred, jnp.asarray(targets),
                                 jnp.asarray(wv))

    want, jgrads = jax.jit(jax.value_and_grad(jloss))(
        jax.tree.map(jnp.asarray, params))
    pp = {k: v.requires_grad_(True) for k, v in
          port_est.params_from_numpy("temporal", params).items()}
    ring = pring.ring_attention_shardmap(seq_mesh(),
                                         compute_dtype=torch.float32)
    pred = predict_temporal(pp, *(t_(x) for x in (hist, wv, tv)),
                            clamp=False, compute_dtype=torch.float32,
                            attention_fn=ring)
    loss = ptrain.masked_mse(pred, t_(targets), t_(wv))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    for key, g in pp.items():
        ref = np.asarray(jgrads[key])
        np.testing.assert_allclose(
            g.grad.numpy(), ref, rtol=1e-5,
            atol=1e-5 * max(float(np.abs(ref).max()), 1e-12), err_msg=key)


@pytest.mark.parametrize("remat", [False, True])
def test_sp_train_step_matches_dense_and_jax(remat):
    params = jax_params(d_model=32, t_max=32, seed=15)
    hist, wv, tv, targets = sp_inputs(16)
    args = [t_(x) for x in (hist, wv, tv, targets)]
    fresh = lambda: ptrain.create_train_state(  # noqa: E731
        port_est.params_from_numpy("temporal", params),
        ptrain.make_optimizer(1e-2))
    sp = make_sequence_parallel_train_step(seq_mesh(), remat=remat)
    dense = ptrain.make_temporal_train_step(compute_dtype=torch.float32)
    sp_state, sp_loss = sp(fresh(), *args)
    d_state, d_loss = dense(fresh(), *args)
    np.testing.assert_allclose(float(sp_loss), float(d_loss), rtol=1e-5)
    for key in sp_state.params:
        np.testing.assert_allclose(
            sp_state.params[key].detach().numpy(),
            d_state.params[key].detach().numpy(), rtol=1e-4, atol=1e-5,
            err_msg=key)
    # five steps against JAX's sequence-parallel step
    jopt = jtrain.make_optimizer(1e-2)
    jstep = jsp_step(jmake_mesh([8], ["seq"]), jopt, remat=remat)
    jstate = jtrain.create_train_state(jax.tree.map(jnp.asarray, params),
                                       jopt)
    state, got, want = fresh(), [], []
    for _ in range(5):
        jstate, jl = jstep(jstate, *(jnp.asarray(x) for x in
                                     (hist, wv, tv, targets)))
        state, pl = sp(state, *args)
        want.append(float(jl))
        got.append(float(pl))
    assert state.step == 5 and got[-1] < got[0]
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_remat_equals_no_remat():
    params = jax_params(d_model=32, t_max=32, seed=17)
    hist, wv, tv, targets = sp_inputs(18)
    out = []
    for remat in (False, True):
        state = ptrain.create_train_state(
            port_est.params_from_numpy("temporal", params),
            ptrain.make_optimizer(1e-2))
        step = make_sequence_parallel_train_step(seq_mesh(), remat=remat)
        state, loss = step(state, *(t_(x) for x in (hist, wv, tv,
                                                    targets)))
        out.append((float(loss), ptrain.param_leaves(state.params)))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


# -- the per-shard programs (the trunk on each shard's T/n block) -------------

# T = 64 over 8 shards: blocks of 8 ticks. Windows: full, the last valid
# tick at the end of block 0 (length 8) and at the start of block 1
# (length 9), one empty, ragged, and the last tick of block 3 (32). The
# positional table is longer than T (t_max 128), so no tensor of the run
# but the sequence itself has an axis of 64.
BLOCK_T, BLOCK_T_MAX = 64, 128
BLOCK_LENGTHS = [64, 8, 9, 0, 27, 32]


def block_inputs(seed: int):
    rng = np.random.default_rng(seed)
    w = len(BLOCK_LENGTHS)
    hist = rng.uniform(0.0, 3.0, (w, BLOCK_T, 7)).astype(np.float32)
    tv = valid_of(BLOCK_LENGTHS, BLOCK_T)
    hist = np.where(tv[..., None], hist, 0.0).astype(np.float32)
    wv = np.array([True, True, True, True, False, True])
    targets = rng.uniform(0.0, 30.0, (w, 4)).astype(np.float32)
    return hist, wv, tv, targets


def assert_watts(got: np.ndarray, want: np.ndarray, cd: str) -> None:
    if cd == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-2 * float(np.abs(want).max()))


@pytest.mark.parametrize("cd", ["f32", "bf16"])
def test_per_shard_program_matches_jax_and_dense(cd):
    """The per-shard sequence program on 8 shards against JAX's
    ``make_temporal_program`` on 8 devices and the port's dense path:
    f32 within rtol = atol = 1e-5, bf16 within 1e-2 · max|watts|."""
    params = jax_params(d_model=32, t_max=BLOCK_T_MAX, seed=31)
    hist, wv, tv, _ = block_inputs(32)
    jcd, tcd = DTYPES[cd]
    want = np.asarray(jsp_program(jmake_mesh([8], ["seq"]),
                                  compute_dtype=jcd)(
        jax.tree.map(jnp.asarray, params),
        *(jnp.asarray(x) for x in (hist, wv, tv))))
    pp = port_est.params_from_numpy("temporal", params)
    args = [t_(x) for x in (hist, wv, tv)]
    got = make_temporal_program(seq_mesh(), compute_dtype=tcd)(pp, *args)
    assert got.shape == (len(BLOCK_LENGTHS), 4)
    dense = predict_temporal(pp, *args, compute_dtype=tcd).numpy()
    for ref in (want, dense):
        assert_watts(got.numpy(), ref, cd)
    assert np.all(got.numpy()[~wv] == 0.0) and np.all(got.numpy() >= 0.0)


def test_per_shard_program_takes_leading_axes_and_no_t_valid():
    """Leading axes flatten into the batch and ``t_valid=None`` means
    every tick is valid, as in ``predict_temporal``."""
    params = port_est.params_from_numpy(
        "temporal", jax_params(d_model=32, t_max=BLOCK_T_MAX, seed=33))
    hist, wv, tv, _ = block_inputs(34)
    program = make_temporal_program(seq_mesh(), compute_dtype=torch.float32)
    flat = program(params, *(t_(x) for x in (hist, wv, tv)))
    lead = program(params, t_(hist.reshape(2, 3, BLOCK_T, 7)),
                   t_(wv.reshape(2, 3)), t_(tv.reshape(2, 3, BLOCK_T)))
    assert lead.shape == (2, 3, 4)
    assert torch.equal(lead.reshape(6, 4), flat)
    np.testing.assert_allclose(
        program(params, t_(hist), t_(wv), None).numpy(),
        predict_temporal(params, t_(hist), t_(wv), None,
                         compute_dtype=torch.float32).numpy(),
        rtol=1e-5, atol=1e-5)


def jax_sp_loss_and_grads(params, hist, wv, tv, targets):
    """JAX's sequence-parallel forward (the ring inside the trunk, T
    sharded over 8 devices) → (loss, gradients) of the masked MSE."""
    jmesh = jmake_mesh([8], ["seq"])
    jattn = jring_fn(jmesh, compute_dtype=jnp.float32)

    def jloss(p, h, w, v, y):
        pred = jpredict_temporal(p, h, w, v, clamp=False,
                                 compute_dtype=jnp.float32,
                                 attention_fn=jattn)
        return jtrain.masked_mse(pred, y, w)

    from jax.sharding import NamedSharding, PartitionSpec as P
    hist_s, rep = (NamedSharding(jmesh, P(None, "seq")),
                   NamedSharding(jmesh, P()))
    fn = jax.jit(jax.value_and_grad(jloss),
                 in_shardings=(rep, hist_s, rep, hist_s, rep))
    return fn(jax.tree.map(jnp.asarray, params),
              *(jnp.asarray(x) for x in (hist, wv, tv, targets)))


@pytest.mark.parametrize("remat", [False, True])
def test_per_shard_train_step_matches_jax(remat):
    """One per-shard train step at f32 against JAX: the loss within rtol
    1e-5 of JAX's step, the summed gradients (left in the state's
    ``.grad``) within rtol 1e-4, atol 1e-5 of ``jax.value_and_grad`` of
    JAX's sharded forward, and the updated params within rtol 1e-4,
    atol 1e-5 of JAX's ``make_sequence_parallel_train_step``."""
    params = jax_params(d_model=32, t_max=BLOCK_T_MAX, seed=35)
    hist, wv, tv, targets = block_inputs(36)
    jopt = jtrain.make_optimizer(1e-2)
    jstep = jsp_step(jmake_mesh([8], ["seq"]), jopt, remat=remat)
    jstate, jl = jstep(jtrain.create_train_state(
        jax.tree.map(jnp.asarray, params), jopt),
        *(jnp.asarray(x) for x in (hist, wv, tv, targets)))
    jloss, jgrads = jax_sp_loss_and_grads(params, hist, wv, tv, targets)
    np.testing.assert_allclose(float(jl), float(jloss), rtol=1e-6)

    state = ptrain.create_train_state(
        port_est.params_from_numpy("temporal", params),
        ptrain.make_optimizer(1e-2))
    step = make_sequence_parallel_train_step(seq_mesh(), remat=remat)
    state, loss = step(state, *(t_(x) for x in (hist, wv, tv, targets)))
    assert state.step == 1
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for key, p in state.params.items():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrads[key]),
                                   rtol=1e-4, atol=1e-5, err_msg=key)
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jstate.params[key]),
                                   rtol=1e-4, atol=1e-5, err_msg=key)


def test_per_shard_gradients_are_summed_in_one_psum(monkeypatch):
    """The train step's gradient all-reduce is one explicit ``psum`` of
    the 8 shards' flattened gradients, whose sum is the state's
    gradient; the state is updated in place."""
    from kepler_tpu_torch.parallel import sequence as pseq

    params = jax_params(d_model=32, t_max=BLOCK_T_MAX, seed=37)
    hist, wv, tv, targets = block_inputs(38)
    calls = []
    real = pseq.psum

    def spying(xs, devices):
        calls.append([x.detach().clone() for x in xs])
        return real(xs, devices)

    monkeypatch.setattr(pseq, "psum", spying)
    state = ptrain.create_train_state(
        port_est.params_from_numpy("temporal", params),
        ptrain.make_optimizer(1e-2))
    before = {k: v for k, v in state.params.items()}
    step = make_sequence_parallel_train_step(seq_mesh())
    state, _ = step(state, *(t_(x) for x in (hist, wv, tv, targets)))
    assert all(state.params[k] is before[k] for k in before)
    n_params = sum(p.numel() for p in state.params.values())
    grads = [c for c in calls if c[0].shape == (n_params,)]
    assert len(grads) == 1 and len(grads[0]) == 8
    summed = grads[0][0].clone()
    for g in grads[0][1:]:
        summed = summed + g
    flat = torch.cat([p.grad.reshape(-1) for p in state.params.values()])
    assert torch.equal(flat, summed)
    # every shard's trunk contributes: no shard's gradient is zero
    assert all(bool(g.abs().sum() > 0) for g in grads[0])


def long_time_axes(shapes, t: int, b: int) -> list:
    """The recorded float outputs with an axis as long as the whole
    sequence (T, or B · T once flattened)."""
    return [(name, s) for name, s in shapes if t in s or b * t in s]


def test_no_trunk_op_sees_more_than_one_block():
    """Under the op recorder, no op of the per-shard serving program or
    train step (its backward and AdamW included) returns a float tensor
    with an axis as long as the sequence; the largest carries T/n ticks.
    The whole-tensor trunk through the same ring does return such
    tensors, so the check can see them."""
    from kepler_tpu_torch.ops.recorder import OutputShapes

    params = port_est.params_from_numpy(
        "temporal", jax_params(d_model=32, t_max=BLOCK_T_MAX, seed=39))
    hist, wv, tv, targets = (t_(x) for x in block_inputs(40))
    b, t, n = len(BLOCK_LENGTHS), BLOCK_T, 8
    program = make_temporal_program(seq_mesh(n), compute_dtype=torch.float32)
    with OutputShapes() as rec:
        program(params, hist, wv, tv)
    assert rec.shapes and not long_time_axes(rec.shapes, t, b)
    assert ("mm", (b * t // n, 4 * 32)) in rec.shapes  # the MLP, per block

    state = ptrain.create_train_state(params, ptrain.make_optimizer(1e-2))
    step = make_sequence_parallel_train_step(seq_mesh(n), remat=True)
    with OutputShapes() as rec:
        step(state, hist, wv, tv, targets)
    assert rec.shapes and not long_time_axes(rec.shapes, t, b)

    ring = pring.ring_attention_shardmap(seq_mesh(n),
                                         compute_dtype=torch.float32)
    with OutputShapes() as rec:
        predict_temporal(params, hist, wv, tv, compute_dtype=torch.float32,
                         attention_fn=ring)
    assert long_time_axes(rec.shapes, t, b)


@pytest.mark.parametrize("backend", ["einsum", "pallas"])
@pytest.mark.parametrize("cd", ["f32", "bf16"])
def test_ring_blocks_equal_the_whole_tensor_ring(backend, cd):
    """``ring_blocks`` over split blocks, joined, is bit-identical to the
    whole-tensor ring, on both backends; each output block lies on its
    shard's device in q's dtype."""
    q, k, v = qkv(41)
    tv = valid_of(LENGTHS["ragged"])
    _, tcd = DTYPES[cd]
    mesh = seq_mesh()
    devices = list(mesh.devices)
    whole = make_ring_attention(mesh, compute_dtype=tcd, backend=backend)(
        *(t_(x) for x in (q, k, v, tv)))
    blocks = [pring.split_blocks(t_(x), devices) for x in (q, k, v, tv)]
    out = pring.ring_blocks(*blocks, devices=devices, causal=True,
                            compute_dtype=tcd, backend=backend)
    assert len(out) == 8 and all(o.shape == (3, 4, 4, 16) for o in out)
    assert all(o.dtype == torch.float32 for o in out)
    assert torch.equal(pring.join_blocks(out, devices[0]), whole)
    with pytest.raises(ValueError, match="unknown ring backend"):
        pring.ring_blocks(*blocks, devices=devices, backend="xla")
