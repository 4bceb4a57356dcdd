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
compares them with the plain versions there. Their build step
(``ops/build.py``) is checked here with a stand-in ``nvcc``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kepler_tpu.ops.pallas_attribution import (fused_window_step,
                                               outer_product_attribution)
from kepler_tpu.parallel import packed as jp
from kepler_tpu.parallel.mesh import make_mesh
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


def flush_inputs(seed: int, n: int, w: int, z: int, k: int, db: int):
    """A resident block and K steps of DB delta rows with every edge case
    of ``window_inputs``, one pad entry per step, and (K ≥ 2) row 3 hit
    in steps 0 and 1. Indices stay unique within a step."""
    resident, _, _ = window_inputs(seed, n, w, z, 1)
    deltas, idx = [], []
    for s in range(k):
        _, d, i = window_inputs(seed + 1 + s, n, w, z, db)
        i[i == 3] = n
        i[-1] = n
        if s < 2 and k >= 2:
            i[s] = 3
        deltas.append(d)
        idx.append(i)
    return resident, np.stack(deltas), np.stack(idx).astype(np.int32)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_fused_window_steps_plain_equals_single_steps_and_jax(k):
    """K steps at once equal K single steps and the JAX fused program
    (``make_fused_window_program``, Pallas in interpret mode) bit for
    bit: resident' exactly, NaN slots included, and every f16 plane."""
    n, w, z, db = 16, 17, 4, 6
    lay = PackedLayout(w, z)
    resident, deltas, idx = flush_inputs(40 + k, n, w, z, k, db)
    if k >= 2:
        assert (idx[0] == 3).sum() == 1 and (idx[1] == 3).sum() == 1
    assert (idx == n).any() and np.isnan(resident).any()

    before = ca.LAUNCHES["fused_window_step"]
    res_all = torch.from_numpy(resident.copy())
    out = torch.full((k, n, w + 2, z), 7.0, dtype=torch.float16)
    got_res, planes = ca.fused_window_steps(
        res_all, torch.from_numpy(deltas), torch.from_numpy(idx), lay,
        out=out)
    assert got_res is res_all and planes is out
    assert ca.LAUNCHES["fused_window_step"] == before  # CPU: plain version

    res_one = torch.from_numpy(resident.copy())
    singles = [ca.fused_window_step(res_one, torch.from_numpy(deltas[s]),
                                    torch.from_numpy(idx[s]), lay)[1]
               for s in range(k)]
    np.testing.assert_array_equal(res_all.numpy(), res_one.numpy())
    for s in range(k):
        np.testing.assert_array_equal(planes[s].numpy(), singles[s].numpy())

    jprog = jp.make_fused_window_program(
        make_mesh(devices=jax.devices()[:1]), n_workloads=w, n_zones=z,
        backend="pallas")
    j_res, j_outs = jprog(None, jnp.asarray(resident), jnp.asarray(deltas),
                          jnp.asarray(idx))
    np.testing.assert_array_equal(res_all.numpy(), np.asarray(j_res))
    assert int((f16_ulps(planes.numpy(), np.asarray(j_outs)) > 0).sum()) == 0
    if k >= 2:  # row 3 ends as step 1 left it
        np.testing.assert_array_equal(res_all[3].numpy(),
                                      deltas[1][list(idx[1]).index(3)])


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
    # the single step is the K = 1 flush
    assert ca.fused_window_step_cost(1024, 128, 256, 4, hits=120) == \
        ca.fused_window_steps_cost(1024, 128, 256, 4, 1, hits=120)


@pytest.mark.parametrize("k,db,hits,dirty,want_mb", [
    (4, 128, None, None, 10.65),  # the ratio-fused flush: ≈ 3.2 µs
    (4, 128, 480, 400, 10.50),  # pads land nowhere; rows hit twice
    (1, 1024, None, None, 5.41),  # one step, every row replaced
    (8, 8, 0, 0, 18.01),  # no hit at all: resident read, 8 planes
])
def test_fused_window_steps_cost(k, db, hits, dirty, want_mb):
    """One K-step launch reads resident once, each landing delta row
    once, writes each dirty row back once, reads the K·DB indices and
    writes K f16 planes."""
    n, w, z = 1024, 256, 4
    width, plane = w + 2 * z + 4, 2 * n * (w + 2) * z
    nbytes, ops = ca.fused_window_steps_cost(n, db, w, z, k, hits, dirty)
    h = k * db if hits is None else hits
    d = h if dirty is None else dirty
    assert nbytes == 4 * (n * width + h * width + d * width + k * db) \
        + k * plane
    assert abs(nbytes / 1e6 - want_mb) < 0.01
    assert ops == k * ca.fused_window_step_cost(n, db, w, z)[1]
    ms, by = ca.bound_ms(nbytes, ops)
    assert by == "bytes"
    if (k, db, hits) == (4, 128, None):
        assert abs(ms * 1e3 - 3.18) < 0.01


FAKE_NVCC = """#!/bin/sh
# stand-in nvcc: attention.cu waits until attribution.cu's build has
# started, so it ends only if the two run at once
src=""; out=""
while [ $# -gt 0 ]; do
  case "$1" in -o) out="$2"; shift;; *.cu) src="$1";; esac; shift
done
dir=$(dirname "$out")
case "$src" in
  *attribution.cu) touch "$dir/attribution.started";;
  *attention.cu)
    i=0
    while [ ! -e "$dir/attribution.started" ]; do
      i=$((i + 1)); [ $i -gt 100 ] && { echo "ran alone"; exit 1; }
      sleep 0.1
    done
    [ -n "$FAIL_ATTENTION" ] && { echo "error: boom"; exit 3; };;
esac
echo fake > "$out"
"""


def test_build_all_runs_one_nvcc_per_source_at_once(tmp_path, monkeypatch):
    from kepler_tpu_torch.ops import build

    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "ok")
    libs = build.build_all()
    assert set(libs) == set(build.sources()) == {"attention", "attribution",
                                                 "hi_lo"}
    assert all(path.exists() and path.parent == tmp_path / "ok"
               for path in libs.values())
    assert build.build_all() == libs  # built: nothing runs again

    # a failing source raises with nvcc's messages, after every nvcc ended
    monkeypatch.setenv("FAIL_ATTENTION", "1")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "failing")
    with pytest.raises(RuntimeError,
                       match=r"attention\.cu \(rc 3\):\nerror: boom"):
        build.build_all()
    leftover = {p.suffix for p in (tmp_path / "failing").iterdir()}
    assert ".tmp" in leftover  # attribution's nvcc ran to its end

