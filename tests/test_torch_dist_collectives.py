"""The four collectives across two processes equal the same collectives
in one process.

Two ranks join a gloo job on 127.0.0.1 (``tests/torch_dist_worker.py``,
each spawn under its own 60 s limit) and run ``ppermute``,
``all_to_all``, ``all_gather`` and ``psum`` of
``kepler_tpu_torch.parallel.collectives`` over an 8-shard axis whose
shards the ranks own in blocks (0-3 and 4-7) or interleaved (even and
odd). Each rank writes its own shards' results; every one must equal,
bit for bit, the one-process result on the same seeded numpy inputs:
f32, bf16 (carried over gloo as f32), bools (as uint8) and int64, a
``None`` slot in ``ppermute``, both forms of ``all_to_all``. An uneven
split raises ValueError on every rank, as it does in one process. The
gradients through a chain of the four agree within rtol 1e-5, atol 1e-5
· max|grad|: each is a sum of the 8 shards' terms, which the transposes
add in shard order and one process's autograd in its own order (f32
rounding of 8-term sums); the forward values are bit-equal.
"""

from __future__ import annotations

import numpy as np
import pytest

from tests import torch_dist_worker as worker

LAYOUTS = list(worker.LAYOUTS)
CASES = ["ppermute_shift1", "ppermute_shift3", "ppermute_shift-2",
         "ppermute_bf16", "ppermute_bool", "ppermute_none", "all_to_all",
         "all_to_all_bf16", "all_to_all_concat2", "all_to_all_untiled",
         "all_gather", "all_gather_bf16", "all_gather_bool", "psum",
         "psum_bf16", "psum_int64"]


def inputs(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(8, 3, 16, 4)).astype(np.float32)
    x[2, 0, :3] = -0.0  # signed zeros survive every path
    return {"x": x,
            "mask": rng.random((8, 5, 6)) > 0.5,
            "ints": rng.integers(-1000, 1000, (8, 7), dtype=np.int64),
            "u": rng.normal(size=(8, 8, 3, 5)).astype(np.float32),
            "uneven": rng.normal(size=(8, 3, 12)).astype(np.float32),
            "w": rng.normal(size=(8, 192, 2, 4)).astype(np.float32)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(one-process results, {layout: [rank 0's, rank 1's]})."""
    tmp = tmp_path_factory.mktemp("dist_collectives")
    arrays = inputs()
    np.savez(tmp / "in.npz", **arrays)
    ranks = {layout: worker.spawn("collectives", layout, tmp / "in.npz", tmp)
             for layout in LAYOUTS}
    return worker.run_collectives(arrays, None), ranks


def shard_results(ranks: list[dict], case: str) -> dict[int, np.ndarray]:
    """``{shard: result}`` over both ranks; each shard from one rank."""
    got: dict[int, np.ndarray] = {}
    for out in ranks:
        for key, val in out.items():
            name, _, shard = key.rpartition("/")
            if name == case:
                assert int(shard) not in got, f"{key} from both ranks"
                got[int(shard)] = val
    return got


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("case", CASES)
def test_collective_across_ranks_equals_one_process(runs, case, layout):
    one, ranks = runs
    got = shard_results(ranks[layout], case)
    want = shard_results([one], case)
    assert sorted(got) == sorted(want)
    for shard, val in want.items():
        assert got[shard].dtype == val.dtype
        # bit-equal: the byte patterns, signed zeros included
        np.testing.assert_array_equal(got[shard].view(np.uint8),
                                      val.view(np.uint8),
                                      err_msg=f"{case} shard {shard}")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_none_slot_reaches_its_receiver_as_none(runs, layout):
    _, ranks = runs
    empty = set()
    for out in ranks[layout]:
        empty |= set(out["ppermute_none_slots"].tolist())
    assert empty == {6}  # shard 5 held None: shard 6 receives None


@pytest.mark.parametrize("layout", LAYOUTS)
def test_uneven_split_raises_on_every_rank_as_in_one_process(runs, layout):
    one, ranks = runs
    assert "does not split into 8 equal chunks" in str(one["uneven_error"])
    for out in ranks[layout]:
        assert str(out["uneven_error"]) == str(one["uneven_error"])


@pytest.mark.parametrize("layout", LAYOUTS)
def test_gradients_through_the_four_across_ranks(runs, layout):
    one, ranks = runs
    got = shard_results(ranks[layout], "grad")
    want = shard_results([one], "grad")
    assert sorted(got) == list(range(8))
    for shard, val in want.items():
        np.testing.assert_allclose(got[shard], val, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(val).max()),
                                   err_msg=f"grad shard {shard}")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_every_collective_crossed_and_counted_its_bytes(runs, layout):
    _, ranks = runs
    for out in ranks[layout]:
        assert out["leaked"].size == 0, out["leaked"]
        for name in ("ppermute", "all_to_all", "all_gather", "psum"):
            assert int(out[f"crossing/{name}/calls"]) > 0, name
            assert int(out[f"crossing/{name}/bytes"]) > 0, name
