"""One rank of the port's cross-process collectives and parallel families.

``python tests/torch_dist_worker.py SUITE LAYOUT RANK WORLD ADDR IN OUT``
joins a gloo job of WORLD ranks at ADDR, reads its inputs from the
``.npz`` IN (written by the test, seeded numpy), runs SUITE over meshes
whose shards belong to the ranks as LAYOUT says, and writes what it
computed to the ``.npz`` OUT:

- ``collectives``: the four collectives of ``parallel.collectives`` on
  an 8-shard axis (``f"{case}/{shard}"`` per local shard), their
  gradients, the refused uneven split, and the traffic counters;
- ``families``: the ring (einsum and pallas), the ring's serving
  program, the sequence-parallel train step (with and without remat),
  Ulysses attention and its serving program, and the DP×TP train step;
  every rank writes the whole outputs;
- ``stages``: the GPipe pipeline (8 stages; 4 stages of 2 blocks), the
  pipelined deep estimator, expert parallelism (explicit and learned
  routing, capacity overflow, ids outside the experts, a NaN row) and
  the DP×TP train step with ``gather_params``, on meshes laid out as
  LAYOUT says (under ``interleaved`` every node row of the trainer spans
  both ranks), and what the device tier's recorder sees of the pipeline
  and the experts;
- ``indivisible``: the pipeline, the experts and the DP×TP step each
  given a batch that does not divide, then one pipeline call that does
  (each call's error and seconds, and the last call's output);
- ``hang``: rank 0 runs the ring while rank 1 never calls it: the ring
  must raise within the group's timeout (``seconds``, ``error``);
- ``alone``: rank 1 never starts, so rank 0's join fails within its
  timeout and a ring over both ranks' shards is refused (``error``);
- ``ring_cuda``: the ranks join NCCL on the card and run the pallas ring
  (kernel B3 on each rank's shards); a refused join writes NCCL's words
  (``error``);
- ``stages_cuda``: the same join, then the pipelined deep and expert
  parallelism on 8 shards of the card.

The same functions run in one process with ``layout=None`` (what the
tests compare with). ``tests/test_torch_dist_collectives.py`` and
``tests/test_torch_dist_families.py`` and
``tests/test_torch_dist_stages.py`` spawn the ranks, each spawn under
its own time limit (:func:`spawn`). Imports no JAX.
"""

from __future__ import annotations

import os
import pathlib
import socket
import subprocess
import sys
import time

import numpy as np
import torch

from kepler_tpu_torch.analysis.device.trace import OpRecorder
from kepler_tpu_torch.models import train
from kepler_tpu_torch.models.estimator import params_from_numpy
from kepler_tpu_torch.ops import recorder
from kepler_tpu_torch.models.deep import block_fn
from kepler_tpu_torch.parallel import (gather_params,
                                       make_distributed_train_step,
                                       make_expert_parallel_moe,
                                       make_mesh, make_pipeline,
                                       make_pipelined_deep,
                                       make_ring_attention,
                                       make_sequence_parallel_train_step,
                                       make_temporal_program,
                                       make_ulysses_attention,
                                       make_ulysses_temporal_program,
                                       shard_train_state, top1_route)
from kepler_tpu_torch.parallel import collectives as col
from kepler_tpu_torch.parallel.mesh import Shard, initialize_multihost

REPO = pathlib.Path(__file__).resolve().parent.parent
#: the group's timeout (s) and each spawn's limit
GROUP_TIMEOUT_S, SPAWN_LIMIT_S = 60, 60
HANG_TIMEOUT_S = 8
#: a shard's rank by layout, for a mesh of n shards over two ranks
LAYOUTS = {"blocks": lambda k, n: k // (n // 2),
           "interleaved": lambda k, n: k % 2}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
F32 = torch.float32


def mesh(n: int, axes=("seq",), shape=None, layout: str | None = None,
         device: str = "cpu"):
    """An n-shard mesh of ``device``: this process's (``layout=None``),
    or two ranks' as ``LAYOUTS[layout]`` assigns them."""
    dev = torch.device(device)
    devices = ([dev] * n if layout is None else
               [Shard(dev, LAYOUTS[layout](k, n)) for k in range(n)])
    return make_mesh(list(shape or [n]), list(axes), devices=devices)


def _t(a: dict, key: str) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a[key]))


def _numpy(x: torch.Tensor) -> np.ndarray:
    return x.detach().to(F32 if x.dtype == torch.bfloat16 else x.dtype
                         ).numpy()


def _params(a: dict, prefix: str, mode: str, device: str = "cpu") -> dict:
    """The params stored under ``prefix`` (deep's ``blocks/`` nested), on
    ``device``."""
    flat: dict = {}
    for key, val in a.items():
        if key.startswith(prefix):
            *outer, leaf = key[len(prefix):].split("/")
            node = flat
            for part in outer:
                node = node.setdefault(part, {})
            node[leaf] = val
    return params_from_numpy(mode, flat, device)


def _put(out: dict, case: str, slots: list) -> None:
    for i, x in enumerate(slots):
        if x is not None:
            out[f"{case}/{i}"] = _numpy(x)


# -- collectives ----------------------------------------------------------------


def run_collectives(a: dict, layout: str | None) -> dict:
    """Every collective on seeded per-shard inputs → ``{case/shard:
    array}`` for this rank's shards, and the uneven split's error."""
    devs = col.axis_devices(mesh(8, layout=layout), "seq")

    def shards(key, dtype=None):
        whole = _t(a, key)
        return col.local_map(devs, lambda i: whole[i].clone() if dtype is None
                             else whole[i].to(dtype))

    out: dict = {}
    xs, bf, mask, ints = (shards("x"), shards("x", torch.bfloat16),
                          shards("mask"), shards("ints"))
    for shift in (1, 3, -2):
        _put(out, f"ppermute_shift{shift}", col.ppermute(xs, devs, shift))
    _put(out, "ppermute_bf16", col.ppermute(bf, devs))
    _put(out, "ppermute_bool", col.ppermute(mask, devs))
    holes = [None if i == 5 else x for i, x in enumerate(xs)]
    got = col.ppermute(holes, devs)
    _put(out, "ppermute_none", got)
    out["ppermute_none_slots"] = np.array(
        [i for i in col.local_indices(devs) if got[i] is None])
    _put(out, "all_to_all", col.all_to_all(xs, devs, 1, 0))
    _put(out, "all_to_all_bf16", col.all_to_all(bf, devs, 1, 0))
    _put(out, "all_to_all_concat2", col.all_to_all(xs, devs, 1, 2))
    _put(out, "all_to_all_untiled",
         col.all_to_all(shards("u"), devs, 0, 1, tiled=False))
    _put(out, "all_gather", col.all_gather(xs, devs, axis=1))
    _put(out, "all_gather_bf16", col.all_gather(bf, devs, axis=0))
    _put(out, "all_gather_bool", col.all_gather(mask, devs, axis=0))
    _put(out, "psum", col.psum(xs, devs))
    _put(out, "psum_bf16", col.psum(bf, devs))
    _put(out, "psum_int64", col.psum(ints, devs))
    try:
        col.all_to_all(shards("uneven"), devs, 1, 0)
        out["uneven_error"] = np.array("no error")
    except ValueError as err:
        out["uneven_error"] = np.array(str(err))
    # gradients through a chain of all four: each rank backpropagates
    # its own shards' share of one objective
    leaves = col.local_map(devs, lambda i: xs[i].clone().requires_grad_())
    ys = col.psum(col.all_gather(col.all_to_all(
        col.ppermute(leaves, devs, 1), devs, 1, 0), devs, axis=0), devs)
    w = shards("w")
    sum(ys[i].mul(w[i]).sum() for i in col.local_indices(devs)).backward()
    _put(out, "grad", [None if x is None else x.grad for x in leaves])
    return out


# -- the families ---------------------------------------------------------------


def _run_trainer(a: dict, layout: str | None, out: dict) -> None:
    grid = mesh(8, ("node", "model"), (4, 2), layout)
    out["dp_tp_rows_across_ranks"] = np.array(sum(
        len(set(col.ranks_of(row))) > 1
        for row in col.grid_devices(grid, ("node", "model"))))
    batches = [tuple(_t(a, f"dp/{k}{s}") for k in ("x", "valid", "y"))
               for s in range(3)]
    for cd in ("bf16", "f32"):
        state = shard_train_state(train.create_train_state(
            params_from_numpy("mlp", {k[3:]: v for k, v in a.items()
                                      if k.startswith("mp/")}),
            train.make_optimizer(1e-2)), grid)
        step = make_distributed_train_step(grid, compute_dtype=DTYPES[cd])
        losses = []
        for batch in batches:
            state, loss = step(state, *batch)
            losses.append(float(loss))
        out[f"dp_tp_{cd}/losses"] = np.array(losses)
        for k, v in gather_params(state).items():
            out[f"dp_tp_{cd}/{k}"] = _numpy(v)


def run_families(a: dict, layout: str | None) -> dict:
    """The ring, sequence and Ulysses programs and the two train steps
    → their whole outputs (every rank computes them)."""
    out: dict = {}
    m8 = mesh(8, layout=layout)
    qkv = [_t(a, f"ring/{k}") for k in ("q", "k", "v", "tv")]
    for cd, dtype in DTYPES.items():
        out[f"ring_{cd}"] = _numpy(make_ring_attention(
            m8, compute_dtype=dtype)(*qkv))
    out["ring_pallas_f32"] = _numpy(make_ring_attention(
        m8, compute_dtype=F32, backend="pallas")(*qkv))
    params = {k[3:]: v for k, v in a.items() if k.startswith("tp/")}
    tp = params_from_numpy("temporal", params)
    serve = [_t(a, f"sp/{k}") for k in ("hist", "wv", "tv")]
    targets = _t(a, "sp/targets")
    for cd, dtype in DTYPES.items():
        out[f"serve_{cd}"] = _numpy(make_temporal_program(
            m8, compute_dtype=dtype)(tp, *serve))
    # the serving program as the device tier's recorder sees it
    rec = OpRecorder([])
    with recorder.recording(rec), rec:
        make_temporal_program(m8, compute_dtype=F32)(tp, *serve)
    out["recorded/collectives"] = np.array(sorted(rec.collectives))
    out["recorded/crossings"] = np.array(
        [rec.ops.get(f"crossing:{c}", 0) for c in ("ppermute", "psum")])
    m8x = mesh(8, layout=layout and "interleaved")
    out["ring_f32_interleaved"] = _numpy(make_ring_attention(
        m8x, compute_dtype=F32)(*qkv))
    out["serve_f32_interleaved"] = _numpy(make_temporal_program(
        m8x, compute_dtype=F32)(tp, *serve))
    for remat in (False, True):
        state = train.create_train_state(params_from_numpy(
            "temporal", params), train.make_optimizer(1e-2))
        step = make_sequence_parallel_train_step(m8, remat=remat)
        losses = []
        for _ in range(2):
            state, loss = step(state, *serve, targets)
            losses.append(float(loss))
        out[f"sp_remat{int(remat)}/losses"] = np.array(losses)
        for k, v in state.params.items():
            out[f"sp_remat{int(remat)}/{k}"] = _numpy(v)
            out[f"sp_remat{int(remat)}/grad/{k}"] = _numpy(v.grad)
    m4 = mesh(4, layout=layout)
    uqkv = [_t(a, f"uly/{k}") for k in ("q", "k", "v", "tv")]
    for cd, dtype in DTYPES.items():
        out[f"ulysses_{cd}"] = _numpy(make_ulysses_attention(
            m4, compute_dtype=dtype)(*uqkv))
    out["ulysses_serve_f32"] = _numpy(make_ulysses_temporal_program(
        m4, compute_dtype=F32)(tp, *serve))
    _run_trainer(a, layout, out)
    return out


def _f32_stage(blk, h):
    return block_fn(blk, h, F32)


def _pipelines(a: dict, layout: str | None, device: str, out: dict,
               dtypes=DTYPES) -> None:
    """The pipelined deep on 8 stages at each of ``dtypes`` →
    ``out[f"deep_{cd}"]``."""
    deep = _params(a, "pp/", "deep", device)
    feats, valid = (_t(a, f"pp_in/{k}").to(device) for k in ("feats", "valid"))
    for cd, dtype in dtypes.items():
        out[f"deep_{cd}"] = _numpy(make_pipelined_deep(
            mesh(8, ("stage",), layout=layout, device=device),
            n_microbatches=4, compute_dtype=dtype)(deep, feats,
                                                   valid).cpu())


def _experts(a: dict, layout: str | None, device: str, out: dict,
             cases=None) -> None:
    """Expert parallelism on 8 shards → ``out[f"expert_{case}"]``:
    explicit ids at f32 and bf16, learned top-1, capacity overflow,
    ids outside the experts and a NaN row."""
    moe = _params(a, "ep/", "moe", device)
    feats = _t(a, "ep_in/feats").to(device)
    ones = torch.ones(feats.shape[0], device=device)
    eid = _t(a, "ep_in/eid").to(device)
    ep = make_expert_parallel_moe(mesh(8, ("expert",), layout=layout,
                                       device=device), compute_dtype=F32)
    runs = {
        "explicit_f32": lambda: ep(moe, feats, eid, ones),
        "explicit_bf16": lambda: make_expert_parallel_moe(
            mesh(8, ("expert",), layout=layout, device=device))(
            moe, feats, eid, ones),
        "top1": lambda: ep(moe, feats, *top1_route(moe, feats)),
        "overflow": lambda: make_expert_parallel_moe(
            mesh(8, ("expert",), layout=layout, device=device),
            capacity_factor=0.5, compute_dtype=F32)(
            moe, feats, torch.zeros_like(eid), ones),
        "outside": lambda: ep(moe, feats, _t(a, "ep_in/outside").to(device),
                              ones),
        "nan": lambda: ep(moe, _t(a, "ep_in/nan_feats").to(device), eid,
                          ones)}
    for case in cases or runs:
        out[f"expert_{case}"] = _numpy(runs[case]().cpu())


def _recorded(out: dict, label: str, fn, names: tuple) -> None:
    """What the device tier's recorder sees of ``fn()``: the collectives
    and the ``crossing:<name>`` ops of ``names``."""
    rec = OpRecorder([])
    with recorder.recording(rec), rec:
        fn()
    out[f"recorded_{label}/collectives"] = np.array(sorted(rec.collectives))
    out[f"recorded_{label}/crossings"] = np.array(
        [rec.ops.get(f"crossing:{c}", 0) for c in names])


def run_stages(a: dict, layout: str | None) -> dict:
    """The pipeline, the experts and the DP×TP step on meshes laid out
    as ``layout`` says → their whole outputs (every rank computes them)."""
    out: dict = {}
    blocks = _params(a, "pp/", "deep")["blocks"]
    x = _t(a, "pp_in/x")
    for n in (8, 4):  # 8 stages of one block; 4 of two
        out[f"pipeline_{n}"] = _numpy(make_pipeline(
            mesh(n, ("stage",), layout=layout), _f32_stage,
            n_microbatches=4)(blocks, x))
    _pipelines(a, layout, "cpu", out)
    _experts(a, layout, "cpu", out)
    deep = _params(a, "pp/", "deep")
    pp_in = (_t(a, "pp_in/feats"), _t(a, "pp_in/valid"))
    _recorded(out, "pipeline", lambda: make_pipelined_deep(
        mesh(8, ("stage",), layout=layout), compute_dtype=F32)(deep, *pp_in),
        ("ppermute", "broadcast"))
    moe = _params(a, "ep/", "moe")
    feats = _t(a, "ep_in/feats")
    _recorded(out, "expert", lambda: make_expert_parallel_moe(
        mesh(8, ("expert",), layout=layout), compute_dtype=F32)(
        moe, feats, _t(a, "ep_in/eid"), torch.ones(feats.shape[0])),
        ("all_to_all", "all_gather"))
    _run_trainer(a, layout, out)
    out["layout"] = np.array(str(layout))
    return out


def run_indivisible(a: dict, layout: str | None) -> dict:
    """Each family given a batch that does not divide (16 rows in 3
    microbatches, 60 rows over 8 expert shards, 6 nodes over 4 node
    rows) → each call's error and seconds; then one pipeline call that
    divides, to show both ranks are still in step."""
    blocks = _params(a, "pp/", "deep")["blocks"]
    x = _t(a, "pp_in/x")
    moe = _params(a, "ep/", "moe")
    feats = _t(a, "ep_in/feats")[:60]
    grid = mesh(8, ("node", "model"), (4, 2), layout)
    state = shard_train_state(train.create_train_state(
        _params(a, "mp/", "mlp"), train.make_optimizer(1e-2)), grid)
    calls = {
        "pipeline": lambda: make_pipeline(
            mesh(8, ("stage",), layout=layout), _f32_stage,
            n_microbatches=3)(blocks, x),
        "expert": lambda: make_expert_parallel_moe(
            mesh(8, ("expert",), layout=layout))(
            moe, feats, torch.zeros(60, dtype=torch.int32),
            torch.ones(60)),
        "trainer": lambda: make_distributed_train_step(grid)(
            state, *(_t(a, f"dp/{k}0")[:6] for k in ("x", "valid", "y")))}
    out: dict = {}
    for name, call in calls.items():
        t0 = time.monotonic()
        try:
            call()
            error = "no error"
        except Exception as err:  # the test reads what was raised
            error = f"{type(err).__name__}: {err}"[:400]
        out[f"{name}/error"] = np.array(error)
        out[f"{name}/seconds"] = np.array(time.monotonic() - t0)
    out["after"] = _numpy(make_pipeline(
        mesh(8, ("stage",), layout=layout), _f32_stage,
        n_microbatches=4)(blocks, x))
    return out


def run_hang(a: dict, layout: str | None) -> dict:
    """Rank 0 runs the ring; rank 1 joined the group but never calls
    it. → how long rank 0 waited and what it raised."""
    if torch.distributed.get_rank() != 0:
        time.sleep(HANG_TIMEOUT_S + 5)  # past rank 0's timeout
        return {}
    qkv = [_t(a, f"ring/{k}") for k in ("q", "k", "v", "tv")]
    t0 = time.monotonic()
    try:
        make_ring_attention(mesh(8, layout=layout), compute_dtype=F32)(*qkv)
        error = "no error"
    except Exception as err:  # the group's timeout, whatever its type
        error = f"{type(err).__name__}: {err}"[:400]
    return {"seconds": np.array(time.monotonic() - t0),
            "error": np.array(error)}


def run_alone(a: dict, layout: str | None) -> dict:
    """This rank's peer never joined: the ring over both ranks' shards
    → what building it raised."""
    try:
        make_ring_attention(mesh(8, layout=layout))
        return {"error": np.array("no error")}
    except ValueError as err:
        return {"error": np.array(str(err))}


def run_ring_cuda(a: dict, layout: str | None) -> dict:
    """The pallas ring on 8 shards of the card → its output and the B3
    launches this rank made (each rank's shards' blocks)."""
    from kepler_tpu_torch.ops import cuda_attention as cat

    qkv = [_t(a, f"ring/{k}").to("cuda:0") for k in ("q", "k", "v", "tv")]
    ring = make_ring_attention(mesh(8, layout=layout, device="cuda:0"),
                               backend="pallas")
    before = dict(cat.LAUNCHES)
    got = ring(*qkv)
    torch.cuda.synchronize()
    return {"ring": _numpy(got.cpu()),
            **{f"launches/{k}": np.array(v - before[k])
               for k, v in cat.LAUNCHES.items()}}


def run_stages_cuda(a: dict, layout: str | None) -> dict:
    """The pipelined deep (f32) and expert parallelism (explicit ids at
    f32) on 8 shards of the card → their outputs."""
    out: dict = {}
    _pipelines(a, layout, "cuda:0", out, dtypes={"f32": F32})
    _experts(a, layout, "cuda:0", out, cases=("explicit_f32",))
    torch.cuda.synchronize()
    return out


SUITES = {"collectives": run_collectives, "families": run_families,
          "stages": run_stages, "indivisible": run_indivisible,
          "hang": run_hang, "alone": run_alone, "ring_cuda": run_ring_cuda,
          "stages_cuda": run_stages_cuda}
#: suites with the short group timeout
SHORT = ("hang", "alone", "indivisible")


def spawn(suite: str, layout: str, inputs: pathlib.Path,
          tmp: pathlib.Path, world: int = 2,
          limit_s: float = SPAWN_LIMIT_S,
          host_ids: bool = False) -> list[dict]:
    """Run ``suite`` on ``world`` ranks over gloo on 127.0.0.1 (the
    ``*_cuda`` suites: gloo and NCCL) → each rank's outputs (suite ``alone``: rank 0 only).
    ``host_ids`` gives each rank its own ``NCCL_HOSTID``, so that NCCL
    takes two ranks on one card. Each rank runs one intra-op thread, so
    that the ranks beside other test processes do not contend for the
    host's cores. Every rank is killed at ``limit_s``; a rank that fails
    fails the spawn with its stderr."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        addr = f"127.0.0.1:{s.getsockname()[1]}"
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    env["PYTHONPATH"] = str(REPO)
    env["OMP_NUM_THREADS"] = "1"
    started = 1 if suite == "alone" else world
    outs = [tmp / f"{suite}-{layout}-rank{r}.npz" for r in range(started)]
    procs = [subprocess.Popen(
        [sys.executable, __file__, suite, layout, str(r), str(world), addr,
         str(inputs), str(outs[r])], cwd=str(REPO),
        env=dict(env, NCCL_HOSTID=f"kepler-test-rank-{r}") if host_ids
        else env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(started)]
    deadline = time.monotonic() + limit_s
    try:
        logs = [p.communicate(timeout=max(1.0, deadline - time.monotonic()))
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (_, err)) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}: {err[-3000:]}"
    result = []
    for path in outs:
        with np.load(path) as npz:
            result.append({k: npz[k] for k in npz.files})
    return result


def main(argv: list[str]) -> int:
    suite, layout = argv[0], argv[1]
    rank, world, addr = int(argv[2]), int(argv[3]), argv[4]
    timeout = HANG_TIMEOUT_S if suite in SHORT else GROUP_TIMEOUT_S
    t0 = time.monotonic()
    try:
        joined = initialize_multihost(
            coordinator_address=addr, num_processes=world, process_id=rank,
            init_timeout=timeout,
            device="cuda" if suite.endswith("_cuda") else None)
    except RuntimeError as err:  # NCCL refused: what it said is the result
        np.savez(argv[6], error=np.array(str(err)))
        return 0
    join_s = time.monotonic() - t0
    if bool(joined) == (suite == "alone"):
        print(f"rank {rank}: join: {joined}", file=sys.stderr)
        return 2
    with np.load(argv[5]) as npz:
        arrays = {k: npz[k] for k in npz.files}
    col.reset_crossing()
    out = SUITES[suite](arrays, layout)
    out["join_s"] = np.array(join_s)
    out["join"] = np.array(joined.reason)
    for name, row in col.CROSSING.items():
        for key, val in row.items():
            out[f"crossing/{name}/{key}"] = np.array(val)
    out["leaked"] = np.array(sorted(
        m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "kepler_tpu")), dtype=str)
    np.savez(argv[6], **out)
    if suite not in ("hang", "alone"):
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
