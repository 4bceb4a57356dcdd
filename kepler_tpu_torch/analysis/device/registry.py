"""The device-program registry: what the port's device tier runs, and each
program's declared contract.

One :class:`ProgramSpec` per program of the reference package's registry,
under the same name, with the same cases (names and dims) and the same
contract, each building the PORT's program. Every case runs once on
seeded inputs at its tiny shapes (``trace.trace_case``); inputs are drawn
on the CPU from the case's seed and then moved, so a case gets the same
inputs on every device. Mesh entries run over virtual shards of the
chosen device (``make_mesh([8], devices=[dev] * 8)``), as the port's mesh
does on one card. The contract the KTL120-123 checks enforce:

- ``donates`` — user-level argument positions the program updates IN
  PLACE (the port's form of the reference's donated buffers); KTL121
  requires every flat tensor leaf of those args to be updated in place
  with no whole copy of it made, and no other arg to be updated.
- ``allowed_collectives`` — the complete set of ``parallel.collectives``
  the program may call (KTL122). Empty means "communication-free": the
  only cross-shard step in a fleet window is the caller's result fetch.
- ``allowed_half_casts`` — the half-precision cast pairs that are
  DECLARED boundaries (the packed f16 wire quantizer; the bf16 operand
  rounding of ``models.nn.acc_matmul``, which in the port rounds an f32
  operand to bf16 and back before an f32 product, so both directions
  appear). Any other half cast — and any half product or reduction,
  which no entry may allow — is a KTL120 finding.
- ``require_shard_map`` — the program runs per-shard bodies (the
  counterpart of a ``shard_map``): losing them fails KTL122.

Contracts differ from the reference's only where the port spells out
what GSPMD inserts at partitioning time: the DP×TP train step's gradient
all-reduce is an explicit ``psum`` here.

Builders import the program modules lazily, so importing the analysis
package (rule registration) stays free of model and kernel code.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

#: packed fleet programs quantize to the f16 wire format exactly once
_F16_OUT = frozenset({"float32->float16"})
#: bf16 operand rounding (``acc_matmul``: f32 → bf16 → f32, f32
#: products); a training step carries the same pair
_BF16_OPS = frozenset({"float32->bfloat16", "bfloat16->float32"})

_N_FEATURES = 7


@dataclass(frozen=True)
class ProgramCase:
    """One representative shape point for a spec (name + build knobs)."""

    name: str
    note: str = ""
    dims: dict[str, Any] = field(default_factory=dict)


@dataclass(frozen=True)
class ProgramSpec:
    """One registered device program + its declared contract."""

    name: str
    source: str  # repo-relative module the program lives in
    description: str
    # (case, device) → (program, args): the args are real tensors on
    # the device, drawn from the case's seed
    build: Callable[[ProgramCase, torch.device], tuple]
    cases: tuple[ProgramCase, ...]
    donates: tuple[int, ...] = ()
    allowed_collectives: frozenset[str] = frozenset()
    allowed_half_casts: frozenset[str] = frozenset()
    require_shard_map: bool = False
    kernels: tuple[str, ...] = ()  # hand kernels the program launches


# ---------------------------------------------------------------------------
# builder helpers
# ---------------------------------------------------------------------------


def _rng(case: ProgramCase) -> np.random.RandomState:
    """The case's input stream: the same on every run and device."""
    return np.random.RandomState(zlib.crc32(repr(
        (case.name, sorted(case.dims.items()))).encode()))


def _gen(rng: np.random.RandomState) -> torch.Generator:
    return torch.Generator().manual_seed(int(rng.randint(2 ** 31)))


def _on(x: Any, dev: torch.device) -> Any:
    """Host tensors (nested dicts too) → copies on ``dev``."""
    if isinstance(x, dict):
        return {k: _on(v, dev) for k, v in x.items()}
    return x.to(dev, copy=True)


def _t(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _mesh(n: int, dev: torch.device, axes: tuple[str, ...] = ("node",),
          shape: tuple[int, ...] | None = None) -> Any:
    from kepler_tpu_torch.parallel.mesh import make_mesh

    count = 1
    for s in shape or (n,):
        count *= s
    return make_mesh(list(shape or (n,)), list(axes), devices=[dev] * count)


def _packed_rows(rng: np.random.RandomState, n: int, w: int, z: int,
                 model: bool) -> np.ndarray:
    """Seeded packed fleet rows: NaN cpu slots, valid and invalid zones,
    ratio and model nodes, one pad row (dt = 0)."""
    from kepler_tpu_torch.parallel.packed import PackedLayout

    lay = PackedLayout(w, z)
    rows = np.zeros((n, lay.width), np.float32)
    cpu = rng.uniform(0, 5e5, (n, w)).astype(np.float32)
    cpu[rng.uniform(size=(n, w)) < 0.25] = np.nan
    rows[:, lay.cpu] = cpu
    rows[:, lay.zone] = rng.uniform(1e6, 5e7, (n, z))
    rows[:, lay.zone_valid] = rng.uniform(size=(n, z)) < 0.9
    rows[:, lay.col_ratio] = rng.uniform(0.2, 0.9, n)
    rows[:, lay.col_denom] = np.nansum(cpu, axis=1) + rng.uniform(0, 1e5, n)
    rows[:, lay.col_dt] = rng.uniform(0.5, 2.0, n)
    rows[:, lay.col_mode] = (rng.uniform(size=n) < 0.5) if model else 0.0
    rows[-1] = lay.empty_row()
    return rows


def _params(mode: str, z: int, rng: np.random.RandomState,
            dev: torch.device, **kw: Any) -> dict:
    from kepler_tpu_torch.models.deep import init_deep
    from kepler_tpu_torch.models.mlp import init_mlp
    from kepler_tpu_torch.models.moe import init_moe
    from kepler_tpu_torch.models.temporal import init_temporal

    init = {"mlp": init_mlp, "temporal": init_temporal, "deep": init_deep,
            "moe": init_moe}[mode]
    return _on(init(z, generator=_gen(rng), **kw), dev)


def _no_params(dev: torch.device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=dev)


def _fleet_batch(rng: np.random.RandomState, n: int, w: int, z: int,
                 dev: torch.device) -> tuple:
    cpu = rng.uniform(0, 5e5, (n, w)).astype(np.float32)
    valid = rng.uniform(size=(n, w)) < 0.8
    return (
        _t(rng.uniform(1e6, 5e7, (n, z)).astype(np.float32), dev),
        _t(rng.uniform(size=(n, z)) < 0.9, dev),
        _t(rng.uniform(0.2, 0.9, n).astype(np.float32), dev),
        _t(cpu, dev),
        _t(valid, dev),
        _t((cpu * valid).sum(1).astype(np.float32)
           + rng.uniform(0, 1e5, n).astype(np.float32), dev),
        _t(rng.uniform(0.5, 2.0, n).astype(np.float32), dev),
        _t((rng.uniform(size=n) < 0.5).astype(np.int32), dev),
    )


def _feats(rng: np.random.RandomState, *shape: int) -> np.ndarray:
    return rng.uniform(0, 1, shape + (_N_FEATURES,)).astype(np.float32)


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------


def _build_packed(case: ProgramCase, dev: torch.device) -> tuple:
    from kepler_tpu_torch.parallel.packed import make_packed_fleet_program

    d = case.dims
    nb, wb, z = d["n"], d["w"], d["z"]
    mb = d.get("m")
    model_mode = d.get("model_mode")
    backend = d.get("backend", "einsum")
    local = bool(d.get("local", 0))
    rng = _rng(case)
    params = (_params(model_mode, z, rng, dev) if model_mode
              else _no_params(dev))
    rows = _packed_rows(rng, nb, wb, z, model=bool(model_mode))
    # the reference's sharded programs (shard_map: the pallas backend and
    # the shard-local sparse variant) run per shard here; its GSPMD dense
    # programs are one program over the whole node axis, here on one device
    if not (local or backend == "pallas"):
        fn = make_packed_fleet_program(
            wb, z, model_mode=model_mode, backend=backend,
            model_bucket=mb, device=dev)
        args: list = [params, _t(rows, dev)]
        if mb is not None:
            args.append(_t(np.sort(rng.choice(nb + 1, mb, replace=False))
                           .astype(np.int32), dev))
        return fn, tuple(args)
    n_seg = d.get("devices", 8)
    mesh = _mesh(n_seg, dev)
    fn = make_packed_fleet_program(
        wb, z, model_mode=model_mode, backend=backend, model_bucket=mb,
        device=dev, mesh=mesh, local_model_rows=local)
    sb = nb // n_seg
    blocks = [_t(rows[k * sb:(k + 1) * sb], dev) for k in range(n_seg)]
    args = [[params] * n_seg, blocks]
    if mb is not None:
        # shard-local row indices, padded with the shard's row count
        args.append([_t(np.sort(rng.choice(sb + 1, mb, replace=False))
                        .astype(np.int32), dev) for _ in range(n_seg)])
    return fn, tuple(args)


def _build_window_update(case: ProgramCase, dev: torch.device) -> tuple:
    from kepler_tpu_torch.fleet.window import (MultiHostWindowEngine,
                                               PackedWindowEngine,
                                               ShardedWindowEngine)
    from kepler_tpu_torch.parallel.packed import packed_width

    d = case.dims
    nb, wb, z, db = d["n"], d["w"], d["z"], d["db"]
    width = packed_width(wb, z)
    if d.get("multihost"):
        # virtual 2-host split over 8 shards, from process 0's view: the
        # host-local in-place scatter on owned shards only
        engine: Any = MultiHostWindowEngine(
            _mesh(8, dev), process_index=0,
            device_process=lambda k: 0 if k < 4 else 1)
    elif d.get("sharded"):
        engine = ShardedWindowEngine(_mesh(8, dev))
    else:
        engine = PackedWindowEngine(dev)
    fn = engine._update_for(nb, width, db)[0]
    rng = _rng(case)
    rows = _packed_rows(rng, nb + db, wb, z, model=False)
    # distinct target rows, the last one a pad (N → dropped)
    idx = rng.choice(nb, db, replace=False).astype(np.int32)
    idx[-1] = nb
    return fn, (_t(rows[:nb], dev), _t(rows[nb:], dev), _t(idx, dev))


def _fused_deltas(rng: np.random.RandomState, k: int, db: int, nb: int,
                  wb: int, z: int, model: bool) -> tuple:
    rows = _packed_rows(rng, k * db + 1, wb, z, model)[:k * db]
    idx = np.stack([rng.choice(nb, db, replace=False) for _ in range(k)]
                   ).astype(np.int32)
    idx[:, -1] = nb  # each interval's last slot is a pad
    return rows.reshape(k, db, -1), idx


def _build_fused(case: ProgramCase, dev: torch.device) -> tuple:
    from kepler_tpu_torch.parallel.packed import make_fused_window_program

    d = case.dims
    nb, wb, z, k, db = d["n"], d["w"], d["z"], d["k"], d["db"]
    mb = d.get("m")
    model_mode = d.get("model_mode")
    rng = _rng(case)
    fn = make_fused_window_program(
        wb, z, model_mode=model_mode, backend=d.get("backend", "einsum"),
        model_bucket=mb, device=dev)
    params = (_params(model_mode, z, rng, dev) if model_mode
              else _no_params(dev))
    resident = _packed_rows(rng, nb, wb, z, model=bool(model_mode))
    rows, idx = _fused_deltas(rng, k, db, nb, wb, z, bool(model_mode))
    args: list = [params, _t(resident, dev), _t(rows, dev), _t(idx, dev)]
    if mb is not None:
        args.append(_t(np.stack([
            np.sort(rng.choice(nb + 1, mb, replace=False))
            for _ in range(k)]).astype(np.int32), dev))
    return fn, tuple(args)


def _build_fleet(case: ProgramCase, dev: torch.device) -> tuple:
    from kepler_tpu_torch.parallel.aggregator_core import (
        make_fleet_program, make_temporal_fleet_program)

    d = case.dims
    n, w, z = d["n"], d["w"], d["z"]
    rng = _rng(case)
    batch = _fleet_batch(rng, n, w, z, dev)
    if d.get("temporal"):
        t = d["t"]
        fn = make_temporal_fleet_program(dev)
        return fn, (_params("temporal", z, rng, dev),) + batch + (
            _t(_feats(rng, n, w, t), dev),
            _t(rng.uniform(size=(n, w, t)) < 0.8, dev))
    fn = make_fleet_program(dev, model_mode="mlp")
    return fn, (_params("mlp", z, rng, dev),) + batch


def _build_pallas_attribution(case: ProgramCase, dev: torch.device
                              ) -> tuple:
    from kepler_tpu_torch.ops.cuda_attribution import attribute_fleet_pallas

    d = case.dims
    rng = _rng(case)
    return attribute_fleet_pallas, _fleet_batch(rng, d["n"], d["w"], d["z"],
                                                dev)[:7]


def _qkv(case: ProgramCase, dev: torch.device) -> tuple:
    d = case.dims
    b, t, h, dh = d["b"], d["t"], d["h"], d["dh"]
    rng = _rng(case)
    q, k, v = (_t(rng.normal(0, 1, (b, t, h, dh)).astype(np.float32), dev)
               for _ in range(3))
    valid = rng.uniform(size=(b, t)) < 0.9
    valid[:, 0] = True
    return q, k, v, _t(valid, dev)


def _build_ring(case: ProgramCase, dev: torch.device) -> tuple:
    from kepler_tpu_torch.parallel.ring import make_ring_attention

    return make_ring_attention(_mesh(8, dev, ("seq",))), _qkv(case, dev)


def _build_ulysses(case: ProgramCase, dev: torch.device) -> tuple:
    from kepler_tpu_torch.parallel.ulysses import make_ulysses_attention

    return make_ulysses_attention(_mesh(4, dev, ("seq",))), _qkv(case, dev)


def _build_pipeline(case: ProgramCase, dev: torch.device) -> tuple:
    from kepler_tpu_torch.parallel.pipeline import make_pipelined_deep

    d = case.dims
    rng = _rng(case)
    fn = make_pipelined_deep(_mesh(8, dev, ("stage",)),
                             n_microbatches=d.get("mb", 4))
    params = _params("deep", d["z"], rng, dev, n_stages=8)
    return fn, (params, _t(_feats(rng, d["n"]), dev),
                _t(rng.uniform(size=d["n"]) < 0.9, dev))


def _build_expert(case: ProgramCase, dev: torch.device) -> tuple:
    from kepler_tpu_torch.parallel.expert import make_expert_parallel_moe

    d = case.dims
    rng = _rng(case)
    fn = make_expert_parallel_moe(_mesh(8, dev, ("expert",)))
    params = _params("moe", d["z"], rng, dev, n_experts=8)
    return fn, (params, _t(_feats(rng, d["n"]), dev),
                _t(rng.randint(0, 8, d["n"]).astype(np.int32), dev),
                _t(rng.uniform(0.5, 1, d["n"]).astype(np.float32), dev))


def _build_sequence(case: ProgramCase, dev: torch.device) -> tuple:
    from kepler_tpu_torch.models.train import (create_train_state,
                                               make_optimizer)
    from kepler_tpu_torch.parallel.sequence import (
        make_sequence_parallel_train_step, make_temporal_program)

    d = case.dims
    w, t, z = d["w"], d["t"], d["z"]
    rng = _rng(case)
    mesh = _mesh(8, dev, ("seq",))
    params = _params("temporal", z, rng, dev)
    t_valid = rng.uniform(size=(w, t)) < 0.9
    t_valid[:, 0] = True
    data = (_t(_feats(rng, w, t), dev), _t(np.ones(w, bool), dev),
            _t(t_valid, dev))
    if d.get("train"):
        step = make_sequence_parallel_train_step(mesh, make_optimizer())
        state = create_train_state(params, make_optimizer())
        return step, (state,) + data + (
            _t(rng.uniform(0, 20, (w, z)).astype(np.float32), dev),)
    return make_temporal_program(mesh), (params,) + data


def _build_trainer(case: ProgramCase, dev: torch.device) -> tuple:
    from kepler_tpu_torch.models.train import (create_train_state,
                                               make_optimizer)
    from kepler_tpu_torch.parallel.trainer import (make_distributed_train_step,
                                                   shard_train_state)

    d = case.dims
    n, w, z = d["n"], d["w"], d["z"]
    rng = _rng(case)
    mesh = _mesh(8, dev, ("node", "model"), shape=(4, 2))
    step = make_distributed_train_step(mesh, make_optimizer())
    state = shard_train_state(create_train_state(
        _params("mlp", z, rng, dev), make_optimizer()), mesh)
    return step, (state, _t(_feats(rng, n, w), dev),
                  _t(rng.uniform(size=(n, w)) < 0.8, dev),
                  _t(rng.uniform(0, 20, (n, w, z)).astype(np.float32), dev))


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

DEVICE_PROGRAMS: tuple[ProgramSpec, ...] = (
    ProgramSpec(
        name="packed.dense_ratio",
        source="kepler_tpu_torch/parallel/packed.py",
        description="packed-f16 ratio-only fleet program (einsum, one "
                    "program over the whole node axis)",
        build=_build_packed,
        cases=(
            ProgramCase("n16_w8_z2", dims={"n": 16, "w": 8, "z": 2}),
            ProgramCase("pad_n8_w1_z1", "minimal ladder rung: one "
                        "workload column, one zone, one row per shard",
                        dims={"n": 8, "w": 1, "z": 1}),
        ),
        allowed_half_casts=_F16_OUT,
    ),
    ProgramSpec(
        name="packed.dense_mlp",
        source="kepler_tpu_torch/parallel/packed.py",
        description="packed-f16 mixed-fleet program, dense mlp estimator "
                    "(f32 compute, as the reference off the TPU)",
        build=_build_packed,
        cases=(
            ProgramCase("n16_w8_z2",
                        dims={"n": 16, "w": 8, "z": 2,
                              "model_mode": "mlp"}),
        ),
        allowed_half_casts=_F16_OUT,
    ),
    ProgramSpec(
        name="packed.sparse_mlp",
        source="kepler_tpu_torch/parallel/packed.py",
        description="sparse MODE_MODEL gather variant (replicated "
                    "model_rows; single-device engine path)",
        build=_build_packed,
        cases=(
            ProgramCase("n8_w8_z2_m4",
                        dims={"n": 8, "w": 8, "z": 2, "m": 4,
                              "model_mode": "mlp", "devices": 1}),
        ),
        allowed_half_casts=_F16_OUT,
    ),
    ProgramSpec(
        name="packed.sparse_local_mlp",
        source="kepler_tpu_torch/parallel/packed.py",
        description="per-shard sparse variant: shard-local model_rows "
                    "gather/scatter, zero collectives",
        build=_build_packed,
        cases=(
            ProgramCase("n16_w8_z2_m2",
                        dims={"n": 16, "w": 8, "z": 2, "m": 2,
                              "model_mode": "mlp", "local": 1}),
            ProgramCase("pad_n8_w1_z1_m1", "pad-heavy edge: every shard "
                        "one row, model bucket 1",
                        dims={"n": 8, "w": 1, "z": 1, "m": 1,
                              "model_mode": "mlp", "local": 1}),
        ),
        allowed_half_casts=_F16_OUT,
        require_shard_map=True,
    ),
    ProgramSpec(
        name="packed.sparse_local_multihost",
        source="kepler_tpu_torch/parallel/packed.py",
        description="the multi-host window's per-shard program at the "
                    "GLOBAL-mesh shape two processes' shards span (2 "
                    "hosts x 4 shards run as one 8-shard mesh) — zero "
                    "collectives pins that the only cross-host traffic "
                    "in a window is the dispatch itself",
        build=_build_packed,
        cases=(
            ProgramCase("hosts2_n16_w8_z2_m2",
                        "per-host bucket 2 over 2x4 shards",
                        dims={"n": 16, "w": 8, "z": 2, "m": 2,
                              "model_mode": "mlp", "local": 1}),
            ProgramCase("hosts2_pad_n8_w1_z1_m1", "minimal multi-host "
                        "rung: one row per shard across both hosts",
                        dims={"n": 8, "w": 1, "z": 1, "m": 1,
                              "model_mode": "mlp", "local": 1}),
        ),
        allowed_half_casts=_F16_OUT,
        require_shard_map=True,
    ),
    ProgramSpec(
        name="packed.pallas_dense",
        source="kepler_tpu_torch/parallel/packed.py",
        description="packed program with kernel B1 (the attribution "
                    "outer product), once per shard of the node mesh",
        build=_build_packed,
        cases=(
            ProgramCase("n16_w8_z2",
                        dims={"n": 16, "w": 8, "z": 2,
                              "backend": "pallas"}),
        ),
        allowed_half_casts=_F16_OUT,
        require_shard_map=True,
        kernels=("outer_product_attribution",),
    ),
    ProgramSpec(
        name="window.fused_ratio",
        source="kepler_tpu_torch/parallel/packed.py",
        description="fused device-resident window loop, ratio-only: K "
                    "intervals' delta rows applied in place and K packed "
                    "f16 outputs per dispatch (zero collectives: the "
                    "only cross-shard step stays the caller's batched "
                    "publish fetch)",
        build=_build_fused,
        cases=(
            ProgramCase("n16_w8_z2_k4_d8",
                        dims={"n": 16, "w": 8, "z": 2, "k": 4, "db": 8}),
            ProgramCase("pad_n8_w1_z1_k2_d1", "minimal fused rung: "
                        "steady fleet, one delta row per interval",
                        dims={"n": 8, "w": 1, "z": 1, "k": 2, "db": 1}),
        ),
        donates=(1,),
        allowed_half_casts=_F16_OUT,
    ),
    ProgramSpec(
        name="window.fused_sparse_mlp",
        source="kepler_tpu_torch/parallel/packed.py",
        description="fused window loop, sparse MODE_MODEL variant: each "
                    "interval gathers its model rows through the mlp "
                    "estimator — f32 compute, f16 only at the packed "
                    "output boundary",
        build=_build_fused,
        cases=(
            ProgramCase("n8_w8_z2_m4_k2_d4",
                        dims={"n": 8, "w": 8, "z": 2, "m": 4, "k": 2,
                              "db": 4, "model_mode": "mlp",
                              "devices": 1}),
        ),
        donates=(1,),
        allowed_half_casts=_F16_OUT,
    ),
    ProgramSpec(
        name="window.fused_pallas",
        source="kepler_tpu_torch/ops/cuda_attribution.py",
        description="fused window flush as ONE launch of kernel B2: the "
                    "K intervals' scatter + unpack + ratio attribution + "
                    "f16 pack in one kernel body",
        build=_build_fused,
        cases=(
            ProgramCase("n16_w8_z2_k2_d4",
                        dims={"n": 16, "w": 8, "z": 2, "k": 2, "db": 4,
                              "backend": "pallas", "devices": 1}),
        ),
        donates=(1,),
        allowed_half_casts=_F16_OUT,
        kernels=("fused_window_step",),
    ),
    ProgramSpec(
        name="window.update",
        source="kepler_tpu_torch/fleet/window.py",
        description="in-place scatter-update of the resident packed "
                    "batch (delta H2D path)",
        build=_build_window_update,
        cases=(
            ProgramCase("n16_w8_z2_d8",
                        dims={"n": 16, "w": 8, "z": 2, "db": 8}),
            ProgramCase("d1", "single-row delta (the steady-fleet case)",
                        dims={"n": 16, "w": 8, "z": 2, "db": 1}),
        ),
        donates=(0,),
    ),
    ProgramSpec(
        name="window.update_sharded",
        source="kepler_tpu_torch/fleet/window.py",
        description="shard-local in-place scatter-update (per-shard ring "
                    "of the ShardedWindowEngine)",
        build=_build_window_update,
        cases=(
            ProgramCase("s2_w8_z2_d2",
                        dims={"n": 2, "w": 8, "z": 2, "db": 2,
                              "sharded": 1}),
        ),
        donates=(0,),
    ),
    ProgramSpec(
        name="window.update_multihost",
        source="kepler_tpu_torch/fleet/window.py",
        description="host-local in-place scatter-update of the "
                    "multi-host engine (a virtual 2-host topology's "
                    "process-0 view: owned shards only)",
        build=_build_window_update,
        cases=(
            ProgramCase("hosts2_s2_w8_z2_d2",
                        dims={"n": 2, "w": 8, "z": 2, "db": 2,
                              "multihost": 1}),
        ),
        donates=(0,),
    ),
    ProgramSpec(
        name="fleet.dense_mlp",
        source="kepler_tpu_torch/parallel/aggregator_core.py",
        description="unpacked fleet program with mlp estimator (no "
                    "collectives)",
        build=_build_fleet,
        cases=(
            ProgramCase("n16_w4_z2", dims={"n": 16, "w": 4, "z": 2}),
        ),
        allowed_half_casts=_BF16_OPS,
    ),
    ProgramSpec(
        name="fleet.temporal",
        source="kepler_tpu_torch/parallel/aggregator_core.py",
        description="temporal fleet program (dense causal attention over "
                    "per-workload history windows)",
        build=_build_fleet,
        cases=(
            ProgramCase("n8_w4_t8_z2",
                        dims={"n": 8, "w": 4, "z": 2, "t": 8,
                              "temporal": 1}),
        ),
        allowed_half_casts=_BF16_OPS,
    ),
    ProgramSpec(
        name="ops.pallas_attribution",
        source="kepler_tpu_torch/ops/cuda_attribution.py",
        description="the pallas-backend fleet attribution, kernel B1 "
                    "unsharded",
        build=_build_pallas_attribution,
        cases=(
            ProgramCase("n8_w8_z2", dims={"n": 8, "w": 8, "z": 2}),
        ),
        kernels=("outer_product_attribution",),
    ),
    ProgramSpec(
        name="ring.attention",
        source="kepler_tpu_torch/parallel/ring.py",
        description="ring attention: KV blocks rotate via ppermute, "
                    "online-softmax partials merge in f32",
        build=_build_ring,
        cases=(
            ProgramCase("b2_t16_h4_d8",
                        dims={"b": 2, "t": 16, "h": 4, "dh": 8}),
        ),
        allowed_collectives=frozenset({"ppermute"}),
        allowed_half_casts=_BF16_OPS,
        require_shard_map=True,
    ),
    ProgramSpec(
        name="ulysses.attention",
        source="kepler_tpu_torch/parallel/ulysses.py",
        description="Ulysses attention: all_to_all head/sequence "
                    "re-partition around dense attention",
        build=_build_ulysses,
        cases=(
            ProgramCase("b2_t16_h4_d8",
                        dims={"b": 2, "t": 16, "h": 4, "dh": 8}),
        ),
        allowed_collectives=frozenset({"all_to_all", "all_gather"}),
        allowed_half_casts=_BF16_OPS,
        require_shard_map=True,
    ),
    ProgramSpec(
        name="pipeline.deep",
        source="kepler_tpu_torch/parallel/pipeline.py",
        description="GPipe microbatch pipeline over the deep estimator's "
                    "stage ring",
        build=_build_pipeline,
        cases=(
            ProgramCase("n16_z2_mb4", dims={"n": 16, "z": 2, "mb": 4}),
        ),
        allowed_collectives=frozenset({"ppermute", "psum"}),
        allowed_half_casts=_BF16_OPS,
        require_shard_map=True,
    ),
    ProgramSpec(
        name="expert.moe",
        source="kepler_tpu_torch/parallel/expert.py",
        description="expert-parallel MoE: all_to_all dispatch/combine "
                    "around batched expert MLPs",
        build=_build_expert,
        cases=(
            ProgramCase("n16_z2", dims={"n": 16, "z": 2}),
        ),
        allowed_collectives=frozenset({"all_to_all"}),
        allowed_half_casts=_BF16_OPS,
        require_shard_map=True,
    ),
    ProgramSpec(
        name="sequence.temporal",
        source="kepler_tpu_torch/parallel/sequence.py",
        description="sequence-parallel temporal estimator (ring attention "
                    "inside the trunk)",
        build=_build_sequence,
        cases=(
            ProgramCase("w4_t16_z2", dims={"w": 4, "t": 16, "z": 2}),
        ),
        allowed_collectives=frozenset({"ppermute"}),
        allowed_half_casts=_BF16_OPS,
        require_shard_map=True,
    ),
    ProgramSpec(
        name="sequence.train_step",
        source="kepler_tpu_torch/parallel/sequence.py",
        description="sequence-parallel temporal TRAIN step (state "
                    "updated in place, ring reversed in the backward)",
        build=_build_sequence,
        cases=(
            ProgramCase("w4_t16_z2",
                        dims={"w": 4, "t": 16, "z": 2, "train": 1}),
        ),
        donates=(0,),
        allowed_collectives=frozenset({"ppermute", "psum"}),
        require_shard_map=True,
    ),
    ProgramSpec(
        name="trainer.train_step",
        source="kepler_tpu_torch/parallel/trainer.py",
        description="DP×TP mlp train step (state updated in place; the "
                    "gradient all-reduce an explicit psum, where the "
                    "reference leaves it to GSPMD)",
        build=_build_trainer,
        cases=(
            ProgramCase("b8_w4_z2", dims={"n": 8, "w": 4, "z": 2}),
        ),
        donates=(0,),
        allowed_collectives=frozenset({"psum"}),
        allowed_half_casts=_BF16_OPS,
    ),
)


def spec_by_name(name: str) -> ProgramSpec:
    for spec in DEVICE_PROGRAMS:
        if spec.name == name:
            return spec
    raise KeyError(name)
