"""One rank of the port's two-process multi-host window check.

``python tests/torch_multihost_worker.py RANK WORLD ADDR OUT`` joins a
gloo job at ``ADDR``, builds the 2-process mesh of 4 ``cpu`` shards per
process, runs :data:`SCHEDULE` through ``MultiHostWindowEngine`` with no
fabric (bucket needs agreed by ``torch.distributed`` all-reduce), and
writes every published row (node name → its f16 plane row) per window
to ``OUT`` (``.npz``). ``tests/test_torch_multihost.py`` spawns two and
holds the union of their rows against the single-process sharded
engine. Imports no JAX.
"""

from __future__ import annotations

import sys
import zlib

import numpy as np

from kepler_tpu_torch.fleet.ring import ring_from_mesh
from kepler_tpu_torch.fleet.window import RowInput
from kepler_tpu_torch.parallel.fleet import MODE_MODEL, NodeReport

ZONES = ("package", "dram")
PEERS = ["127.0.0.1:28291", "127.0.0.1:28292"]
SHARD_PROCS = [0, 0, 0, 0, 1, 1, 1, 1]
BASE = [f"node-{i:02d}" for i in range(12)]
# (seq, names): full pack, pure delta, join, drop, delta again
SCHEDULE = [
    (1, BASE),
    (2, BASE),
    (3, BASE + ["node-99"]),
    (4, [n for n in BASE if n != "node-03"]),
    (5, [n for n in BASE if n != "node-03"]),
]


def make_report(name: str, seed: int, w: int = 4,
                mode: int = 0) -> NodeReport:
    rng = np.random.default_rng(zlib.crc32(f"{name}:{seed}".encode()))
    cpu = rng.uniform(0.1, 5.0, w).astype(np.float32)
    return NodeReport(
        node_name=name,
        zone_deltas_uj=rng.uniform(1e7, 5e8, len(ZONES)).astype(
            np.float32),
        zone_valid=np.ones(len(ZONES), bool),
        usage_ratio=float(rng.uniform(0.2, 0.9)),
        cpu_deltas=cpu,
        workload_ids=[f"{name}-w{k}" for k in range(w)],
        node_cpu_delta=float(cpu.sum()),
        dt_s=5.0,
        mode=mode,
        workload_kinds=np.ones(w, np.int8),
    )


def make_rows(names: list[str], seq: int) -> list[RowInput]:
    return [RowInput(name=name,
                     report=make_report(name, seq * 1000 + i,
                                        mode=MODE_MODEL if i % 2 else 0),
                     zone_names=ZONES, ident=("run", seq))
            for i, name in enumerate(names)]


def owner_split(names: list[str]) -> dict[int, list[str]]:
    """Which process ingests each node: the mesh-derived ring's owner."""
    ring = ring_from_mesh(PEERS, SHARD_PROCS)
    out: dict[int, list[str]] = {0: [], 1: []}
    for name in names:
        out[PEERS.index(ring.owner(name))].append(name)
    return out


def mlp_params() -> dict:
    rng = np.random.default_rng(7)
    f, h, z = 7, 32, len(ZONES)
    return {"w0": rng.normal(0, 0.3, (f, h)).astype(np.float32),
            "b0": np.zeros(h, np.float32),
            "w1": rng.normal(0, 0.2, (h, h)).astype(np.float32),
            "b1": np.zeros(h, np.float32),
            "w2": rng.normal(0, 0.05, (h, z)).astype(np.float32),
            "b2": np.full(z, 0.5, np.float32),
            "w_skip": rng.normal(0, 0.01, (f, z)).astype(np.float32)}


def main(argv: list[str]) -> int:
    rank, world, addr, out = int(argv[0]), int(argv[1]), argv[2], argv[3]
    import torch

    from kepler_tpu_torch.fleet.window import (MultiHostWindowEngine,
                                               fetch_plane)
    from kepler_tpu_torch.parallel.mesh import (Shard, initialize_multihost,
                                                make_mesh)

    joined = initialize_multihost(coordinator_address=addr,
                                  num_processes=world, process_id=rank,
                                  init_timeout=30)
    if not joined:
        print(f"rank {rank}: join failed: {joined}", file=sys.stderr)
        return 2
    mesh = make_mesh([8], devices=[Shard(torch.device("cpu"), p)
                                   for p in SHARD_PROCS])
    eng = MultiHostWindowEngine(mesh, model_mode="mlp", node_bucket=8,
                                workload_bucket=16)
    params = mlp_params()
    rows_out: dict[str, np.ndarray] = {}
    for seq, names in SCHEDULE:
        mine = owner_split(names)[rank]
        all_rows = make_rows(names, seq)
        rows = [r for r in all_rows if r.name in set(mine)]
        plan = eng.plan_window(rows, ZONES, params)
        plane = fetch_plane(eng.dispatch_window(plan))
        assert plane.shape[0] == plan.meta.n_rows
        for name, i in plan.meta.rows.items():
            rows_out[f"{seq}/{name}"] = plane[i]
    np.savez(out, **rows_out)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
