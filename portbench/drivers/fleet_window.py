"""Fleet windows back to back through the port's temporal fleet program.

The model step of the Aggregator's window in ``model: temporal``
(``Aggregator._dispatch_legacy``) on one card, through the same calls:
the program made once over the Aggregator's one-shard mesh
(``make_temporal_fleet_program(backend=..., mesh=...)``, the mesh
``make_mesh`` builds on one card, ``backend`` the configuration's
``fleet_backend``), then per window
``run_fleet_attribution(program, batch, params, feat_hist, t_valid)``
(which packs the window's host arrays into one buffer, ``put_blocks``,
and moves it in one copy) and ``copy_blocks_to_host_async`` of the four
published tensors of each node block. At ``pipeline_depth`` d, window
n + d − 1 is dispatched before window n's results are waited on. The
windows cycle through a ring of ``ring`` distinct windows made from the
seed in set-up (host numpy arrays, as the Aggregator hands them over).

Counts: ``windows`` completed, ``workloads`` (valid workloads they
attributed); samples: ``window_ms``, each window's time from the start
of its dispatch to its results on the host. ``correct``: a sample of the
windows (drawn from the seed, ``sample_windows`` of them) against the
plain reference (``reference.fleet``): ``ratio_gap`` over RAPL nodes,
``model_gap`` over model nodes, each the widest gap of the four
published tensors relative to the reference's largest magnitude there.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Mapping

import numpy as np
import torch

from portbench import fleetgen
from portbench.harness import Check, Spans, Window, max_rel_gap
from portbench.reference import fleet as ref_fleet
from portbench.reference.precision import BELOW


def setup(config: Mapping[str, Any], traffic: Mapping[str, Any], seed: int,
          device: torch.device, spans: Spans) -> "Session":
    return Session(config, traffic, seed, device, spans)


def _batch(arrays: Mapping[str, np.ndarray], fleet: fleetgen.Fleet,
           names: list[str], ids: list[list[str]]) -> Any:
    from kepler_tpu_torch.parallel.fleet import FleetBatch

    return FleetBatch(
        node_names=names, n_nodes=fleet.nodes,
        workload_counts=[len(x) for x in ids], workload_ids=ids,
        **{k: arrays[k] for k in fleetgen.BATCH_KEYS})


class Session:
    def __init__(self, config: Mapping[str, Any],
                 traffic: Mapping[str, Any], seed: int,
                 device: torch.device, spans: Spans) -> None:
        from kepler_tpu_torch.fleet.window import copy_blocks_to_host_async
        from kepler_tpu_torch.parallel import aggregator_core
        from kepler_tpu_torch.parallel.mesh import make_mesh

        self.core = aggregator_core
        self.copy_out = copy_blocks_to_host_async
        self.traffic, self.device, self.spans = traffic, device, spans
        fleet = fleetgen.Fleet.of(config)
        self.depth = int(config["pipeline_depth"])
        self.precision = config["estimator"]["compute_dtype"]
        gen = torch.Generator(device=device).manual_seed(seed)
        self.params = fleetgen.temporal_params(
            config["estimator"], fleet.zones, gen, device)
        ring = fleetgen.windows(fleet, traffic, gen, device,
                                int(traffic["ring"]), history=True)
        host = fleetgen.to_host(ring)
        del ring
        names = [f"node-{i:04d}" for i in range(fleet.nodes)]
        ids = [[f"{n}/w{j}" for j in range(fleet.pods)] for n in names]
        self.ring = []
        for r in range(int(traffic["ring"])):
            arrays = {k: v[r] for k, v in host.items()}
            self.ring.append((arrays, _batch(arrays, fleet, names, ids)))
        self.valid_workloads = [int(a["workload_valid"].sum())
                                for a, _ in self.ring]
        self.program = aggregator_core.make_temporal_fleet_program(
            backend=config["fleet_backend"],
            mesh=make_mesh(devices=[device]))
        self.sampler = np.random.default_rng(seed)
        self.samples: list[tuple[int, tuple[np.ndarray, ...]]] = []
        self._windows(lambda i, _: i >= int(traffic["warmup_windows"]))
        self.samples = []
        self.sampler = np.random.default_rng(seed)

    def _dispatch(self, k: int) -> Any:
        arrays, batch = self.ring[k]
        blocks = self.core.run_fleet_attribution(
            self.program, batch, self.params, arrays["feat_hist"],
            arrays["t_valid"])
        return self.copy_out([(r.node_power_uw, r.node_energy_uj,
                               r.workload_power_uw, r.workload_energy_uj)
                              for r in blocks])

    def _keep(self, j: int, k: int, host: tuple[np.ndarray, ...]) -> None:
        """Reservoir sample of the window's results (drawn from the
        seed): each window is kept with the same chance."""
        size = int(self.traffic["sample_windows"])
        if j < size:
            self.samples.append((k, host))
            return
        r = int(self.sampler.integers(0, j + 1))
        if r < size:
            self.samples[r] = (k, host)

    def _windows(self, stop) -> Window:
        spans, ring = self.spans, len(self.ring)
        pending: deque = deque()
        latencies: list[float] = []
        workloads = done = 0
        t0 = time.perf_counter()

        def finish() -> None:
            nonlocal workloads, done
            j, k, t_start, copy = pending.popleft()
            with spans("harness.wait"):
                host = copy.wait()
            latencies.append((time.perf_counter() - t_start) * 1e3)
            workloads += self.valid_workloads[k]
            done += 1
            self._keep(j, k, host)

        i = 0
        while not stop(i, time.perf_counter() - t0):
            k = i % ring
            t_start = time.perf_counter()
            with spans("harness.dispatch"):
                copy = self._dispatch(k)
            pending.append((i, k, t_start, copy))
            i += 1
            if len(pending) >= self.depth:
                finish()
        while pending:
            finish()
        seconds = time.perf_counter() - t0
        return Window(seconds=seconds,
                      counts={"windows": done, "workloads": workloads},
                      attempted=i, failed=i - done,
                      samples={"window_ms": latencies})

    def run(self, seconds: float) -> Window:
        return self._windows(lambda _, elapsed: elapsed >= seconds)

    def _free_program(self) -> None:
        self.program = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def _reference(self, k: int, model_precision: str,
                   ratio_precision: str = "float32") -> dict:
        arrays, _ = self.ring[k]
        return ref_fleet.temporal_window(
            self.params, arrays, self.device, model_precision,
            ratio_precision)

    def gaps(self, got: dict[int, list[dict]], want: dict[int, dict]
             ) -> dict[str, float]:
        """Widest relative gap over the RAPL rows and over the model rows
        of every published tensor of every sampled window."""
        out = {"ratio_gap": 0.0, "model_gap": 0.0}
        for k, results in got.items():
            model = want[k]["__mode__"] == ref_fleet.MODE_MODEL
            for res in results:
                for name in ref_fleet.PUBLISHED:
                    g, w = res[name], want[k][name]
                    out["ratio_gap"] = max(out["ratio_gap"],
                                           max_rel_gap(g[~model], w[~model]))
                    out["model_gap"] = max(out["model_gap"],
                                           max_rel_gap(g[model], w[model]))
        return out

    def _sampled(self) -> dict[int, list[dict]]:
        got: dict[int, list[dict]] = {}
        for k, host in self.samples:
            got.setdefault(k, []).append(ref_fleet.published_of(host))
        return got

    def _want(self, keys, model_precision: str,
              ratio_precision: str = "float32") -> dict[int, dict]:
        want = {}
        for k in keys:
            want[k] = self._reference(k, model_precision, ratio_precision)
            want[k]["__mode__"] = self.ring[k][0]["mode"]
        return want

    def program_readings(self) -> dict[str, float]:
        """Frees the program's state, runs the reference, compares."""
        self._free_program()
        got = self._sampled()
        return self.gaps(got, self._want(got, self.precision))

    def check(self, limits: Mapping[str, float]) -> list[Check]:
        got = self.program_readings()
        return [Check(name, got[name], float(limit))
                for name, limit in limits.items()]

    def control_gaps(self) -> dict[str, float]:
        """The control's readings: the reference one precision below the
        configuration's (the model's operands and the ratio split), in
        the program's place, against the reference, on the same sampled
        windows."""
        keys = sorted({k for k, _ in self.samples})
        control = self._want(keys, BELOW[self.precision], BELOW["float32"])
        want = self._want(keys, self.precision)
        return self.gaps({k: [control[k]] for k in keys}, want)
