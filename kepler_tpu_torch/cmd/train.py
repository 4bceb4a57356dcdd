"""Estimator training CLI of the PyTorch/CUDA port — the train half of
the train→serve loop.

``python -m kepler_tpu_torch.cmd.train --data DIR --model mlp --out
params.npz [--device cuda|cpu]``

As ``kepler_tpu.cmd.train``: reads the training windows the aggregator
dumps (``fleet/aggregator.py`` ``_dump_training_window``: RAPL nodes'
feature inputs labelled with their own ratio-attributed watts), fits the
chosen estimator family on ``--device`` (``cuda`` by default; without
CUDA it exits 1 naming CUDA, and the CPU runs only with ``--device
cpu``), and writes serve-ready ``.npz`` params (``models.estimator.
save_params``) that either package's aggregator serves
(``--aggregator.params-path``). Long fits checkpoint to ``--ckpt-dir``
every ``--ckpt-every`` steps and resume from the latest checkpoint
(``models/checkpoint.py``; the port's own format, not orbax's).
"""

from __future__ import annotations

import argparse
import glob
import logging
import os
import sys
from typing import Any, Sequence

import numpy as np

log = logging.getLogger("kepler.train")

FAMILIES = ("linear", "mlp", "moe", "deep", "temporal")


def load_windows(data_dir: str):
    """Concatenate dumped windows along the node-row axis.

    Each file carries its own zone axis (the per-round sorted union can
    change as fleet membership changes), so label columns align by ZONE
    NAME onto the union across all files; zones a row's file or node
    lacked are masked out of ``label_valid`` rather than read as 0-watt
    labels. Workload-slot padding (W) likewise aligns to the widest file.
    """
    files = sorted(glob.glob(os.path.join(data_dir, "window-*.npz")))
    if not files:
        raise FileNotFoundError(
            f"no window-*.npz training files under {data_dir!r} — point "
            "--data at an aggregator.trainingDumpDir")
    raw = []
    for f in files:
        with np.load(f) as z:
            raw.append({k: z[k] for k in z.files})
    zone_names = sorted({str(n) for r in raw
                         for n in r["zone_names"].tolist()})
    z_index = {n: i for i, n in enumerate(zone_names)}
    nz = len(zone_names)
    w_max = max(r["cpu_deltas"].shape[1] for r in raw)

    # temporal dumps carry per-workload history windows; T can vary
    # across files if aggregator.historyWindow changed — right-pad to the
    # longest (the temporal model pools the last VALID position)
    has_hist = [("feat_hist" in r) for r in raw]
    t_max = max((r["feat_hist"].shape[2] for r, h in zip(raw, has_hist)
                 if h), default=0)

    cols: dict[str, list[np.ndarray]] = {}
    for r, hist in zip(raw, has_hist):
        rows, w = r["cpu_deltas"].shape
        targets = np.zeros((rows, w_max, nz), np.float32)
        lvalid = np.zeros((rows, w_max, nz), bool)
        wvalid = np.zeros((rows, w_max), bool)
        cpu = np.zeros((rows, w_max), np.float32)
        cpu[:, :w] = r["cpu_deltas"]
        wvalid[:, :w] = r["workload_valid"]
        for j, name in enumerate(r["zone_names"].tolist()):
            i = z_index[str(name)]
            targets[:, :w, i] = r["target_watts"][:, :, j]
            lvalid[:, :w, i] = (r["workload_valid"]
                                & r["zone_valid"][:, None, j])
        cols.setdefault("cpu_deltas", []).append(cpu)
        cols.setdefault("workload_valid", []).append(wvalid)
        cols.setdefault("target_watts", []).append(targets)
        cols.setdefault("label_valid", []).append(lvalid)
        for k in ("node_cpu_delta", "usage_ratio", "dt_s"):
            cols.setdefault(k, []).append(r[k])
        if t_max:
            f_dim = (r["feat_hist"].shape[3] if hist
                     else next(x["feat_hist"].shape[3]
                               for x, h in zip(raw, has_hist) if h))
            fh = np.zeros((rows, w_max, t_max, f_dim), np.float32)
            tv = np.zeros((rows, w_max, t_max), bool)
            if hist:
                _, wh, th, _ = r["feat_hist"].shape
                fh[:, :wh, :th] = r["feat_hist"]
                tv[:, :wh, :th] = r["t_valid"]
            cols.setdefault("feat_hist", []).append(fh)
            cols.setdefault("t_valid", []).append(tv)
    data = {k: np.concatenate(v, axis=0) for k, v in cols.items()}
    data["zone_names"] = zone_names
    return data, files


def parse_args(argv: Sequence[str] | None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="kepler-tpu-train",
        description="fit a power estimator on aggregator-dumped windows")
    p.add_argument("--data", required=True,
                   help="dir of window-*.npz files (aggregator dump)")
    p.add_argument("--model", default="mlp", choices=FAMILIES)
    p.add_argument("--out", required=True, help="output params .npz")
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt-dir", default="",
                   help="checkpoint dir (enables resume)")
    p.add_argument("--ckpt-every", type=int, default=100)
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="device to train on (cuda unless asked)")
    return p.parse_args(argv)


def build_trainer(args: argparse.Namespace, data: dict, device: Any):
    """The train state and step of ``args.model`` on ``device`` for the
    loaded windows → (state, step_fn, step_fn's inputs after the state),
    or None when temporal training finds no history in the dumps.

    Every family steps on the labelled rows alone (a slot with a label in
    some zone), gathered once here: the single-tick families' ``[R, F]``
    features (built over every slot first: a row's ``share`` is its
    node's) and ``[R]`` valid, the temporal family's ``[R, T, F]``
    histories, ``[R]`` valid and ``[R, T]`` tick mask, and both's ``[R,
    Z]`` targets and label mask. Each row's output reads only its own
    inputs, so the loss and every gradient are the padded step's up to
    f32 summation order. The counter is logged once at INFO: "stepping
    on R labelled rows of S slots (x%)", the rows the step computes on
    over the dumps' slots, with " × T ticks" after the slots for the
    temporal family and ", each through E experts" for the moe family
    (every expert runs on every row)."""
    import torch

    from kepler_tpu_torch.models import build_features, initializer
    from kepler_tpu_torch.models.estimator import predictor
    from kepler_tpu_torch.models.train import (
        create_train_state,
        make_optimizer,
        make_temporal_train_step,
        make_train_step,
    )

    def put(x: np.ndarray, dtype: Any = None) -> torch.Tensor:
        return torch.from_numpy(np.asarray(x, dtype)).to(device)

    label_valid = put(data["label_valid"])
    keep = label_valid.any(-1)
    rows, slots = int(keep.sum()), keep.numel()

    def labelled(key: str, dtype: Any = None) -> torch.Tensor:
        """``data[key]``'s labelled rows, in dump order (the padded copy
        is dropped here)."""
        return put(data[key], dtype)[keep]

    n_zones = data["target_watts"].shape[-1]
    targets = labelled("target_watts", np.float32)
    label_valid = label_valid[keep]
    gen = torch.Generator().manual_seed(args.seed)

    if args.model == "temporal":
        if "feat_hist" not in data:
            log.error(
                "--model temporal needs history windows in the dumps — "
                "run the aggregator with model=temporal AND a "
                "trainingDumpDir so ratio nodes' feature histories are "
                "captured (fleet/aggregator.py:_dump_training_window)")
            return None
        feat_hist = labelled("feat_hist", np.float32)
        t_max = int(feat_hist.shape[1])
        detail = f" × {t_max} ticks"
        params = initializer("temporal")(
            n_zones, t_max=max(t_max, 128), generator=gen, device=device)
        step_fn = make_temporal_train_step()
        inputs = (feat_hist, labelled("workload_valid"), labelled("t_valid"),
                  targets, label_valid)
    else:
        feats = build_features(
            put(data["cpu_deltas"], np.float32), put(data["workload_valid"]),
            put(data["node_cpu_delta"], np.float32),
            put(data["usage_ratio"], np.float32),
            put(data["dt_s"], np.float32))[keep]
        params = initializer(args.model)(n_zones, generator=gen,
                                         device=device)
        detail = (f", each through {params['w0'].shape[0]} experts"
                 if args.model == "moe" else "")
        step_fn = make_train_step(predictor(args.model))
        inputs = (feats, torch.ones(rows, dtype=torch.bool, device=device),
                  targets, label_valid)
    log.info("stepping on %d labelled rows of %d slots%s (%.2f%%)", rows,
             slots, detail, 100.0 * rows / max(slots, 1))
    return create_train_state(params, make_optimizer(args.lr)), step_fn, inputs


def main(argv: Sequence[str] | None = None) -> int:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s",
                        stream=sys.stderr)

    from kepler_tpu_torch.device import resolve_device
    from kepler_tpu_torch.models.estimator import save_params

    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        log.error("training runs on a CUDA device unless run with "
                  "--device cpu: %s", err)
        return 1

    data, files = load_windows(args.data)
    b, w = data["cpu_deltas"].shape
    log.info("loaded %d windows: %d node-rows × %d workload slots, "
             "zones %s, %d labelled workloads, on %s", len(files), b, w,
             data["zone_names"], int(data["workload_valid"].sum()), device)
    built = build_trainer(args, data, device)
    if built is None:
        return 2
    state, step_fn, inputs = built

    ck = None
    if args.ckpt_dir:
        from kepler_tpu_torch.models.checkpoint import TrainCheckpointer

        ck = TrainCheckpointer(args.ckpt_dir)
        resumed = ck.restore_latest(state)
        if resumed is not None:
            state = resumed
            log.info("resumed from checkpoint step %d", state.step)

    loss = float("nan")
    try:
        while state.step < args.steps:
            state, loss = step_fn(state, *inputs)
            step = state.step
            if args.log_every and step % args.log_every == 0:
                log.info("step %d/%d loss %.6f", step, args.steps,
                         float(loss))
            if (ck is not None and args.ckpt_every
                    and step % args.ckpt_every == 0):
                ck.save(state)
        if ck is not None:
            if ck.latest_step() != state.step:  # periodic may have hit
                ck.save(state, force=True)
            ck.wait()
    finally:
        if ck is not None:
            ck.close()

    save_params(args.out, state.params)
    log.info("trained %s for %d steps (final loss %.6f) → %s",
             args.model, state.step, float(loss), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
