"""Time three forms of the port's drop-mode row scatter on the card.

The port's window engines apply each interval's delta rows to the
resident packed batch with ``kepler_tpu_torch.ops.attribution.
scatter_rows_``. This script holds that function against two other forms
of the same update, on the same inputs, and times each with CUDA events
over back-to-back calls:

- ``copy_back``: the form before the in-place write — the same row map,
  then a whole-batch ``torch.where`` into a temporary copied back;
- ``true_scatter``: ``index_put_`` of the hit rows only, each pad entry
  redirected to rewrite one valid entry's row;
- ``shipped``: ``scatter_rows_`` (the row map, then one in-place
  ``torch.where(..., out=resident)``).

Every form must leave the same bytes. It also checks each for a host
sync (``torch.cuda.set_sync_debug_mode``). Run from the repository root
on a machine with a CUDA card:

    python hack/torch_scatter_ab.py

Prints the card's name and power limit, then one JSON line per shape.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from kepler_tpu_torch.ops.attribution import scatter_rows_  # noqa: E402

SHAPES = ((1024, 268, 8), (1024, 268, 512), (1024, 268, 1024),
          (128, 268, 8), (16384, 268, 512))
REPEATS = 3
CALLS = 200


def copy_back(resident, rows, idx):
    n = resident.shape[0]
    idx = idx.to(torch.int64)
    slot = torch.where((idx >= 0) & (idx < n), idx, n)
    src = torch.full((n + 1,), -1, dtype=torch.int64, device=resident.device)
    src.scatter_reduce_(0, slot, torch.arange(idx.numel(),
                                              device=resident.device),
                        reduce="amax")
    src = src[:n]
    hit = (src >= 0)[:, None]
    resident.copy_(torch.where(hit, rows[src.clamp(min=0)], resident))
    return resident


def true_scatter(resident, rows, idx):
    n = resident.shape[0]
    idx = idx.to(torch.int64)
    valid = (idx >= 0) & (idx < n)
    first = torch.argmin(torch.where(valid, idx, n), dim=0, keepdim=True)
    has = valid.index_select(0, first)
    target = torch.where(valid, idx,
                         torch.where(has, idx.index_select(0, first), 0))
    pad_row = torch.where(has[:, None], rows.index_select(0, first),
                          resident[:1])
    resident.index_put_((target,), torch.where(valid[:, None], rows,
                                               pad_row))
    return resident


FORMS = {"copy_back": copy_back, "true_scatter": true_scatter,
         "shipped": scatter_rows_}


def per_call_ms(fn) -> float:
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(CALLS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / CALLS


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_scatter_ab: CUDA is not available", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    for n, width, db in SHAPES:
        base = torch.randn(n, width, generator=gen).to(dev)
        rows = torch.randn(db, width, generator=gen).to(dev)
        idx = torch.randperm(n, generator=gen)[:db].to(torch.int32)
        idx[-1] = n  # a pad entry, dropped
        idx = idx.to(dev)
        res = {name: base.clone() for name in FORMS}
        for name, fn in FORMS.items():
            fn(res[name], rows, idx)
        same = all(torch.equal(res[name], res["copy_back"]) for name in FORMS)
        row: dict = {"N": n, "width": width, "DB": db, "same_bytes": same}
        for name, fn in FORMS.items():
            row[f"{name}_ms"] = [per_call_ms(
                lambda fn=fn, r=res[name]: fn(r, rows, idx))
                for _ in range(REPEATS)]
        print(json.dumps(row), flush=True)
        if not same:
            return 1
    for name, fn in FORMS.items():
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn(base.clone(), rows, idx)
            synced = False
        except RuntimeError:
            synced = True
        finally:
            torch.cuda.set_sync_debug_mode(0)
        print(json.dumps({"form": name, "host_sync": synced}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
