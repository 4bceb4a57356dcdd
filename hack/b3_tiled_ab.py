"""Time B3's KV-tiled variant on the card, at the main paths' shapes and
in forced plans, for one checkout of the repository.

    python hack/b3_tiled_ab.py [ROOT] [--plans] [--wide]

ROOT (default: this checkout) is the tree whose ``kepler_tpu_torch`` and
``chip_smoke.py`` are imported, so an unpacked older commit can be timed
beside this one in the same call (run parent, change, change, parent).
The script builds ROOT's kernels, prints the card's name and power limit
and, where ROOT's plan has paths, the registers and spill bytes of each
tiled instance; then per shape one JSON line: the plan, the max abs error
against the plain version (``chip_smoke.b3_check``'s tolerances), device
ms from ``torch.profiler`` (``chip_smoke.device_ms``, B3's kernels only)
and ROOT's bound. The shapes are the main paths' launches of the tiled
variant (accuracy mode at T = 16 and T = 128, a diagonal block of the
8-shard f32 ring and of the 2-shard bf16 ring, D = 128 at T = 16), the
tiled variant forced where tensor cores run, the wide path (D = 512 and
D = 320 at chip_smoke's kernel rows' shape: 4,096 sequences of T = 16, 4
heads, ragged, causal), and the two rings' B3 device ms in one call
(three calls). ``--wide`` times the wide path's rows alone, with SDPA's
device ms on the same inputs beside each. ``--plans`` adds plans the
planner does not pick, each timed on the same inputs: a one-pass f32
block of 64 query rows (two blocks of 4 warps an SM), a two-pass f32
stream of 64-key tiles at T = 128, and D = 128 at T = 16 with 1 and 2
sequences an item (the planner packs 4): the alternatives that PERF.md's
"What paid" weighs the chosen plans against.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = next((a for a in sys.argv[1:] if not a.startswith("--")),
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.abspath(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from kepler_tpu_torch.ops import build  # noqa: E402
from kepler_tpu_torch.ops import cuda_attention as cat  # noqa: E402

F, BF = torch.float32, torch.bfloat16
PATHS = "path" in cat.FlashPlan._fields


def emit(row: dict) -> None:
    print(json.dumps(row), flush=True)


def one(dev, name: str, b: int, tq: int, tk: int, d: int, cd, start=0,
        plan=None, chunk=None, h: int = 4, sdpa: bool = False) -> None:
    """B3 once at this shape (a diagonal block: q and KV both from
    ``start``) against its plain version, then its device ms (and, where
    ``sdpa``, SDPA's on the same inputs)."""
    gen = torch.Generator(device=dev).manual_seed(b + tq + d)
    q, k, v = (torch.randn((b, t, h, d), generator=gen, device=dev)
               for t in (tq, tk, tk))
    valid = cs.ragged_lengths(gen, dev, b, tk)
    plan = plan or cat.flash_block_plan(b, tq, tk, h, d, cd)

    def fn():
        return cat.flash_block_launch(plan, q, k, v, valid, start, start,
                                      compute_dtype=cd)

    row = {"name": name, "plan": plan._asdict()}
    try:
        got = fn()
        torch.cuda.synchronize()
        want = cs.b3_plain(q, k, v, valid, start, start, cd, chunk)
        row["max_abs_err"] = cs.b3_check(got, want, v, cd, name)
        del got, want
        ms = cs.device_ms(fn, calls=5, tries=6, match="flash_block")
        # an older tree's device_ms gives the ms alone
        row["device_ms"] = ms[0] if isinstance(ms, tuple) else ms
        row["bound_ms"] = cat.flash_block_bound_ms(
            q, k, valid, start, start, compute_dtype=cd)[0]
        if sdpa:
            row["sdpa_device_ms"] = cs.sdpa_ms(q, k, v, valid)[1]
    except (RuntimeError, ValueError) as err:
        row["error"] = repr(err)[:400]
    emit(row)
    del q, k, v, valid
    torch.cuda.empty_cache()


def ring(dev, n: int, cd) -> None:
    """The pallas ring over 4096 sequences of T = 1024 on n virtual
    shards: B3's device ms in each of three calls."""
    from kepler_tpu_torch.parallel.ring import make_ring_attention

    b, t = 4096, 1024
    gen = torch.Generator(device=dev).manual_seed(7 + n)
    q, k, v = (torch.randn((b, t, 4, 32), generator=gen, device=dev)
               for _ in range(3))
    valid = cs.ragged_lengths(gen, dev, b, t)
    attn = make_ring_attention(cs.parallel_mesh(dev, n), backend="pallas",
                               compute_dtype=cd)
    attn(q, k, v, valid)
    torch.cuda.synchronize()
    ms = [cs.profile_top(lambda: attn(q, k, v, valid),
                         match="flash_block")["flash_block_ms"]
          for _ in range(3)]
    emit({"name": f"ring_{n}_{str(cd)[6:]}", "b3_device_ms": ms})
    del q, k, v, valid
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("b3_tiled_ab: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    build.build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    emit({"root": ROOT, "build_s": time.perf_counter() - t0,
          "nvidia_smi": smi})
    if PATHS:
        emit({"compiled": {
            f"{str(cd)[6:]}_t{t}_d{d}": cat.flash_block_info("tiled", t, d,
                                                            cd)
            for t, d, cd in ((16, 32, F), (128, 32, F), (128, 32, BF),
                             (16, 128, F), (16, 128, BF), (512, 32, BF),
                             (512, 32, F), (16, 512, BF), (16, 512, F))}})
    if PATHS:
        for d in (512, 320):
            for cd in (BF, F):
                one(dev, f"{str(cd)[6:]}_d{d}", 4096, 16, 16, d, cd,
                    sdpa=True)
    if "--wide" in sys.argv:
        return 0
    one(dev, "f32_t16", 262144, 16, 16, 32, F)
    one(dev, "f32_t128", 16384, 128, 128, 32, F)
    one(dev, "f32_ring_block", 4096, 128, 128, 32, F, start=384)
    one(dev, "bf16_ring512_block", 4096, 512, 512, 32, BF, start=512,
        chunk=256)
    one(dev, "bf16_d128_t16", 65536, 16, 16, 128, BF)
    one(dev, "f32_d128_t16", 65536, 16, 16, 128, F)
    for t, b in ((16, 262144), (128, 16384)):
        one(dev, f"bf16_forced_t{t}", b, t, t, 32, BF,
            plan=cat.tiled_plan(b, t, t, 4, 32, BF))
    if PATHS and "--plans" in sys.argv:
        plan = cat.tiled_plan(16384, 128, 128, 4, 32, F)
        half = plan._replace(qr=64, threads=128, smem=cat.tiled_smem_bytes(
            1, 64, 128, 32, F))
        stream = plan._replace(tk=64, path="two-pass",
                               smem=cat.tiled_smem_bytes(1, 128, 64, 32, F,
                                                         True))
        one(dev, "f32_t128_qr64", 16384, 128, 128, 32, F, plan=half)
        one(dev, "f32_t128_two_pass_64", 16384, 128, 128, 32, F,
            plan=stream)
        one(dev, "f32_ring_block_two_pass_64", 4096, 128, 128, 32, F,
            start=384, plan=stream)
        for cd in (BF, F):
            for g in (1, 2):
                plan = cat.tiled_plan(65536, 16, 16, 4, 128, cd)
                one(dev, f"{str(cd)[6:]}_d128_t16_g{g}", 65536, 16, 16, 128,
                    cd, plan=plan._replace(g=g, threads=32 * g,
                                           smem=cat.tiled_smem_bytes(
                                               g, 16, 16, 128, cd)))
    ring(dev, 8, F)
    ring(dev, 2, BF)
    return 0


if __name__ == "__main__":
    sys.exit(main())
