"""Time B3's wide path (D above 256) at other chunk widths and ring depths
than the kernel's own, on the card, so that the choice of ``kWdChunk`` and
``kWdStages`` in ``kepler_tpu_torch/ops/csrc/attention.cu`` can be weighed
again.

    python hack/b3_wide_variants.py [CHUNK,STAGES ...]

For each pair (by default the seven ``PERF.md`` §6 weighs) the script
copies ``attention.cu`` with the two constants replaced and builds the
copy with the repository's ``nvcc`` flags into a temporary directory, all
builds started together. It then launches each copy's wide path through
``cuda_attention.flash_block_launch`` at ``chip_smoke.py``'s kernel rows'
shape (4,096 sequences of T = 16, 4 heads, ragged, causal) at D = 512 and
D = 320, bf16 and f32: once against the plain version
(``chip_smoke.b3_check``'s tolerances), then for its device ms
(``chip_smoke.device_ms``, B3's kernels only), the pairs in the order given
and then reversed. It prints the card's name and power limit, then one
JSON line per shape with each pair's two times.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from kepler_tpu_torch.ops import build  # noqa: E402
from kepler_tpu_torch.ops import cuda_attention as cat  # noqa: E402

PAIRS = ((64, 4), (64, 3), (64, 2), (32, 4), (32, 3), (128, 3), (128, 2))


def variant_source(chunk: int, stages: int) -> str:
    """``attention.cu`` with the wide path's chunk width and stages."""
    src = (build.CSRC / "attention.cu").read_text()
    for name, value in (("kWdChunk", chunk), ("kWdStages", stages)):
        src, n = re.subn(rf"constexpr int {name} = \d+;",
                         f"constexpr int {name} = {value};", src)
        if n != 1:
            raise RuntimeError(f"attention.cu defines {name} {n} times")
    return src


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with the argument types ``cuda_attention`` gives its own."""
    load = build.load
    build.load = lambda name: lib
    try:
        return cat._lib()
    finally:
        build.load = load


def build_variants(pairs, tmp: str) -> dict:
    """Each pair's library, built from its copy of the source."""
    started = {}
    for chunk, stages in pairs:
        stem = os.path.join(tmp, f"attention_{chunk}_{stages}")
        with open(stem + ".cu", "w") as f:
            f.write(variant_source(chunk, stages))
        started[(chunk, stages)] = (stem + ".so", subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", stem + ".so",
             stem + ".cu"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for key, (so, proc) in started.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {key}:\n{out}")
        libs[key] = bind(ctypes.CDLL(so))
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("b3_wide_variants: CUDA is not available", file=sys.stderr)
        return 2
    pairs = [tuple(int(x) for x in a.split(",")) for a in sys.argv[1:]]
    pairs = pairs or list(PAIRS)
    dev = torch.device("cuda")
    print(cs.provenance(), flush=True)
    own = cat._lib
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(pairs, tmp)
        try:
            for d in (512, 320):
                gen = torch.Generator(device=dev).manual_seed(cs.SEED + 43)
                shape = (4096, 16, 4, d)
                q, k, v = (torch.randn(shape, generator=gen, device=dev)
                           for _ in range(3))
                valid = cs.ragged_lengths(gen, dev, 4096, 16)
                for cd in (torch.bfloat16, torch.float32):
                    want = cat.flash_block_ref(q, k, v, valid, 0, 0,
                                               compute_dtype=cd)
                    row = {"D": d, "compute": str(cd)[6:], "bound_ms":
                           cat.flash_block_bound_ms(q, k, valid, 0, 0,
                                                    compute_dtype=cd)[0]}
                    for chunk, stages in pairs + pairs[::-1]:
                        cat._lib = lambda: libs[(chunk, stages)]
                        plan = cat.tiled_plan(4096, 16, 16, 4, d, cd)._replace(
                            dp=-(-d // chunk) * chunk)

                        def fn(plan=plan, cd=cd):
                            return cat.flash_block_launch(
                                plan, q, k, v, valid, 0, 0, compute_dtype=cd)

                        cs.b3_check(fn(), want, v, cd,
                                    f"wide path at {chunk} x {stages}")
                        ms = cs.device_ms(fn, calls=5, tries=6,
                                          match="flash_block")[0]
                        row.setdefault(f"{chunk}x{stages}", []).append(ms)
                    print(json.dumps(row), flush=True)
                    del want
                del q, k, v, valid
                torch.cuda.empty_cache()
        finally:
            cat._lib = own
    return 0


if __name__ == "__main__":
    sys.exit(main())
