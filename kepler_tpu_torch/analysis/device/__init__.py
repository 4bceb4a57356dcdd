"""The port's device tier: checks over recorded runs of its device programs.

The host-plane tiers (per-file KTL101-110/114, whole-program
KTL111-113) see source text; this tier sees what the attribution math
actually runs. Each registered program (one per program of the reference
package's kepljax registry, same names, cases and contracts) runs once
on seeded inputs at tiny shapes under an aten op recorder, on ``cuda``
by default or on ``cpu`` when asked; the hand kernels B1 and B2 launch
on the card and their plain versions run on the CPU, and both read as
one ``kernel:<name>`` op. Four families ride each run:

- **KTL120 dtype-flow** — half precision never accumulates; casts only
  at declared boundaries (the f16 wire quantizer, bf16 operand rounding).
- **KTL121 donation-alias** — the `donates` contract is REAL: declared
  arguments are updated in place, no whole copy, nothing else updated.
- **KTL122 collective-discipline** — collectives match the entry's
  allowlist; shard-local programs keep their per-shard bodies.
- **KTL123 program-ratchet** — normalized structural fingerprints
  against the port's committed golden snapshots (``kepltorch.json``).

Run via ``python -m kepler_tpu_torch.analysis --device-tier [--device
cpu]``; regenerate snapshots with ``--update-snapshots --device cpu``.
Importing this package registers the rules but runs nothing.
"""

from kepler_tpu_torch.analysis.device.checks import (  # noqa: F401
    DEVICE_RULE_IDS,
    SNAPSHOT_NAME,
    analyze_device_programs,
    clear_trace_cache,
    load_snapshots,
    trace_all,
    write_snapshots,
)
from kepler_tpu_torch.analysis.device.registry import (  # noqa: F401
    DEVICE_PROGRAMS,
    ProgramCase,
    ProgramSpec,
    spec_by_name,
)

__all__ = [
    "DEVICE_PROGRAMS",
    "DEVICE_RULE_IDS",
    "ProgramCase",
    "ProgramSpec",
    "SNAPSHOT_NAME",
    "analyze_device_programs",
    "clear_trace_cache",
    "load_snapshots",
    "spec_by_name",
    "trace_all",
    "write_snapshots",
]
