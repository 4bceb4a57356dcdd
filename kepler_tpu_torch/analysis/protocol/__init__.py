"""kepmc: exhaustive-interleaving model checking of the fleet's pure
decision layer.

The host-plane tiers read source text; the device tier reads recorded
program runs;
this tier reads REACHABLE STATE SPACES. Every distributed-protocol
decision the fleet makes — lease adopt/succession, membership
apply/replay, seq dedup/watermark seeding, spool ack-cursor math, the
wire-v2 keyframe/delta/409 machine — lives in pure functions
(the port's ``fleet/membership.py``, ``fleet/delivery.py``), and kepmc drives
those SAME functions through every event interleaving at small scope
(2-3 replicas, a handful of windows/epochs) via an explicit-state BFS
explorer. Three families ride each exploration:

- **KTL130 protocol-epoch-safety** — no split-brain, holders inside
  their membership, contiguous epochs, no awaiting-forever wedge.
- **KTL131 protocol-loss-accounting** — no fabricated loss, no spool
  record skipped or stale-acked, rewinds bounded.
- **KTL132 protocol-replay-idempotence** — replays are no-ops,
  duplicate keyframes still plant the base, 409s converge in one
  round trip.

(The companion per-file rule KTL133 — epoch/seq/ack/base-row state
writes only inside ``# keplint: protocol-transition``-marked functions
— lives with the other AST rules in ``rules/protocol.py``; it is what
keeps the modeled surface and the production surface the same code.)

Counterexamples print as minimal event traces (BFS order = shortest
schedule). Run via ``python -m kepler_tpu_torch.analysis --protocol-tier``.
Importing this package registers the rules but explores nothing.
"""

from kepler_tpu_torch.analysis.protocol.checks import (  # noqa: F401
    INVARIANT_RULE,
    ModelReport,
    PROTOCOL_RULE_IDS,
    analyze_protocol_specs,
    clear_exploration_cache,
    explore_case,
)
from kepler_tpu_torch.analysis.protocol.explorer import (  # noqa: F401
    Counterexample,
    ExplorationResult,
    ProtocolModel,
    StateExplosionError,
    explore,
)
from kepler_tpu_torch.analysis.protocol.models import (  # noqa: F401
    MODEL_BUILDERS,
    build_model,
)
from kepler_tpu_torch.analysis.protocol.registry import (  # noqa: F401
    PROTOCOL_SPECS,
    ProtocolCase,
    ProtocolSpec,
    spec_by_name,
)

__all__ = [
    "Counterexample",
    "ExplorationResult",
    "INVARIANT_RULE",
    "MODEL_BUILDERS",
    "ModelReport",
    "PROTOCOL_RULE_IDS",
    "PROTOCOL_SPECS",
    "ProtocolCase",
    "ProtocolModel",
    "ProtocolSpec",
    "StateExplosionError",
    "analyze_protocol_specs",
    "build_model",
    "clear_exploration_cache",
    "explore",
    "explore_case",
    "spec_by_name",
]
