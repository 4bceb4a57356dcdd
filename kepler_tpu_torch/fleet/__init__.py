"""Fleet plane: wire frames, the node-side ``FleetAgent`` with its durable
``Spool``, the device-resident window engines and the cluster
``Aggregator`` that ingests node reports and attributes the whole fleet
over a mesh of CUDA devices (one card, or virtual shards of it, in the
common case)."""

from kepler_tpu_torch.fleet.agent import FleetAgent
from kepler_tpu_torch.fleet.aggregator import Aggregator
from kepler_tpu_torch.fleet.membership import (
    AutoscaleDecision,
    AutoscalePolicy,
    AutoscaleSignals,
    CoordinatorLease,
    MembershipError,
    elect_successor,
    plan_succession,
)
from kepler_tpu_torch.fleet.ring import HashRing
from kepler_tpu_torch.fleet.scoreboard import FleetScoreboard
from kepler_tpu_torch.fleet.spool import Spool
from kepler_tpu_torch.fleet.wire import (
    WireError,
    decode_report,
    encode_report,
)

__all__ = [
    "Aggregator",
    "AutoscaleDecision",
    "AutoscalePolicy",
    "AutoscaleSignals",
    "CoordinatorLease",
    "FleetAgent",
    "FleetScoreboard",
    "HashRing",
    "MembershipError",
    "Spool",
    "WireError",
    "decode_report",
    "elect_successor",
    "encode_report",
    "plan_succession",
]
