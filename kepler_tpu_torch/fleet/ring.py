"""Consistent-hash ring for the replicated ingest tier.

One aggregator behind one HTTP endpoint is the fleet-size ceiling
(ROADMAP item 1): a single crash or partition stalls every agent. The
HA ingest tier shards agents across N aggregator replicas by
consistent-hash of ``node_name`` — each replica accepts only the nodes
it owns and answers everyone else with a structured ``421 + owner +
epoch`` redirect the agent follows. Because the delivery plane is
already at-least-once with idempotent ``(run, seq)`` ingest, a
membership change is **replay, not loss**: displaced agents re-deliver
their spool tail to the new owner and the dedup window absorbs the
overlap.

Design constraints:

- **Deterministic across processes.** Ownership is a pure function of
  the (sorted) peer set and the key — two replicas configured with the
  same ``aggregator.peers`` list always agree, with no coordination
  protocol. Hashing is ``blake2b`` (stable everywhere), never Python's
  salted ``hash()``.
- **Minimal disruption.** Virtual nodes (``vnodes`` points per peer)
  mean removing a replica moves ONLY the departed replica's keys to
  the survivors; everyone else's owner is untouched. Adding one steals
  only the keys the newcomer now owns. (Property-tested in
  ``tests/test_hash_ring.py``.)
- **Versioned membership.** The ring carries a monotonically
  increasing ``epoch``; replicas advertise it on every redirect and
  accept, so agents learn the ring lazily and re-resolve on a bump.
  The ring object itself is immutable — a membership change builds a
  NEW ring (``Aggregator.apply_membership``), so readers never need a
  lock.

Peer names arrive from config on the happy path but ALSO from the wire
(an agent adopts the ``owner`` a redirect names; a replica validates
the ``owner`` header agents echo back) — they are untrusted input
until they pass :func:`sanitize_peer` / :func:`coerce_epoch`.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Iterable, Sequence

__all__ = ["HashRing", "MeshRing", "RingError", "MAX_PEER_NAME",
           "ring_from_mesh", "sanitize_peer", "coerce_epoch"]

# peer names become redirect payloads, log fields, and /debug/ring
# entries; the cap bounds every store keyed on them (the node-name
# contract, applied to the peer axis)
MAX_PEER_NAME = 256

DEFAULT_VNODES = 64


class RingError(ValueError):
    pass


# keplint: sanitizes — the chokepoint that launders a wire-derived peer
# name (redirect bodies, echoed owner headers): printable ASCII only,
# length-capped, never empty — hostile values can't forge log lines or
# mint unbounded redirect targets
def sanitize_peer(name: object) -> str | None:
    """``name`` as a safe peer id, or None when it is not one."""
    if not isinstance(name, str) or not name:
        return None
    if len(name) > MAX_PEER_NAME:
        return None
    if any(not (" " <= c <= "\x7e") for c in name):
        return None
    return name


# keplint: sanitizes — epoch/acked_through values off the wire: a
# non-bool, non-negative int or nothing
def coerce_epoch(value: object) -> int | None:
    """``value`` as a non-negative int epoch/watermark, else None."""
    if isinstance(value, bool) or not isinstance(value, int):
        return None
    if value < 0:
        return None
    return value


def _point(data: str) -> int:
    """64-bit ring coordinate for a string (stable across processes)."""
    return int.from_bytes(
        hashlib.blake2b(data.encode(), digest_size=8).digest(), "big")


class HashRing:
    """Immutable consistent-hash ring over a static peer set.

    ``peers`` is the replica membership (each entry a dialable
    endpoint like ``"127.0.0.1:28283"`` — but opaque to the ring);
    ``epoch`` versions the membership. Two rings built from the same
    peer SET (any order) and vnode count produce identical ownership.
    """

    __slots__ = ("_peers", "_epoch", "_vnodes", "_points", "_owners")

    # keplint: protocol-transition — a ring (and its epoch) is born
    # immutable; with_members builds a NEW ring at a HIGHER epoch
    def __init__(self, peers: Iterable[str], epoch: int = 1,
                 vnodes: int = DEFAULT_VNODES) -> None:
        cleaned: list[str] = []
        for raw in peers:
            peer = sanitize_peer(raw)
            if peer is None:
                raise RingError(
                    f"invalid ring peer {raw!r}: peers must be 1-"
                    f"{MAX_PEER_NAME} printable ASCII chars")
            cleaned.append(peer)
        if not cleaned:
            raise RingError("ring needs at least one peer")
        if len(set(cleaned)) != len(cleaned):
            raise RingError(f"duplicate ring peers in {cleaned!r}")
        if coerce_epoch(epoch) is None or epoch < 1:
            raise RingError(f"ring epoch must be an int >= 1, got {epoch!r}")
        if not isinstance(vnodes, int) or vnodes < 1:
            raise RingError(f"ring vnodes must be an int >= 1, got {vnodes!r}")
        self._peers = tuple(sorted(cleaned))
        self._epoch = int(epoch)
        self._vnodes = int(vnodes)
        pts: list[tuple[int, str]] = []
        for peer in self._peers:
            for v in range(self._vnodes):
                pts.append((_point(f"{peer}#{v}"), peer))
        pts.sort()
        self._points = [p for p, _ in pts]
        self._owners = [o for _, o in pts]

    # -- membership --------------------------------------------------------

    @property
    def peers(self) -> tuple[str, ...]:
        return self._peers

    @property
    def epoch(self) -> int:
        return self._epoch

    @property
    def vnodes(self) -> int:
        return self._vnodes

    @property
    def membership_digest(self) -> str:
        """Short stable digest of the peer SET (order-free) — lets two
        replicas cheaply check they applied the SAME membership at an
        epoch (the equal-epoch split-brain detector's log/debug
        evidence) without printing full peer lists."""
        return hashlib.blake2b("\x1f".join(self._peers).encode(),
                               digest_size=4).hexdigest()

    def __contains__(self, peer: str) -> bool:
        return peer in self._peers

    def __len__(self) -> int:
        return len(self._peers)

    def with_members(self, peers: Sequence[str], epoch: int) -> "HashRing":
        """A NEW ring for a membership change. ``epoch`` must advance —
        redirects from stale and fresh replicas are only orderable
        because the epoch is monotonic."""
        if coerce_epoch(epoch) is None or epoch <= self._epoch:
            raise RingError(
                f"membership epoch must increase past {self._epoch}, "
                f"got {epoch!r}")
        return HashRing(peers, epoch=epoch, vnodes=self._vnodes)

    # -- ownership ---------------------------------------------------------

    def owner(self, key: str) -> str:
        """The peer owning ``key`` (first ring point at or after the
        key's coordinate, wrapping)."""
        i = bisect.bisect_left(self._points, _point(key))
        if i >= len(self._points):
            i = 0
        return self._owners[i]

    def ownership_ratio(self, peer: str) -> float:
        """Fraction of the hash space ``peer`` owns (arc lengths of its
        ring points) — the ownership gauge's value. 0.0 for a peer not
        in the ring."""
        if peer not in self._peers:
            return 0.0
        if len(self._peers) == 1:
            return 1.0
        space = float(1 << 64)
        total = 0
        pts, owners = self._points, self._owners
        for i, point in enumerate(pts):
            if owners[i] != peer:
                continue
            prev = pts[i - 1] if i else pts[-1] - (1 << 64)
            total += point - prev
        return total / space

    def describe(self, self_peer: str = "") -> dict:
        """``/debug/ring`` payload fragment (the aggregator adds its
        redirect counters)."""
        return {
            "epoch": self._epoch,
            "peers": list(self._peers),
            "vnodes": self._vnodes,
            "self": self_peer,
            "digest": self.membership_digest,
            "ownership_ratio": (round(self.ownership_ratio(self_peer), 6)
                                if self_peer else None),
        }


class MeshRing(HashRing):
    """Ingest ring whose ownership is DERIVED from the device mesh's
    shard map — the multi-host co-location contract: a node
    hashes to a global mesh shard (``blake2b(node) % n_shards``), and
    its owner is the peer of the PROCESS whose local devices host that
    shard. Each host's aggregator replica therefore ingests exactly the
    agents whose packed rows live on its local devices — wire-v2
    zero-copy decode lands in host-local staging with zero cross-host
    bytes on the ingest path.

    Deterministic across processes for the same (peers-by-process,
    shard→process, epoch) inputs, like the vnode ring. ``with_members``
    intentionally DEGRADES to a plain :class:`HashRing`: a membership
    change away from the mesh map (host death, operator rebalance) is
    exactly the moment mesh-derived ownership stops being true.
    """

    __slots__ = ("_shard_owner", "_n_shards")

    def __init__(self, peers_by_process: Sequence[str],
                 shard_processes: Sequence[int], epoch: int = 1) -> None:
        if not shard_processes:
            raise RingError("mesh ring needs at least one shard")
        if any(not isinstance(p, int) or isinstance(p, bool)
               or not 0 <= p < len(peers_by_process)
               for p in shard_processes):
            raise RingError(
                f"shard process ids must index peers_by_process "
                f"(0..{len(peers_by_process) - 1}); got "
                f"{list(shard_processes)!r}")
        # the vnode point set is unused for ownership but kept valid so
        # every HashRing surface (peers, describe, epoch checks) holds
        super().__init__(peers_by_process, epoch=epoch, vnodes=1)
        cleaned = [sanitize_peer(p) for p in peers_by_process]
        self._shard_owner = tuple(cleaned[p] for p in shard_processes)
        self._n_shards = len(shard_processes)

    @property
    def n_shards(self) -> int:
        return self._n_shards

    def shard_of(self, key: str) -> int:
        """The global mesh shard ``key``'s packed row hashes to."""
        return _point(key) % self._n_shards

    def owner(self, key: str) -> str:
        return self._shard_owner[self.shard_of(key)]

    def ownership_ratio(self, peer: str) -> float:
        if peer not in self._peers:
            return 0.0
        owned = sum(1 for o in self._shard_owner if o == peer)
        return owned / self._n_shards

    def with_members(self, peers: Sequence[str], epoch: int) -> HashRing:
        """Membership change → a PLAIN consistent-hash ring over the
        survivors (the mesh map no longer describes reality once a host
        left it). Epoch must advance, as on the base ring."""
        if coerce_epoch(epoch) is None or epoch <= self.epoch:
            raise RingError(
                f"membership epoch must increase past {self.epoch}, "
                f"got {epoch!r}")
        return HashRing(peers, epoch=epoch, vnodes=DEFAULT_VNODES)

    def describe(self, self_peer: str = "") -> dict:
        out = super().describe(self_peer)
        out["mesh_derived"] = True
        out["n_shards"] = self._n_shards
        return out


def ring_from_mesh(peers_by_process: Sequence[str],
                   shard_processes: Sequence[int],
                   epoch: int = 1) -> MeshRing:
    """Build the mesh-co-located ingest ring.

    ``peers_by_process[p]`` is process ``p``'s dialable replica endpoint
    (``aggregator.peers`` ordered by ``jax.process_index``);
    ``shard_processes[k]`` is the process whose local device hosts
    global mesh shard ``k`` (``[d.process_index for d in
    mesh.devices.flat]`` on the 1-D node mesh). Every process builds the
    identical ring with no coordination — the same determinism contract
    as :class:`HashRing`, with the shard map as the hash space.
    """
    return MeshRing(peers_by_process, shard_processes, epoch=epoch)
