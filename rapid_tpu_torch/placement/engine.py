"""Deterministic weighted shard placement over the live membership: the
pure half of ``rapid_tpu/placement/engine.py``.

A map of P partitions onto the view with R replicas each, computed as a
*pure function* of ``(configuration id, sorted view, per-node weights,
seed)``: weighted rendezvous (highest-random-weight) hashing. Every node
gets ``weight`` virtual instances; partition p scores instance v of node n
by mixing ``fold32(xxh64_long(p, seed))`` with
``fold32(endpoint_hash(n) + v*GOLDEN)``; a node's score is the max over its
instances and the replica set is the top-R nodes by ``(score desc,
candidate index asc)``.

This module holds the object model (``PlacementConfig``, ``PlacementMap``,
``PlacementDiff``, ``build_map``, ``diff_maps``) with the JAX package's
arithmetic, the live engine over it (``PlacementEngine``, and
``PlacementSubscriber``, which drives one from ``ClusterEvents.VIEW_CHANGE``
alone) and the key-routing helpers ``weight_seed`` and ``rendezvous_route``
(``serving/router.py``'s ``RendezvousRouter`` routes with them);
``placement/device.py`` is the vectorized mirror over the slot universe,
whose top-R runs in the CUDA kernel ``placement_topr``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

from ..events import NodeStatusChange
from ..hashing import endpoint_hash, to_signed, xxh64, xxh64_long
from ..types import EdgeStatus, Endpoint

__all__ = [
    "DEFAULT_WEIGHT_KEY",
    "MAX_WEIGHT",
    "PlacementConfig",
    "PlacementDiff",
    "PlacementEngine",
    "PlacementMap",
    "PlacementSubscriber",
    "build_map",
    "diff_maps",
    "fold32",
    "instance_key32",
    "mix32",
    "node_key64",
    "partition_key32",
    "rendezvous_route",
    "weight_of",
    "weight_seed",
]

# Instance stride: 2**64 / phi, the additive constant that equidistributes
# virtual-instance keys; mix multipliers are the murmur3 fmix32 pair. All
# three are mirrored verbatim in placement/device.py.
GOLDEN64 = 0x9E3779B97F4A7C15
MIX1 = 0x85EBCA6B
MIX2 = 0xC2B2AE35
_MASK64 = (1 << 64) - 1
_MASK32 = (1 << 32) - 1

DEFAULT_WEIGHT_KEY = "capacity"
# Weights are virtual-instance counts; unbounded values would turn one bad
# metadata byte into an O(weight) score loop on every member.
MAX_WEIGHT = 64


def fold32(h: int) -> int:
    """uint64 -> uint32 by xor-folding the halves (keeps all input bits live)."""
    return (h ^ (h >> 32)) & _MASK32


def mix32(a: int, b: int) -> int:
    """The scored pair mix: murmur3-style avalanche of ``a ^ b`` (uint32)."""
    h = (a ^ b) & _MASK32
    h = (h * MIX1) & _MASK32
    h ^= h >> 15
    h = (h * MIX2) & _MASK32
    h ^= h >> 13
    return h


def partition_key32(partition: int, seed: int) -> int:
    """Partition key: xxh64 of the 8 LE bytes of the partition index."""
    return fold32(xxh64_long(partition, seed))


def node_key64(node: Endpoint, seed: int) -> int:
    """Node key: the same endpoint hash that orders the K rings."""
    return endpoint_hash(node.hostname, node.port, seed)


def instance_key32(key64: int, instance: int) -> int:
    """Virtual-instance key: node key advanced by ``instance`` golden steps."""
    return fold32((key64 + instance * GOLDEN64) & _MASK64)


def weight_of(metadata: Iterable[Tuple[str, bytes]],
              weight_key: str = DEFAULT_WEIGHT_KEY,
              default: int = 1) -> int:
    """Decode a node's placement weight from its metadata tags.

    The value is the ASCII integer under ``weight_key`` (shipped to joiners in
    JoinResponses via MetadataManager); absent or malformed values fall back
    to ``default`` so one corrupt tag cannot diverge maps across members that
    all see the same bytes."""
    for key, value in metadata:
        if key != weight_key:
            continue
        try:
            weight = int(value.decode("ascii").strip())
        except (UnicodeDecodeError, ValueError):
            return default
        return max(1, min(MAX_WEIGHT, weight))
    return default


@dataclass(frozen=True)
class PlacementConfig:
    """The deterministic inputs every member must agree on out-of-band
    (fixed at deploy time, like K/H/L)."""

    partitions: int = 256
    replicas: int = 3
    seed: int = 0
    weight_key: str = DEFAULT_WEIGHT_KEY
    default_weight: int = 1

    def __post_init__(self) -> None:
        if self.partitions <= 0:
            raise ValueError(f"partitions must be positive: {self.partitions}")
        if self.replicas <= 0:
            raise ValueError(f"replicas must be positive: {self.replicas}")


@dataclass(frozen=True)
class PlacementMap:
    """One configuration's full partition->replica-set assignment.

    ``version`` is an xxh64 fingerprint over the assigned node keys in
    partition order -- bit-identical across members and across the
    object/device planes, so statusz can detect placement disagreement the
    same way it detects configuration-id disagreement."""

    config: PlacementConfig
    configuration_id: int
    version: int
    members: Tuple[Endpoint, ...]
    assignments: Tuple[Tuple[Endpoint, ...], ...]
    weights: Tuple[int, ...] = ()

    def counts(self) -> Dict[Endpoint, int]:
        """Replica slots held per member (members holding zero included)."""
        out: Dict[Endpoint, int] = {node: 0 for node in self.members}
        for row in self.assignments:
            for node in row:
                out[node] += 1
        return out

    def owned(self, node: Endpoint) -> Tuple[int, ...]:
        """Partitions whose replica set contains ``node``."""
        return tuple(
            p for p, row in enumerate(self.assignments) if node in row
        )

    def imbalance(self) -> float:
        """max over members of (slots held / weight) divided by the
        weight-proportional fair share; 1.0 is perfectly balanced."""
        if not self.members:
            return 0.0
        weights = self.weights or tuple(1 for _ in self.members)
        total_slots = sum(len(row) for row in self.assignments)
        total_weight = sum(weights)
        if total_slots == 0 or total_weight == 0:
            return 0.0
        fair = total_slots / total_weight
        counts = self.counts()
        return max(
            counts[node] / weight / fair
            for node, weight in zip(self.members, weights)
        )


@dataclass(frozen=True)
class PlacementDiff:
    """What moved between two consecutive maps of the same geometry.

    ``handoffs`` pairs each moved partition's donors with its recipients
    positionally; a recipient with no departing donor (pure join growth)
    is paired with the partition's first surviving replica, which holds the
    data to stream from."""

    old_version: int
    new_version: int
    configuration_id: int
    partitions_moved: Tuple[int, ...]
    handoffs: Tuple[Tuple[int, Optional[Endpoint], Endpoint], ...]
    load_delta: Tuple[Tuple[Endpoint, int], ...]

    @property
    def moved(self) -> int:
        return len(self.partitions_moved)


def _score_node(part32: int, key64: int, weight: int) -> int:
    best = 0
    for v in range(weight):
        s = mix32(part32, instance_key32(key64, v))
        if s > best:
            best = s
    return best


def _fingerprint(assignments: Sequence[Sequence[Endpoint]],
                 keys: Mapping[Endpoint, int], seed: int) -> int:
    blob = b"".join(
        keys[node].to_bytes(8, "little")
        for row in assignments
        for node in row
    )
    return to_signed(xxh64(blob, seed))


def build_map(
    members: Iterable[Endpoint],
    weights: Mapping[Endpoint, int],
    config: PlacementConfig,
    configuration_id: int,
) -> PlacementMap:
    """The pure map function. Candidate order is the sorted view --
    (hostname, port) -- so every member iterates identically; ties in the
    32-bit scores (probability ~2**-32 per pair) resolve to the lower
    candidate index on both planes."""
    ordered = tuple(sorted(set(members)))
    member_weights = tuple(
        weights.get(node, config.default_weight) for node in ordered
    )
    keys = {node: node_key64(node, config.seed) for node in ordered}
    replicas = min(config.replicas, len(ordered))
    assignments: List[Tuple[Endpoint, ...]] = []
    for p in range(config.partitions):
        part32 = partition_key32(p, config.seed)
        # top-R by (score desc, index asc): sort on (score, -index) desc
        scored = sorted(
            ((_score_node(part32, keys[node], w), -i)
             for i, (node, w) in enumerate(zip(ordered, member_weights))),
            reverse=True,
        )
        assignments.append(
            tuple(ordered[-neg_i] for _, neg_i in scored[:replicas])
        )
    rows = tuple(assignments)
    return PlacementMap(
        config=config,
        configuration_id=configuration_id,
        version=_fingerprint(rows, keys, config.seed),
        members=ordered,
        assignments=rows,
        weights=member_weights,
    )


def diff_maps(old: PlacementMap, new: PlacementMap) -> PlacementDiff:
    """Rebalance plan between two maps of the same config."""
    if old.config != new.config:
        raise ValueError("cannot diff maps built from different configs")
    moved: List[int] = []
    handoffs: List[Tuple[int, Optional[Endpoint], Endpoint]] = []
    for p, (old_row, new_row) in enumerate(zip(old.assignments, new.assignments)):
        if old_row == new_row:
            continue
        moved.append(p)
        donors = [node for node in old_row if node not in new_row]
        recipients = [node for node in new_row if node not in old_row]
        survivors = [node for node in old_row if node in new_row]
        for i, recipient in enumerate(recipients):
            if i < len(donors):
                donor: Optional[Endpoint] = donors[i]
            elif survivors:
                donor = survivors[0]
            else:
                donor = None
            handoffs.append((p, donor, recipient))
    old_counts = old.counts()
    new_counts = new.counts()
    nodes = sorted(set(old_counts) | set(new_counts))
    load_delta = tuple(
        (node, new_counts.get(node, 0) - old_counts.get(node, 0))
        for node in nodes
        if new_counts.get(node, 0) != old_counts.get(node, 0)
    )
    return PlacementDiff(
        old_version=old.version,
        new_version=new.version,
        configuration_id=new.configuration_id,
        partitions_moved=tuple(moved),
        handoffs=tuple(handoffs),
        load_delta=load_delta,
    )


class PlacementEngine:
    """Stateful wrapper: rebuilds the map per configuration and diffs it
    against the previous one. Hosts no protocol state of its own -- feed it
    the view and it answers; two engines fed the same views are
    indistinguishable."""

    def __init__(self, config: PlacementConfig) -> None:
        self.config = config
        self.map: Optional[PlacementMap] = None  # guarded-by: protocol-executor
        self.last_diff: Optional[PlacementDiff] = None  # guarded-by: protocol-executor

    def update(
        self,
        configuration_id: int,
        members: Iterable[Endpoint],
        weights: Mapping[Endpoint, int],
    ) -> Tuple[PlacementMap, Optional[PlacementDiff]]:
        new_map = build_map(members, weights, self.config, configuration_id)
        diff = diff_maps(self.map, new_map) if self.map is not None else None
        self.map, self.last_diff = new_map, diff
        return new_map, diff


class PlacementSubscriber:
    """Drives a PlacementEngine purely from ClusterEvents.VIEW_CHANGE.

    The initial VIEW_CHANGE fired at service construction carries the full
    ring with metadata (MembershipService.java:162-165 parity), so the
    subscriber bootstraps its member/weight table from events alone --
    register it as a VIEW_CHANGE subscription and it never touches the
    view."""

    def __init__(self, config: PlacementConfig) -> None:
        self._engine = PlacementEngine(config)
        self._weights: Dict[Endpoint, int] = {}
        self.view_changes = 0

    @property
    def config(self) -> PlacementConfig:
        return self._engine.config

    @property
    def map(self) -> Optional[PlacementMap]:
        return self._engine.map

    @property
    def last_diff(self) -> Optional[PlacementDiff]:
        return self._engine.last_diff

    def __call__(self, configuration_id: int,
                 changes: List[NodeStatusChange]) -> None:
        cfg = self._engine.config
        for change in changes:
            if change.status == EdgeStatus.UP:
                self._weights[change.endpoint] = weight_of(
                    change.metadata, cfg.weight_key, cfg.default_weight
                )
            else:
                self._weights.pop(change.endpoint, None)
        self.view_changes += 1
        self._engine.update(configuration_id, self._weights, self._weights)


# --------------------------------------------------------------------------
# Key-routing helpers (the examples/load_balancer.py rendezvous scheme)
# --------------------------------------------------------------------------

def weight_seed(backend: Endpoint) -> int:
    """Per-backend rendezvous seed: hash of the printable identity, masked
    positive so it is a valid xxh64 seed everywhere."""
    return xxh64(backend.hostname + b"#%d" % backend.port, 0) & 0x7FFFFFFF


def rendezvous_route(
    key: bytes,
    backends: Sequence[Endpoint],
    seeds: Mapping[Endpoint, int],
) -> Endpoint:
    """Classic per-key rendezvous over explicit backends: the backend whose
    seeded hash of the key is highest. ``seeds`` comes from weight_seed()."""
    if not backends:
        raise ValueError("no backends")
    return max(backends, key=lambda b: xxh64(key, seeds[b]))
