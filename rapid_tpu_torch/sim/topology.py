"""Host-side control plane: vectorized ring/adjacency construction.

The port's copy of the numpy paths of ``rapid_tpu/sim/topology.py``, with
its ``LatencyTopology`` (the rack/zone/region RTT model the fault plane's
WAN plans compile onto delivery groups and delays) and the standalone
``configuration_id_vectorized``. All K ring orderings are computed at once
with the batched xxHash64 (``rapid_tpu_torch.hashing.xxh64_batch``) and
numpy argsorts -- bit-identical ordering to the JVM reference's seeded
TreeSets (Utils.java:211-230), so the observer/subject adjacency and the
configuration identity of the simulated cluster match what real Rapid nodes
compute.

Ring construction happens only at configuration changes (rare); the
per-round protocol work stays on the device (``rapid_tpu_torch.sim.engine``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..hashing import endpoint_hash, endpoint_hash_batch, xxh64, xxh64_batch, xxh64_batch_auto

_U64 = np.uint64


def _int64_le_bytes(values: np.ndarray) -> np.ndarray:
    """[N] int64 -> [N, 8] uint8 little-endian rows (hashLong input layout)."""
    return (
        values.astype(np.int64).view(np.uint64)[:, None]
        .view(np.uint8).reshape(-1, 8)
    )


def _port_le_bytes(ports: np.ndarray) -> np.ndarray:
    """[N] ports -> [N, 4] uint8 little-endian rows (hashInt input layout)."""
    out = np.zeros((len(ports), 4), dtype=np.uint8)
    p = ports.astype(np.uint32)
    for i in range(4):
        out[:, i] = ((p >> np.uint32(8 * i)) & np.uint32(0xFF)).astype(np.uint8)
    return out


@dataclass
class VirtualCluster:
    """Identity of up to ``capacity`` virtual nodes; row index == node id."""

    hostnames: np.ndarray  # [C, max_len] uint8
    host_lengths: np.ndarray  # [C] int64
    ports: np.ndarray  # [C] int64
    id_high: np.ndarray  # [C] int64  (NodeId.high, Java signed)
    id_low: np.ndarray  # [C] int64
    # per-ring endpoint hashes, computed once: [K, C] uint64
    ring_hashes: np.ndarray
    # lazy caches (identities are immutable, so these never invalidate)
    _full_order: Optional[np.ndarray] = None  # [K, C] stable argsort per ring
    _ring_rank: Optional[np.ndarray] = None  # [K, C] inverse of _full_order
    _node_hashes: Optional[Tuple[np.ndarray, ...]] = None  # config-id inputs

    @property
    def capacity(self) -> int:
        return len(self.ports)

    def full_ring_order(self) -> np.ndarray:
        """Stable argsort of every ring over the full capacity, cached.

        The ring order of any active subset is the stable filter of this
        order (a subsequence of a sorted sequence is sorted; stable ties
        resolve by node id in both), so adjacency rebuilds at view changes
        are O(C) masking instead of O(C log C) sorting.
        """
        if self._full_order is None:
            signed = self.ring_hashes.view(np.int64)
            self._full_order = np.argsort(
                signed, axis=1, kind="stable"
            ).astype(np.int32)
        return self._full_order

    def ring_rank(self) -> np.ndarray:
        """Each node's position in the full-capacity ring order, per ring
        ([K, C] int32, the inverse permutation of full_ring_order). Ranks are
        distinct and order-equivalent to the signed hashes, so devices can
        rebuild adjacency by sorting int32 ranks instead of 64-bit keys."""
        if self._ring_rank is None:
            order = self.full_ring_order()
            k, c = order.shape
            rank = np.empty((k, c), dtype=np.int32)
            cols = np.arange(c, dtype=np.int32)
            for ring in range(k):
                rank[ring, order[ring]] = cols
            self._ring_rank = rank
        return self._ring_rank

    def node_hashes(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Per-node xxHash64 inputs to the configuration-id fold, cached:
        (id_high_h, id_low_h, host_h, port_h), each uint64[C]. The chained
        fold (MembershipView.java:535-547) hashes each element independently
        before folding, so per-node hashes are membership-invariant."""
        if self._node_hashes is None:
            n = self.capacity
            eight = np.full(n, 8, dtype=np.int64)
            self._node_hashes = (
                xxh64_batch_auto(_int64_le_bytes(self.id_high), eight),
                xxh64_batch_auto(_int64_le_bytes(self.id_low), eight),
                xxh64_batch_auto(self.hostnames, self.host_lengths),
                xxh64_batch_auto(
                    _port_le_bytes(self.ports), np.full(n, 4, dtype=np.int64)
                ),
            )
        return self._node_hashes

    def assign_identity(
        self, slot: int, hostname: bytes, port: int, id_high: int, id_low: int
    ) -> None:
        """Replace a slot's identity (endpoint + NodeId), so a real process
        seated in a spare slot takes part in ring construction and
        configuration identity exactly like a synthesized node. Only the
        slot's column of the ring hashes and element hashes is recomputed;
        order caches rebuild lazily."""
        if len(hostname) > self.hostnames.shape[1]:
            grown = np.zeros(
                (self.capacity, len(hostname)), dtype=np.uint8
            )
            grown[:, : self.hostnames.shape[1]] = self.hostnames
            self.hostnames = grown
        self.hostnames[slot, :] = 0
        self.hostnames[slot, : len(hostname)] = np.frombuffer(hostname, np.uint8)
        self.host_lengths[slot] = len(hostname)
        self.ports[slot] = port
        self.id_high[slot] = id_high
        self.id_low[slot] = id_low
        for ring in range(self.ring_hashes.shape[0]):
            self.ring_hashes[ring, slot] = np.uint64(
                endpoint_hash(hostname, port, ring)
            )
        if self._node_hashes is not None:
            high_h, low_h, host_h, port_h = self._node_hashes
            high_h[slot] = np.uint64(xxh64(_int64_le_bytes(
                np.array([id_high], dtype=np.int64))[0].tobytes()))
            low_h[slot] = np.uint64(xxh64(_int64_le_bytes(
                np.array([id_low], dtype=np.int64))[0].tobytes()))
            host_h[slot] = np.uint64(xxh64(hostname))
            port_h[slot] = np.uint64(xxh64(_port_le_bytes(
                np.array([port], dtype=np.int64))[0].tobytes()))
        self._full_order = None
        self._ring_rank = None

    @staticmethod
    def synthesize(capacity: int, k: int, seed: int = 0) -> "VirtualCluster":
        """Synthetic but *realistic* identities: distinct host:port strings and
        UUID-style node ids, hashed exactly as the JVM would."""
        rng = np.random.default_rng(seed)
        # vectorized "10.a.b.c" construction (np.char.mod is a C-level
        # sprintf; a Python f-string loop over 1M rows costs whole seconds):
        # the <S14 bytes view is zero-padded exactly like pack_hostnames
        idx = np.arange(capacity, dtype=np.int64)
        octet = [np.char.mod("%d", (idx >> s) & 0xFF) for s in (16, 8, 0)]
        dotted = np.char.add("10", np.char.add(".", octet[0]))
        for part in octet[1:]:
            dotted = np.char.add(dotted, np.char.add(".", part))
        packed = dotted.astype("S")
        lengths = np.char.str_len(packed).astype(np.int64)
        data = np.ascontiguousarray(packed.view(np.uint8)).reshape(
            capacity, packed.dtype.itemsize
        )
        ports = np.full(capacity, 5000, dtype=np.int64) + (
            np.arange(capacity, dtype=np.int64) % 1000
        )
        id_high = rng.integers(-(2**63), 2**63, size=capacity, dtype=np.int64)
        id_low = rng.integers(-(2**63), 2**63, size=capacity, dtype=np.int64)
        from .. import native

        ring_hashes = native.ring_hashes(data, lengths, ports, k)
        if ring_hashes is None:
            ring_hashes = np.stack(
                [endpoint_hash_batch(data, lengths, ports, ring) for ring in range(k)]
            )
        return VirtualCluster(
            hostnames=data,
            host_lengths=lengths,
            ports=ports,
            id_high=id_high,
            id_low=id_low,
            ring_hashes=ring_hashes,
        )


@dataclass(frozen=True)
class LatencyTopology:
    """Deterministic rack/zone/region placement with a tiered RTT model.

    Node ``i`` lives in rack ``i % racks``, zone ``rack % zones``, region
    ``zone % regions`` -- pure functions of the index, so the same topology
    object describes the protocol plane (endpoints mapped to indices by the
    fault plane) and the device plane (slots ARE indices) with no shared
    state. The RTT between two nodes is the widest tier that separates them:

        same rack    -> rack_rtt_ms      (ToR switch hop)
        same zone    -> zone_rtt_ms      (aggregation fabric)
        same region  -> region_rtt_ms    (inter-zone backbone)
        cross-region -> inter_region_rtt_ms  (WAN)

    Everything derives from these five integers; there is no RNG anywhere,
    so a topology is replayable bit-identically wherever it is consulted.
    """

    racks: int = 4
    zones: int = 2
    regions: int = 1
    rack_rtt_ms: int = 0
    zone_rtt_ms: int = 1
    region_rtt_ms: int = 2
    inter_region_rtt_ms: int = 150

    def __post_init__(self) -> None:
        if not (self.racks >= self.zones >= self.regions >= 1):
            raise ValueError(
                f"need racks >= zones >= regions >= 1, got "
                f"{self.racks}/{self.zones}/{self.regions}"
            )
        if not (0 <= self.rack_rtt_ms <= self.zone_rtt_ms
                <= self.region_rtt_ms <= self.inter_region_rtt_ms):
            raise ValueError("tier RTTs must be non-decreasing outward")

    # -- placement (pure functions of the node index) -----------------------

    def rack_of(self, i: int) -> int:
        return i % self.racks

    def zone_of(self, i: int) -> int:
        return self.rack_of(i) % self.zones

    def region_of(self, i: int) -> int:
        return self.zone_of(i) % self.regions

    # -- latency -------------------------------------------------------------

    def rtt_ms(self, i: int, j: int) -> int:
        if i == j:
            return 0
        if self.region_of(i) != self.region_of(j):
            return self.inter_region_rtt_ms
        if self.zone_of(i) != self.zone_of(j):
            return self.region_rtt_ms
        if self.rack_of(i) != self.rack_of(j):
            return self.zone_rtt_ms
        return self.rack_rtt_ms

    def one_way_ms(self, i: int, j: int) -> int:
        return self.rtt_ms(i, j) // 2

    def rtt_matrix(self, n: int) -> np.ndarray:
        """[n, n] int32 RTT matrix, vectorized over the tier comparisons."""
        idx = np.arange(n, dtype=np.int64)
        rack = idx % self.racks
        zone = rack % self.zones
        region = zone % self.regions
        out = np.full((n, n), self.rack_rtt_ms, dtype=np.int32)
        out[rack[:, None] != rack[None, :]] = self.zone_rtt_ms
        out[zone[:, None] != zone[None, :]] = self.region_rtt_ms
        out[region[:, None] != region[None, :]] = self.inter_region_rtt_ms
        np.fill_diagonal(out, 0)
        return out

    # -- device-plane compilation helpers ------------------------------------

    def group_assignment(self, capacity: int) -> np.ndarray:
        """Per-slot delivery group (= zone id) for
        ``Simulator.set_delivery_groups``: zones are the unit of broadcast
        heterogeneity on the device plane."""
        idx = np.arange(capacity, dtype=np.int64)
        return ((idx % self.racks) % self.zones).astype(np.int32)

    def delay_rounds(self, zone_a: int, zone_b: int, round_ms: int) -> int:
        """One-way broadcast latency between two zones in whole device
        rounds (floor: sub-round latency is absorbed by the round model,
        mirroring the fault plane's DelayRule compilation rule)."""
        if zone_a == zone_b:
            return 0
        if zone_a % self.regions != zone_b % self.regions:
            return (self.inter_region_rtt_ms // 2) // round_ms
        return (self.region_rtt_ms // 2) // round_ms


def build_adjacency(
    cluster: VirtualCluster, active: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """subjects[C, K] and observers[C, K] over the active membership.

    subjects[i, k] is the ring-k predecessor of node i (the node i monitors,
    MembershipView.java:309-323); observers[i, k] the ring-k successor
    (MembershipView.java:235-258). Inactive rows are set to the node itself.
    """
    full_order = cluster.full_ring_order()
    k_rings, capacity = cluster.ring_hashes.shape
    subjects = np.tile(np.arange(capacity, dtype=np.int32)[:, None], (1, k_rings))
    observers = subjects.copy()
    if int(active.sum()) <= 1:
        return subjects, observers
    for ring in range(k_rings):
        fo = full_order[ring]
        ring_nodes = fo[active[fo]]
        preds = np.roll(ring_nodes, 1)
        succs = np.roll(ring_nodes, -1)
        subjects[ring_nodes, ring] = preds
        observers[ring_nodes, ring] = succs
    return subjects, observers


def ring_order(cluster: VirtualCluster, active: np.ndarray, ring: int = 0) -> np.ndarray:
    """Active node ids in ring-``ring`` order (the reference's getRing)."""
    fo = cluster.full_ring_order()[ring]
    return fo[active[fo]]


def configuration_id_vectorized(
    id_high: np.ndarray,
    id_low: np.ndarray,
    hostnames: np.ndarray,
    host_lengths: np.ndarray,
    ports: np.ndarray,
) -> int:
    """Chained configuration hash (MembershipView.java:535-547), vectorized.

    The fold h = h*37 + x_i over m elements equals
    ``37^m + sum_i x_i * 37^(m-1-i)`` (mod 2^64); with precomputed power
    ladders this is O(m) vector ops instead of an O(m) Python loop.
    Inputs must already be ordered: identifiers by NodeId order, endpoints in
    ring-0 order.
    """
    with np.errstate(over="ignore"):
        id_high_h = xxh64_batch(
            _int64_le_bytes(id_high), np.full(len(id_high), 8, dtype=np.int64), 0
        )
        id_low_h = xxh64_batch(
            _int64_le_bytes(id_low), np.full(len(id_low), 8, dtype=np.int64), 0
        )
        host_h = xxh64_batch(hostnames, host_lengths, 0)
        port_bytes = _port_le_bytes(ports)
        port_h = xxh64_batch(port_bytes, np.full(len(ports), 4, dtype=np.int64), 0)

    return config_fold(id_high_h, id_low_h, host_h, port_h)


_POWER_LADDER = np.ones(1, dtype=_U64)  # [37^0, 37^1, ...], grown on demand


def _powers_of_37(m: int) -> np.ndarray:
    """[37^0 .. 37^m] mod 2^64, served from a module-level ladder cache (the
    fold runs on every view change; the ladder only depends on length)."""
    global _POWER_LADDER
    if len(_POWER_LADDER) <= m:
        n = len(_POWER_LADDER)
        grown = np.empty(m + 1, dtype=_U64)
        grown[:n] = _POWER_LADDER
        with np.errstate(over="ignore"):
            grown[n:] = _POWER_LADDER[n - 1] * np.cumprod(
                np.full(m + 1 - n, 37, dtype=_U64)
            )
        _POWER_LADDER = grown
    return _POWER_LADDER[: m + 1]


def config_fold(
    id_high_h: np.ndarray,
    id_low_h: np.ndarray,
    host_h: np.ndarray,
    port_h: np.ndarray,
) -> int:
    """Fold already-hashed elements into the chained configuration identity
    (MembershipView.java:535-547): h = h*37 + x_i over m elements equals
    ``37^m + sum_i x_i * 37^(m-1-i)`` (mod 2^64), O(m) vector ops.

    Inputs are the per-element xxHash64 values, identifiers ordered by NodeId,
    endpoints in ring-0 order (e.g. gathered from VirtualCluster.node_hashes).
    Returns a Java signed long.
    """
    with np.errstate(over="ignore"):
        # interleave: id_high_0, id_low_0, id_high_1, ... then host_0, port_0, ...
        ids = np.empty(2 * len(id_high_h), dtype=_U64)
        ids[0::2] = id_high_h
        ids[1::2] = id_low_h
        eps = np.empty(2 * len(port_h), dtype=_U64)
        eps[0::2] = host_h
        eps[1::2] = port_h
        xs = np.concatenate([ids, eps])
        from .. import native

        native_total = native.config_fold(xs)
        if native_total is not None:
            return native_total
        m = len(xs)
        pw = _powers_of_37(m)
        powers = pw[:m][::-1]  # [37^(m-1), ..., 37^0]
        # h = 1*37^m + sum x_j * 37^(m-1-j)
        total = pw[m] + (xs * powers).sum(dtype=_U64)
    return int(total.astype(np.int64))
