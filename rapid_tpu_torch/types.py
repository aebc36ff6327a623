"""The protocol messages of the port, as plain dataclasses.

The port's own copy of the message classes of ``rapid_tpu/types.py`` (the
reference's protobuf schema, rapid.proto:13-206, and rapid-tpu's
extensions): the same names, field names, defaults, ordering and equality.
``sim/bridge.py`` builds and dispatches on them, and the wire codec
(``messaging/codec.py``) numbers every one of them, so any frame a
``rapid_tpu`` peer sends decodes here. Standard library only: no msgpack,
no protobuf. A bridge whose real members run in the same process on
``rapid_tpu``'s protocol plane is handed that plane's classes instead
(``sim.bridge.Protocol``), since those members dispatch on their own
classes; over a socket only the bytes cross.
"""

from __future__ import annotations

import enum
import uuid as _uuid
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union


class EdgeStatus(enum.IntEnum):
    """rapid.proto:96-99 (EdgeStatus UP/DOWN)."""

    UP = 0
    DOWN = 1


class JoinStatusCode(enum.IntEnum):
    """rapid.proto:64-72."""

    HOSTNAME_ALREADY_IN_RING = 0
    UUID_ALREADY_IN_RING = 1
    SAFE_TO_JOIN = 2
    CONFIG_CHANGED = 3
    MEMBERSHIP_REJECTED = 4


class NodeStatus(enum.IntEnum):
    """rapid.proto:197-200 (probe responses)."""

    OK = 0
    BOOTSTRAPPING = 1


@dataclass(frozen=True, order=True)
class Endpoint:
    """A process address: rapid.proto:13-17 (Endpoint{bytes hostname, int32 port})."""

    hostname: bytes
    port: int

    def __str__(self) -> str:
        return f"{self.hostname.decode('utf-8', 'replace')}:{self.port}"

    @staticmethod
    def from_parts(hostname: str, port: int) -> "Endpoint":
        if not 0 <= port <= 65535:
            raise ValueError(f"invalid port: {port}")
        return Endpoint(hostname.encode("utf-8"), port)

    @staticmethod
    def from_string(host_string: str) -> "Endpoint":
        """Parse 'host:port' (Utils.hostFromString, Utils.java:64-69)."""
        host, sep, port = host_string.rpartition(":")
        if not sep or not host:
            raise ValueError(f"invalid host:port string: {host_string!r}")
        return Endpoint.from_parts(host, int(port))


@dataclass(frozen=True, order=True)
class NodeId:
    """128-bit logical node identifier; rapid.proto:50-54 (NodeId{int64 high, low}).

    Ordering matches the reference NodeIdComparator (MembershipView.java:465-491):
    signed compare on `high`, then `low` -- both stored as Java-style signed 64-bit.
    """

    high: int
    low: int

    @staticmethod
    def from_uuid(u: _uuid.UUID) -> "NodeId":
        def _signed(x: int) -> int:
            return x - (1 << 64) if x >= (1 << 63) else x

        return NodeId(_signed(u.int >> 64), _signed(u.int & ((1 << 64) - 1)))

    @staticmethod
    def random(rng=None) -> "NodeId":
        if rng is None:
            return NodeId.from_uuid(_uuid.uuid4())
        return NodeId.from_uuid(_uuid.UUID(int=rng.getrandbits(128), version=4))


# Application metadata tags: rapid.proto:56-58. Keys are strings, values bytes.
Metadata = Dict[str, bytes]


def freeze_metadata(metadata: Optional[Metadata]) -> Tuple[Tuple[str, bytes], ...]:
    if not metadata:
        return ()
    return tuple(sorted(metadata.items()))


@dataclass(frozen=True)
class PreJoinMessage:
    """Join protocol phase 1, joiner -> seed (rapid.proto:60-63)."""

    sender: Endpoint
    node_id: NodeId


@dataclass(frozen=True)
class JoinMessage:
    """Join protocol phase 2, joiner -> observer (rapid.proto:85-92)."""

    sender: Endpoint
    node_id: NodeId
    ring_numbers: Tuple[int, ...]
    configuration_id: int
    metadata: Tuple[Tuple[str, bytes], ...] = ()


@dataclass(frozen=True)
class JoinResponse:
    """Response for both join phases (rapid.proto:74-83)."""

    sender: Endpoint
    status_code: JoinStatusCode
    configuration_id: int
    endpoints: Tuple[Endpoint, ...] = ()
    identifiers: Tuple[NodeId, ...] = ()
    metadata: Tuple[Tuple[Endpoint, Tuple[Tuple[str, bytes], ...]], ...] = ()


@dataclass(frozen=True)
class AlertMessage:
    """An edge-status report by an observer (rapid.proto:101-110)."""

    edge_src: Endpoint
    edge_dst: Endpoint
    edge_status: EdgeStatus
    configuration_id: int
    ring_numbers: Tuple[int, ...]
    node_id: Optional[NodeId] = None  # set for UP alerts about joiners
    metadata: Tuple[Tuple[str, bytes], ...] = ()


@dataclass(frozen=True)
class BatchedAlertMessage:
    """Batched alerts flushed by the AlertBatcher (rapid.proto:112-115)."""

    sender: Endpoint
    messages: Tuple[AlertMessage, ...]


@dataclass(frozen=True)
class ProbeMessage:
    """Edge failure-detector probe (rapid.proto:186-190)."""

    sender: Endpoint


@dataclass(frozen=True)
class ProbeResponse:
    """rapid.proto:202-205."""

    status: NodeStatus = NodeStatus.OK


@dataclass(frozen=True, order=True)
class Rank:
    """Paxos rank = (round, nodeIndex); rapid.proto:133-137.

    Total order: round first, then node index (Paxos.compareRanks,
    Paxos.java:331-337) -- dataclass order matches.
    """

    round: int
    node_index: int


@dataclass(frozen=True)
class FastRoundPhase2bMessage:
    """Fast-round vote broadcast (rapid.proto:139-144)."""

    sender: Endpoint
    configuration_id: int
    endpoints: Tuple[Endpoint, ...]


@dataclass(frozen=True)
class Phase1aMessage:
    sender: Endpoint
    configuration_id: int
    rank: Rank


@dataclass(frozen=True)
class Phase1bMessage:
    sender: Endpoint
    configuration_id: int
    rnd: Rank
    vrnd: Rank
    vval: Tuple[Endpoint, ...]


@dataclass(frozen=True)
class Phase2aMessage:
    sender: Endpoint
    configuration_id: int
    rnd: Rank
    vval: Tuple[Endpoint, ...]


@dataclass(frozen=True)
class Phase2bMessage:
    sender: Endpoint
    configuration_id: int
    rnd: Rank
    endpoints: Tuple[Endpoint, ...]


@dataclass(frozen=True)
class LeaveMessage:
    """Graceful-leave intent (rapid.proto:182-184)."""

    sender: Endpoint


@dataclass(frozen=True)
class Response:
    """Empty acknowledgement (rapid.proto:47-48)."""


@dataclass(frozen=True)
class ConsensusResponse:
    """Empty consensus acknowledgement (rapid.proto:146-147)."""


@dataclass(frozen=True)
class FastRoundVoteBatch:
    """Transport-level fan-in of identical-value fast-round votes: one frame
    standing for one ``FastRoundPhase2bMessage`` per listed sender, all
    carrying the same ``(configuration_id, endpoints)`` value; the receiver
    tallies each (sender, value) exactly as it would the individual message,
    with the same per-sender dedup (rapid.proto has no such message)."""

    senders: Tuple[Endpoint, ...]
    configuration_id: int
    endpoints: Tuple[Endpoint, ...]


# The extension messages below complete the codec's tag table
# (messaging/codec.py): the port decodes and encodes them byte for byte as
# rapid_tpu does, but the bridge and gateway handle none of them. Their
# docstrings name the JAX package's modules that send and answer them.


@dataclass(frozen=True)
class MessageBatch:
    """Transport-level batch envelope: one frame carrying several otherwise
    independent requests to the same peer, flushed by a broadcaster's
    coalescing window (messaging/unicast.py / messaging/gossip.py with
    ``Settings.broadcast_flush_window_ms > 0``). Unlike FastRoundVoteBatch
    (identical-value votes only) the inner messages are heterogeneous: a
    churn wave's alerts, votes, and gossip ride one frame per peer. The
    receiver dispatches each inner message exactly as if it had arrived
    alone (one protocol task for the whole batch) and acks the envelope;
    inner responses are dropped -- batched sends are fire-and-forget
    broadcasts. Carried by both the native codec (tag 25) and the gRPC
    transport (oneof field 17); peers that never batch interop unchanged."""

    sender: "Endpoint"
    messages: Tuple[object, ...] = ()  # inner RapidMessage requests


@dataclass(frozen=True)
class GossipEnvelope:
    """Epidemic-relay wrapper around any protocol message.

    The gossip dissemination alternative the reference's broadcaster seam
    explicitly anticipates but never implements (IBroadcaster.java:24-26).
    ``gossip_id`` dedups relays cluster-wide; ``ttl`` bounds propagation
    depth. Carried by the native codec transports (tcp / in-process /
    native-tcp); the JVM-wire-compatible gRPC transport cannot carry it
    (rapid.proto has no such message).

    ``kind`` selects the anti-entropy sub-protocol frame (push-pull gossip
    mode, messaging/gossip.py): PAYLOAD carries the message itself; IHAVE
    advertises the id without the payload (tiny); PULL asks the advertiser
    to send the payload. Pre-push-pull frames carry no ``kind`` field and
    decode to PAYLOAD (0), so the wire stays backward compatible."""

    KIND_PAYLOAD = 0
    KIND_IHAVE = 1
    KIND_PULL = 2

    sender: "Endpoint"
    gossip_id: NodeId
    ttl: int
    payload: object = None  # any RapidMessage (None for IHAVE/PULL frames)
    kind: int = 0


@dataclass(frozen=True)
class ClusterStatusRequest:
    """Introspection RPC: ask any member for its view of the cluster.

    Not in rapid.proto's reference surface -- an extension message carried
    by every transport (the proto schema grows matching messages in
    messaging/wire_schema.py). Answered synchronously from protocol state,
    so it works while consensus is in flight and through the nemesis.

    ``include_history`` asks for up to that many metric history-ring
    snapshots in the response (0 = none, the default, which keeps the
    answer small and matches pre-profiling peers' frames)."""

    sender: Endpoint
    include_history: int = 0


@dataclass(frozen=True)
class ClusterStatusResponse:
    """One member's introspection snapshot.

    Cut-detector occupancy mirrors the K/H/L watermark machinery:
    ``reports_tracked`` = subjects with at least one report,
    ``pre_proposal_size`` = subjects past L but below H, ``proposal_size``
    = subjects past H awaiting a stable cut, ``updates_in_progress`` =
    subjects between the watermarks blocking the cut. ``metric_names`` /
    ``metric_values`` are a parallel-array counter digest (flat rendered
    names, see Metrics.snapshot); ``journal`` is the flight recorder's tail
    as JSON lines."""

    sender: Endpoint
    configuration_id: int
    membership_size: int
    reports_tracked: int = 0
    pre_proposal_size: int = 0
    proposal_size: int = 0
    updates_in_progress: int = 0
    consensus_decided: bool = False
    consensus_votes: int = 0
    metric_names: Tuple[str, ...] = ()
    metric_values: Tuple[int, ...] = ()
    journal: Tuple[str, ...] = ()
    # placement plane (0/absent when placement is not enabled): the map
    # fingerprint every member must agree on, the map geometry, and how
    # many partitions this member holds a replica of
    placement_version: int = 0
    placement_partitions: int = 0
    placement_owned: int = 0
    # handoff plane (0/absent when handoff is not enabled): session counts
    # plus a parallel (partition id, content fingerprint) digest of the local
    # partition store, so an operator tool can cross-check replicas holding
    # the same partition for byte-level divergence
    handoff_in_flight: int = 0
    handoff_completed: int = 0
    handoff_failed: int = 0
    handoff_partitions: Tuple[int, ...] = ()
    handoff_fingerprints: Tuple[int, ...] = ()
    # serving plane (0/absent when serving is not enabled): request counters
    # plus a parallel (partition id, leader "host:port") digest over the
    # partitions this member holds a replica of, so an operator tool can
    # cross-check that every replica of a partition agrees on its leader
    serving_gets: int = 0
    serving_puts: int = 0
    serving_put_acks: int = 0
    serving_partitions: Tuple[int, ...] = ()
    serving_leaders: Tuple[str, ...] = ()
    # failure-detector plane: parallel per-edge arrays (worst edge first --
    # suspicion desc, then RTT desc) and, when adaptive FD is on, parallel
    # per-tier arrays of the derived controller parameters. RTT in
    # microseconds and suspicion in thousandths because the wire schema
    # carries no float scalar.
    fd_subjects: Tuple[str, ...] = ()
    fd_rtt_micros: Tuple[int, ...] = ()
    fd_suspicion_milli: Tuple[int, ...] = ()
    fd_tiers: Tuple[str, ...] = ()
    fd_tier_interval_ms: Tuple[int, ...] = ()
    fd_tier_threshold: Tuple[int, ...] = ()
    fd_tier_flush_ms: Tuple[int, ...] = ()
    # profiling plane (empty unless profiling is enabled AND the request
    # set include_history): the node's metric history-ring tail as
    # sorted-key JSON lines (MetricsHistory.to_wire), the carriage a
    # scraper folds into a cluster-wide timeseries (profiling/scrape.py)
    history: Tuple[str, ...] = ()
    # durability plane (0/absent when durability is not enabled): live WAL
    # segment count, last snapshot version, and how many log records the
    # most recent recovery replayed -- the restart-health digest statusz
    # renders next to the handoff fingerprint cross-check
    durability_segments: int = 0
    durability_snapshot_version: int = 0
    durability_replayed: int = 0
    # SLO plane (empty unless slo is enabled): parallel per-alert arrays --
    # "slo:window" alert names, the current short-window burn rate in
    # thousandths, firing flags, and the attributed churn episode's trace
    # id (0 = unattributed) -- enough for an operator tool to render
    # "p99 burning, attributed to view-change episode <trace-id>"
    slo_names: Tuple[str, ...] = ()
    slo_burn_milli: Tuple[int, ...] = ()
    slo_firing: Tuple[int, ...] = ()
    slo_attributed_trace: Tuple[int, ...] = ()
    # forensics plane (0/absent when forensics is not enabled): journal
    # truncation accounting (entries the flight recorder dropped on
    # overflow, and the ring's capacity) plus the node's current hybrid
    # logical clock -- the coordinates evidence bundles merge timelines on
    journal_dropped: int = 0
    journal_capacity: int = 0
    hlc_physical_ms: int = 0
    hlc_logical: int = 0
    hlc_incarnation: int = 0
    # hierarchy plane (0/absent when hierarchy is not enabled; plane-on is
    # signalled by a non-empty global_cells, which always carries at least
    # the member's own cell): this member's cell, its cell-local
    # membership size, the parent (leader-set) configuration id, the
    # composed global fingerprint, and the parallel per-cell rows of the
    # composed global view -- the single-integer agreement surfaces
    # statusz cross-checks
    cell_id: int = 0
    cell_size: int = 0
    parent_configuration_id: int = 0
    global_fingerprint: int = 0
    global_cells: Tuple[int, ...] = ()
    global_epochs: Tuple[int, ...] = ()
    global_sizes: Tuple[int, ...] = ()
    global_leaders: Tuple[str, ...] = ()


@dataclass(frozen=True)
class CellDigestMessage:
    """Hierarchy plane, leader-to-leader: one cell's row of the composed
    global view, announced by that cell's rank-0 leader after every
    intra-cell view change (hierarchy/plane.py).

    ``configuration_id`` is the cell's local Rapid configuration id -- its
    epoch in the composed view, so stale/reordered digests are rejected
    deterministically. ``fingerprint`` is the fold over the cell's sorted
    member hashes (hierarchy/parent.py cell_fingerprint): two leaders
    disagreeing about who is in a cell compose differently even at equal
    sizes. ``parent_round`` is the sender's parent-round counter, the
    liveness stamp whole-cell eviction ages against. Carried by the native
    codec (tag 26) and the gRPC transport (oneof field 19); pre-hierarchy
    peers never see one (the plane is off by default)."""

    sender: Endpoint
    cell: int = 0
    configuration_id: int = 0
    membership_size: int = 0
    leader: str = ""
    fingerprint: int = 0
    parent_round: int = 0


@dataclass(frozen=True)
class GlobalViewMessage:
    """Hierarchy plane, leader-to-cell: the composed global view a leader
    fans back into its own cell after the composition moves, as parallel
    per-cell arrays (the ClusterStatusResponse digest shape).

    ``parent_configuration_id`` / ``global_fingerprint`` are the two
    single-integer agreement surfaces: the fold over the sorted leader-set
    hashes, and the fold over the per-cell row hashes
    (hierarchy/parent.py). Carried by the native codec (tag 27) and the
    gRPC transport (oneof field 20); intra-cell only, so it never crosses
    a cell boundary by construction."""

    sender: Endpoint
    parent_configuration_id: int = 0
    global_fingerprint: int = 0
    cells: Tuple[int, ...] = ()
    epochs: Tuple[int, ...] = ()
    sizes: Tuple[int, ...] = ()
    leaders: Tuple[str, ...] = ()
    fingerprints: Tuple[int, ...] = ()
    # the sending leader's monotonic parent-round counter: epochs are
    # configuration-id hashes (unordered), so receivers gate reordered
    # frames from the same leader by this stamp instead
    parent_round: int = 0


@dataclass(frozen=True)
class HandoffRequest:
    """Pull one chunk of a partition during a handoff session.

    Sent by the NEW owner (recipient) to a surviving OLD replica (source).
    Pull-based so the recipient controls pacing/backpressure and resume:
    after a transport failure it simply re-requests from the last offset it
    has not yet received -- the source keeps no per-session state. Not in
    rapid.proto's reference surface; carried as a rapid-tpu extension on
    every transport (msgpack tag 19, request oneof 12)."""

    sender: Endpoint
    session_id: int
    partition: int
    offset: int
    length: int
    map_version: int = 0


@dataclass(frozen=True)
class HandoffChunk:
    """One chunk of partition content, answering a HandoffRequest.

    ``total_size`` and ``fingerprint`` describe the FULL partition content
    at the source (signed xxh64), repeated on every chunk so the recipient
    can verify assembly regardless of which chunk arrives last and detect a
    source whose content changed mid-session. ``status`` 0 = OK, 1 = the
    source no longer holds the partition (recipient fails over). Msgpack
    tag 20, response oneof 6."""

    STATUS_OK = 0
    STATUS_NOT_FOUND = 1

    sender: Endpoint
    session_id: int
    partition: int
    offset: int
    data: bytes = b""
    total_size: int = 0
    fingerprint: int = 0
    status: int = 0


@dataclass(frozen=True)
class HandoffAck:
    """Verified-completion notice, recipient -> source (answered with the
    empty Response). Lets the source release the partition if the new map
    no longer assigns it a replica. Msgpack tag 21, request oneof 13."""

    sender: Endpoint
    session_id: int
    partition: int
    fingerprint: int = 0
    map_version: int = 0


@dataclass(frozen=True)
class Get:
    """Serving-plane read for one key, answered with a PutAck.

    Routed by the client to the partition leader (first live replica in
    placement order). ``quorum`` != 0 asks a replica to answer from its
    local store regardless of leadership -- the read-your-writes fallback
    fans a quorum Get to every replica and takes the max-version answer
    among a majority, which must intersect any acked write's quorum.
    ``map_version`` is the placement version the client routed against, so
    a stale-map request can be redirected. Not in rapid.proto's reference
    surface; a rapid-tpu extension (msgpack tag 22, request oneof 14)."""

    sender: Endpoint
    key: bytes
    quorum: int = 0
    map_version: int = 0


@dataclass(frozen=True)
class Put:
    """Serving-plane write for one key, answered with a PutAck.

    A client Put (``replicate`` == 0) goes to the partition leader, which
    assigns the key's next monotonic version, applies locally, and fans
    replication Puts (``replicate`` != 0, ``version`` set) to the other
    replicas; it acks the client once a majority of the replica row
    (itself included) has applied. Replicas apply a replicated Put only if
    its version is newer than what they hold, so duplicated or reordered
    replication is idempotent. ``request_id`` echoes back in the ack for
    client-side correlation. Msgpack tag 23, request oneof 16 (15 stays
    reserved for the traceCtx envelope field)."""

    sender: Endpoint
    key: bytes
    value: bytes = b""
    request_id: int = 0
    replicate: int = 0
    version: int = 0
    map_version: int = 0


@dataclass(frozen=True)
class PutAck:
    """The serving plane's unified reply to both Get and Put.

    ``status`` OK carries the value+version for Gets and the assigned
    version for Puts; NOT_LEADER carries a ``leader`` hint so the client
    can re-route after churn; NOT_FOUND is a miss on an OK read path;
    RETRY means the leader could not assemble a write quorum before its
    deadline (the write may or may not survive -- the client must re-issue
    with the same key to learn which). Msgpack tag 24, response oneof 7."""

    STATUS_OK = 0
    STATUS_NOT_LEADER = 1
    STATUS_NOT_FOUND = 2
    STATUS_RETRY = 3

    sender: Endpoint
    status: int = 0
    key: bytes = b""
    value: bytes = b""
    version: int = 0
    request_id: int = 0
    leader: Optional[Endpoint] = None
    map_version: int = 0


RapidMessage = Union[
    PreJoinMessage, JoinMessage, JoinResponse, AlertMessage, BatchedAlertMessage,
    ProbeMessage, ProbeResponse, FastRoundPhase2bMessage, Phase1aMessage,
    Phase1bMessage, Phase2aMessage, Phase2bMessage, LeaveMessage, Response,
    ConsensusResponse, FastRoundVoteBatch, MessageBatch, GossipEnvelope,
    ClusterStatusRequest, ClusterStatusResponse, CellDigestMessage,
    GlobalViewMessage, HandoffRequest, HandoffChunk, HandoffAck, Get, Put, PutAck,
]
