"""The protocol messages the simulator bridge speaks, as plain dataclasses.

The port's own copy of the classes of ``rapid_tpu/types.py`` that
``sim/bridge.py`` builds and dispatches on (the reference's protobuf schema,
rapid.proto:13-206): the same names, field names, defaults, ordering and
equality, and nothing else of that module. Standard library only: no wire
codec, no msgpack, no protobuf. A bridge whose real members run on
``rapid_tpu``'s protocol plane is handed that plane's classes instead
(``sim.bridge.Protocol``), since those members dispatch on their own
classes.
"""

from __future__ import annotations

import enum
import uuid as _uuid
from dataclasses import dataclass
from typing import Optional, Tuple, Union


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


RapidMessage = Union[
    PreJoinMessage, JoinMessage, JoinResponse, AlertMessage, BatchedAlertMessage,
    ProbeMessage, ProbeResponse, FastRoundPhase2bMessage, Phase1aMessage,
    Phase1bMessage, Phase2aMessage, Phase2bMessage, LeaveMessage, Response,
    ConsensusResponse, FastRoundVoteBatch,
]
