"""The Rapid wire schema as a table: the port's copy of
``rapid_tpu/messaging/wire_schema.py`` without ``google.protobuf``.

Wire compatibility with the reference is defined by field numbers and types
(rapid/src/main/proto/rapid.proto:13-206), not by .proto source text, so
the schema lives here as a table: every message's fields, the two oneof
envelopes, the enums and the gRPC method. The JAX package compiles the same
table into protobuf classes; the port builds no descriptor pool and no
message classes: ``messaging/proto_wire.py`` encodes and decodes the proto3
wire format straight from this table, byte for byte as protobuf does.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# (name, type, number, repeated?) -- type "M:Name" = message, "E:Name" = enum
_MESSAGES: Dict[str, List[Tuple[str, str, int, bool]]] = {
    "Endpoint": [("hostname", "bytes", 1, False), ("port", "int32", 2, False)],
    "NodeId": [("high", "int64", 1, False), ("low", "int64", 2, False)],
    "PreJoinMessage": [
        ("sender", "M:Endpoint", 1, False),
        ("nodeId", "M:NodeId", 2, False),
        ("ringNumber", "int32", 3, True),
        ("configurationId", "int64", 4, False),
    ],
    "JoinMessage": [
        ("sender", "M:Endpoint", 1, False),
        ("nodeId", "M:NodeId", 2, False),
        ("ringNumber", "int32", 3, True),
        ("configurationId", "int64", 4, False),
        ("metadata", "M:Metadata", 5, False),
    ],
    "JoinResponse": [
        ("sender", "M:Endpoint", 1, False),
        ("statusCode", "E:JoinStatusCode", 2, False),
        ("configurationId", "int64", 3, False),
        ("endpoints", "M:Endpoint", 4, True),
        ("identifiers", "M:NodeId", 5, True),
        ("metadataKeys", "M:Endpoint", 6, True),
        ("metadataValues", "M:Metadata", 7, True),
    ],
    "BatchedAlertMessage": [
        ("sender", "M:Endpoint", 1, False),
        ("messages", "M:AlertMessage", 3, True),
    ],
    "AlertMessage": [
        ("edgeSrc", "M:Endpoint", 1, False),
        ("edgeDst", "M:Endpoint", 2, False),
        ("edgeStatus", "E:EdgeStatus", 3, False),
        ("configurationId", "int64", 4, False),
        ("ringNumber", "int32", 5, True),
        ("nodeId", "M:NodeId", 6, False),
        ("metadata", "M:Metadata", 7, False),
    ],
    "Response": [],
    "FastRoundPhase2bMessage": [
        ("sender", "M:Endpoint", 1, False),
        ("configurationId", "int64", 2, False),
        ("endpoints", "M:Endpoint", 3, True),
    ],
    "Rank": [("round", "int32", 1, False), ("nodeIndex", "int32", 2, False)],
    "Phase1aMessage": [
        ("sender", "M:Endpoint", 1, False),
        ("configurationId", "int64", 2, False),
        ("rank", "M:Rank", 3, False),
    ],
    "Phase1bMessage": [
        ("sender", "M:Endpoint", 1, False),
        ("configurationId", "int64", 2, False),
        ("rnd", "M:Rank", 3, False),
        ("vrnd", "M:Rank", 4, False),
        ("vval", "M:Endpoint", 5, True),
    ],
    "Phase2aMessage": [
        ("sender", "M:Endpoint", 1, False),
        ("configurationId", "int64", 2, False),
        ("rnd", "M:Rank", 3, False),
        ("vval", "M:Endpoint", 5, True),
    ],
    "Phase2bMessage": [
        ("sender", "M:Endpoint", 1, False),
        ("configurationId", "int64", 2, False),
        ("rnd", "M:Rank", 3, False),
        ("endpoints", "M:Endpoint", 4, True),
    ],
    "ConsensusResponse": [],
    "LeaveMessage": [("sender", "M:Endpoint", 1, False)],
    "ProbeMessage": [("sender", "M:Endpoint", 1, False), ("payload", "bytes", 3, True)],
    "ProbeResponse": [("status", "E:NodeStatus", 1, False)],
    # rapid-tpu extensions (not in the reference rapid.proto). Proto3 peers
    # that predate them ignore unknown fields/oneof entries natively, so the
    # schema stays wire-compatible in both directions.
    "TraceContext": [
        ("traceId", "int64", 1, False),
        ("parentSpanId", "int64", 2, False),
        ("origin", "string", 3, False),
        ("flags", "int32", 4, False),
    ],
    # forensics plane: hybrid logical clock stamp; rides outside the request
    # oneof like TraceContext, so pre-forensics peers skip it natively
    "HlcStamp": [
        ("physicalMs", "int64", 1, False),
        ("logical", "int64", 2, False),
        ("incarnation", "int64", 3, False),
    ],
    "ClusterStatusRequest": [
        ("sender", "M:Endpoint", 1, False),
        ("includeHistory", "int32", 2, False),
    ],
    "ClusterStatusResponse": [
        ("sender", "M:Endpoint", 1, False),
        ("configurationId", "int64", 2, False),
        ("membershipSize", "int32", 3, False),
        ("reportsTracked", "int32", 4, False),
        ("preProposalSize", "int32", 5, False),
        ("proposalSize", "int32", 6, False),
        ("updatesInProgress", "int32", 7, False),
        ("consensusDecided", "int32", 8, False),
        ("consensusVotes", "int32", 9, False),
        ("metricNames", "string", 10, True),
        ("metricValues", "int64", 11, True),
        ("journal", "string", 12, True),
        # placement plane exposure; proto3 unknown-field tolerance keeps
        # peers without placement interoperable
        ("placementVersion", "int64", 13, False),
        ("placementPartitions", "int32", 14, False),
        ("placementOwned", "int32", 15, False),
        # handoff plane exposure: session counts plus the local partition
        # store's (id, fingerprint) digest as parallel arrays
        ("handoffInFlight", "int32", 16, False),
        ("handoffCompleted", "int32", 17, False),
        ("handoffFailed", "int32", 18, False),
        ("handoffPartitions", "int64", 19, True),
        ("handoffFingerprints", "int64", 20, True),
        # serving plane exposure: request counters plus the local replica's
        # (partition id, leader "host:port") digest as parallel arrays
        ("servingGets", "int64", 21, False),
        ("servingPuts", "int64", 22, False),
        ("servingPutAcks", "int64", 23, False),
        ("servingPartitions", "int64", 24, True),
        ("servingLeaders", "string", 25, True),
        # failure-detector plane exposure: per-edge (subject, rtt micros,
        # suspicion milli) digest plus per-tier adapted FD parameters as
        # parallel arrays (integer units: proto3 floats are deliberately
        # absent from this schema)
        ("fdSubjects", "string", 26, True),
        ("fdRttMicros", "int64", 27, True),
        ("fdSuspicionMilli", "int64", 28, True),
        ("fdTiers", "string", 29, True),
        ("fdTierIntervalMs", "int64", 30, True),
        ("fdTierThreshold", "int64", 31, True),
        ("fdTierFlushMs", "int64", 32, True),
        # profiling plane exposure: the metric history-ring tail as JSON
        # lines (one snapshot per line, MetricsHistory.to_wire)
        ("history", "string", 33, True),
        # durability plane exposure: WAL segment count, last snapshot
        # version, and records replayed by the most recent recovery
        ("durabilitySegments", "int64", 34, False),
        ("durabilitySnapshotVersion", "int64", 35, False),
        ("durabilityReplayed", "int64", 36, False),
        # SLO plane exposure: per-alert ("slo:window" name, short-window
        # burn rate in thousandths, firing flag, attributed churn trace
        # id) as parallel arrays (integer milli units: no proto3 floats
        # in this schema)
        ("sloNames", "string", 37, True),
        ("sloBurnMilli", "int64", 38, True),
        ("sloFiring", "int64", 39, True),
        ("sloAttributedTrace", "int64", 40, True),
        # forensics plane exposure: journal truncation accounting plus the
        # node's current hybrid-logical-clock reading (append-only: old
        # peers ignore 41+, new peers read zeros from old peers)
        ("journalDropped", "int64", 41, False),
        ("journalCapacity", "int64", 42, False),
        ("hlcPhysicalMs", "int64", 43, False),
        ("hlcLogical", "int64", 44, False),
        ("hlcIncarnation", "int64", 45, False),
        # hierarchy plane exposure: the member's cell, its cell-local
        # size, the parent (leader-set) configuration id, the composed
        # global fingerprint, and the per-cell rows of the composed view
        # as parallel arrays (append-only)
        ("cellId", "int64", 46, False),
        ("cellSize", "int64", 47, False),
        ("parentConfigurationId", "int64", 48, False),
        ("globalFingerprint", "int64", 49, False),
        ("globalCells", "int64", 50, True),
        ("globalEpochs", "int64", 51, True),
        ("globalSizes", "int64", 52, True),
        ("globalLeaders", "string", 53, True),
    ],
    "HandoffRequest": [
        ("sender", "M:Endpoint", 1, False),
        ("sessionId", "int64", 2, False),
        ("partition", "int64", 3, False),
        ("offset", "int64", 4, False),
        ("length", "int64", 5, False),
        ("mapVersion", "int64", 6, False),
    ],
    "HandoffChunk": [
        ("sender", "M:Endpoint", 1, False),
        ("sessionId", "int64", 2, False),
        ("partition", "int64", 3, False),
        ("offset", "int64", 4, False),
        ("data", "bytes", 5, False),
        ("totalSize", "int64", 6, False),
        ("fingerprint", "int64", 7, False),
        ("status", "int32", 8, False),
    ],
    "HandoffAck": [
        ("sender", "M:Endpoint", 1, False),
        ("sessionId", "int64", 2, False),
        ("partition", "int64", 3, False),
        ("fingerprint", "int64", 4, False),
        ("mapVersion", "int64", 5, False),
    ],
    "Get": [
        ("sender", "M:Endpoint", 1, False),
        ("key", "bytes", 2, False),
        ("quorum", "int32", 3, False),
        ("mapVersion", "int64", 4, False),
    ],
    "Put": [
        ("sender", "M:Endpoint", 1, False),
        ("key", "bytes", 2, False),
        ("value", "bytes", 3, False),
        ("requestId", "int64", 4, False),
        ("replicate", "int32", 5, False),
        ("version", "int64", 6, False),
        ("mapVersion", "int64", 7, False),
    ],
    "PutAck": [
        ("sender", "M:Endpoint", 1, False),
        ("status", "int32", 2, False),
        ("key", "bytes", 3, False),
        ("value", "bytes", 4, False),
        ("version", "int64", 5, False),
        ("requestId", "int64", 6, False),
        ("leader", "M:Endpoint", 7, False),
        ("mapVersion", "int64", 8, False),
    ],
    # transport batch envelope: whole RapidRequest envelopes nested so each
    # inner request keeps its own oneof discriminator (and trace context)
    "MessageBatch": [
        ("sender", "M:Endpoint", 1, False),
        ("requests", "M:RapidRequest", 2, True),
    ],
    # hierarchy plane: a leader's announcement of its cell's row
    # (leader-to-leader) and the composed global view a leader fans back
    # into its own cell (leader-to-cell), as parallel per-cell arrays
    "CellDigestMessage": [
        ("sender", "M:Endpoint", 1, False),
        ("cell", "int64", 2, False),
        ("configurationId", "int64", 3, False),
        ("membershipSize", "int64", 4, False),
        ("leader", "string", 5, False),
        ("fingerprint", "int64", 6, False),
        ("parentRound", "int64", 7, False),
    ],
    "GlobalViewMessage": [
        ("sender", "M:Endpoint", 1, False),
        ("parentConfigurationId", "int64", 2, False),
        ("globalFingerprint", "int64", 3, False),
        ("cells", "int64", 4, True),
        ("epochs", "int64", 5, True),
        ("sizes", "int64", 6, True),
        ("leaders", "string", 7, True),
        ("fingerprints", "int64", 8, True),
        ("parentRound", "int64", 9, False),
    ],
}

# Trace context rides OUTSIDE the request oneof (a sibling of `content`):
# field 15 on RapidRequest, chosen above the reference's last oneof number
# so a JVM peer's decoder skips it as an unknown field.
TRACE_CTX_FIELD_NUMBER = 15

# The hybrid-logical-clock stamp rides outside the oneof too: field 18,
# the next number above the oneof's current maximum (17), reserved the
# same way 15 is -- future oneof entries must skip both.
HLC_FIELD_NUMBER = 18

# The oneof envelopes (rapid.proto:21-45): (field, message type, number)
_REQUEST_ONEOF = [
    ("preJoinMessage", "PreJoinMessage", 1),
    ("joinMessage", "JoinMessage", 2),
    ("batchedAlertMessage", "BatchedAlertMessage", 3),
    ("probeMessage", "ProbeMessage", 4),
    ("fastRoundPhase2bMessage", "FastRoundPhase2bMessage", 5),
    ("phase1aMessage", "Phase1aMessage", 6),
    ("phase1bMessage", "Phase1bMessage", 7),
    ("phase2aMessage", "Phase2aMessage", 8),
    ("phase2bMessage", "Phase2bMessage", 9),
    ("leaveMessage", "LeaveMessage", 10),
    ("clusterStatusRequest", "ClusterStatusRequest", 11),
    # 12/13 are handoff-plane extensions, 14/16 serving-plane extensions,
    # 17 the transport batch envelope; 15 is reserved for traceCtx
    # (TRACE_CTX_FIELD_NUMBER) and 18 for hlc (HLC_FIELD_NUMBER), both of
    # which ride outside the oneof -- the extension messages skip them, so
    # the oneof is contiguous from 1 except for those documented gaps
    ("handoffRequest", "HandoffRequest", 12),
    ("handoffAck", "HandoffAck", 13),
    ("get", "Get", 14),
    ("put", "Put", 16),
    ("messageBatch", "MessageBatch", 17),
    # 19/20 are hierarchy-plane extensions (18 is reserved for hlc above)
    ("cellDigestMessage", "CellDigestMessage", 19),
    ("globalViewMessage", "GlobalViewMessage", 20),
]
_RESPONSE_ONEOF = [
    ("joinResponse", "JoinResponse", 1),
    ("response", "Response", 2),
    ("consensusResponse", "ConsensusResponse", 3),
    ("probeResponse", "ProbeResponse", 4),
    ("clusterStatusResponse", "ClusterStatusResponse", 5),
    ("handoffChunk", "HandoffChunk", 6),
    ("putAck", "PutAck", 7),
]

_ENUMS = {
    "JoinStatusCode": [
        ("HOSTNAME_ALREADY_IN_RING", 0),
        ("UUID_ALREADY_IN_RING", 1),
        ("SAFE_TO_JOIN", 2),
        ("CONFIG_CHANGED", 3),
        ("MEMBERSHIP_REJECTED", 4),
    ],
    "EdgeStatus": [("UP", 0), ("DOWN", 1)],
    "NodeStatus": [("OK", 0), ("BOOTSTRAPPING", 1)],
}

PACKAGE = "remoting"
SERVICE = "MembershipService"
METHOD = "sendRequest"
GRPC_METHOD_PATH = f"/{PACKAGE}.{SERVICE}/{METHOD}"

# Metadata (rapid.proto:47-49) is a map<string, bytes>, which proto3 puts on
# the wire as a repeated nested entry message with the key as field 1 and
# the value as field 2 (the descriptor's MetadataEntry with map_entry set).
# A map entry writes both fields even at their defaults.
METADATA_ENTRY = "Metadata.MetadataEntry"
_MAPS: Dict[str, List[Tuple[str, str, int, bool]]] = {
    "Metadata": [("metadata", f"M:{METADATA_ENTRY}", 1, True)],
    METADATA_ENTRY: [("key", "string", 1, False), ("value", "bytes", 2, False)],
}
