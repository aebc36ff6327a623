"""The gRPC wire's conversions: the port's protocol classes to and from the
RapidRequest / RapidResponse proto3 envelopes, as bytes.

The port's counterpart of the conversion half of
``rapid_tpu/messaging/grpc_transport.py`` (``_ep`` ... ``_alert_back``,
``to_wire_request``, ``from_wire_request``, ``to_wire_response``,
``from_wire_response``), over ``proto_wire.py`` in place of protobuf's
message classes: each conversion builds or reads the message as a dict of
the schema's field names, and the bytes are those protobuf's
``SerializeToString`` gives for the JAX package's message (with
``deterministic=True`` where a ``Metadata`` map is present). The request
envelope carries the trace context (field 15) and the HLC stamp (field 18)
outside its oneof.

The transport itself -- the one unary RPC ``wire_schema.GRPC_METHOD_PATH`` over
cleartext HTTP/2 with HPACK and gRPC's framing, ``GrpcServer`` and
``GrpcClient`` -- is not ported yet (ROADMAP.md Queue 1 item 8d.ii).
"""

from __future__ import annotations

import re
from typing import Any, Dict

from .. import types as T
from ..forensics.hlc import HlcStamp, hlc_of, stamp_hlc
from ..observability import TraceContext, stamp_trace_context, trace_context_of
from . import proto_wire

# ---------------------------------------------------------------------------
# dataclass <-> message dict conversion
# ---------------------------------------------------------------------------


def _ep(endpoint: T.Endpoint) -> Dict[str, Any]:
    return {"hostname": endpoint.hostname, "port": endpoint.port}


def _ep_back(msg: Dict[str, Any]) -> T.Endpoint:
    return T.Endpoint(bytes(msg.get("hostname", b"")), int(msg.get("port", 0)))


def _nid(node_id: T.NodeId) -> Dict[str, Any]:
    return {"high": node_id.high, "low": node_id.low}


def _nid_back(msg: Dict[str, Any]) -> T.NodeId:
    return T.NodeId(int(msg.get("high", 0)), int(msg.get("low", 0)))


def _rank(rank: T.Rank) -> Dict[str, Any]:
    return {"round": rank.round, "nodeIndex": rank.node_index}


def _rank_back(msg: Dict[str, Any]) -> T.Rank:
    return T.Rank(int(msg.get("round", 0)), int(msg.get("nodeIndex", 0)))


def _meta(metadata) -> Dict[str, Any]:
    return {"metadata": proto_wire.map_entries(metadata)}


def _meta_back(msg: Dict[str, Any]):
    table = {e.get("key", ""): bytes(e.get("value", b"")) for e in msg.get("metadata", ())}
    return tuple(sorted(table.items()))


def _alert(alert: T.AlertMessage) -> Dict[str, Any]:
    out = {
        "edgeSrc": _ep(alert.edge_src),
        "edgeDst": _ep(alert.edge_dst),
        "edgeStatus": int(alert.edge_status),
        "configurationId": alert.configuration_id,
        "ringNumber": alert.ring_numbers,
        "metadata": _meta(alert.metadata),
    }
    if alert.node_id is not None:
        out["nodeId"] = _nid(alert.node_id)
    return out


def _alert_back(msg: Dict[str, Any]) -> T.AlertMessage:
    return T.AlertMessage(
        edge_src=_ep_back(msg.get("edgeSrc", {})),
        edge_dst=_ep_back(msg.get("edgeDst", {})),
        edge_status=T.EdgeStatus(msg.get("edgeStatus", 0)),
        configuration_id=int(msg.get("configurationId", 0)),
        ring_numbers=tuple(msg.get("ringNumber", ())),
        node_id=_nid_back(msg["nodeId"]) if "nodeId" in msg else None,
        metadata=_meta_back(msg.get("metadata", {})),
    )


def _camel_to_snake(name: str) -> str:
    return re.sub(r"(?<!^)(?=[A-Z])", "_", name).lower()


# every field of ClusterStatusResponse but its sender: (wire name, attribute,
# repeated, kind), in field-number order
_STATUS_FIELDS = tuple(
    (f.name, _camel_to_snake(f.name), f.repeated, f.kind)
    for f in proto_wire.SCHEMA["ClusterStatusResponse"] if f.name != "sender"
)


def _request(msg: T.RapidMessage) -> Dict[str, Any]:
    """The RapidRequest dict of a protocol message, with its trace context
    and HLC stamp."""
    if isinstance(msg, T.PreJoinMessage):
        req = {"preJoinMessage": {"sender": _ep(msg.sender), "nodeId": _nid(msg.node_id)}}
    elif isinstance(msg, T.JoinMessage):
        req = {"joinMessage": {
            "sender": _ep(msg.sender),
            "nodeId": _nid(msg.node_id),
            "ringNumber": msg.ring_numbers,
            "configurationId": msg.configuration_id,
            "metadata": _meta(msg.metadata),
        }}
    elif isinstance(msg, T.BatchedAlertMessage):
        req = {"batchedAlertMessage": {
            "sender": _ep(msg.sender),
            "messages": [_alert(alert) for alert in msg.messages],
        }}
    elif isinstance(msg, T.ProbeMessage):
        req = {"probeMessage": {"sender": _ep(msg.sender)}}
    elif isinstance(msg, T.FastRoundPhase2bMessage):
        req = {"fastRoundPhase2bMessage": {
            "sender": _ep(msg.sender),
            "configurationId": msg.configuration_id,
            "endpoints": [_ep(e) for e in msg.endpoints],
        }}
    elif isinstance(msg, T.Phase1aMessage):
        req = {"phase1aMessage": {
            "sender": _ep(msg.sender),
            "configurationId": msg.configuration_id,
            "rank": _rank(msg.rank),
        }}
    elif isinstance(msg, T.Phase1bMessage):
        req = {"phase1bMessage": {
            "sender": _ep(msg.sender),
            "configurationId": msg.configuration_id,
            "rnd": _rank(msg.rnd),
            "vrnd": _rank(msg.vrnd),
            "vval": [_ep(e) for e in msg.vval],
        }}
    elif isinstance(msg, T.Phase2aMessage):
        req = {"phase2aMessage": {
            "sender": _ep(msg.sender),
            "configurationId": msg.configuration_id,
            "rnd": _rank(msg.rnd),
            "vval": [_ep(e) for e in msg.vval],
        }}
    elif isinstance(msg, T.Phase2bMessage):
        req = {"phase2bMessage": {
            "sender": _ep(msg.sender),
            "configurationId": msg.configuration_id,
            "rnd": _rank(msg.rnd),
            "endpoints": [_ep(e) for e in msg.endpoints],
        }}
    elif isinstance(msg, T.LeaveMessage):
        req = {"leaveMessage": {"sender": _ep(msg.sender)}}
    elif isinstance(msg, T.ClusterStatusRequest):
        req = {"clusterStatusRequest": {
            "sender": _ep(msg.sender), "includeHistory": msg.include_history,
        }}
    elif isinstance(msg, T.HandoffRequest):
        req = {"handoffRequest": {
            "sender": _ep(msg.sender),
            "sessionId": msg.session_id,
            "partition": msg.partition,
            "offset": msg.offset,
            "length": msg.length,
            "mapVersion": msg.map_version,
        }}
    elif isinstance(msg, T.HandoffAck):
        req = {"handoffAck": {
            "sender": _ep(msg.sender),
            "sessionId": msg.session_id,
            "partition": msg.partition,
            "fingerprint": msg.fingerprint,
            "mapVersion": msg.map_version,
        }}
    elif isinstance(msg, T.Get):
        req = {"get": {
            "sender": _ep(msg.sender),
            "key": msg.key,
            "quorum": msg.quorum,
            "mapVersion": msg.map_version,
        }}
    elif isinstance(msg, T.Put):
        req = {"put": {
            "sender": _ep(msg.sender),
            "key": msg.key,
            "value": msg.value,
            "requestId": msg.request_id,
            "replicate": msg.replicate,
            "version": msg.version,
            "mapVersion": msg.map_version,
        }}
    elif isinstance(msg, T.MessageBatch):
        # whole envelopes nested: recursion carries each inner request's own
        # oneof discriminator and trace context unchanged
        req = {"messageBatch": {
            "sender": _ep(msg.sender),
            "requests": [_request(inner) for inner in msg.messages],
        }}
    elif isinstance(msg, T.CellDigestMessage):
        req = {"cellDigestMessage": {
            "sender": _ep(msg.sender),
            "cell": msg.cell,
            "configurationId": msg.configuration_id,
            "membershipSize": msg.membership_size,
            "leader": msg.leader,
            "fingerprint": msg.fingerprint,
            "parentRound": msg.parent_round,
        }}
    elif isinstance(msg, T.GlobalViewMessage):
        req = {"globalViewMessage": {
            "sender": _ep(msg.sender),
            "parentConfigurationId": msg.parent_configuration_id,
            "globalFingerprint": msg.global_fingerprint,
            "cells": msg.cells,
            "epochs": msg.epochs,
            "sizes": msg.sizes,
            "leaders": msg.leaders,
            "fingerprints": msg.fingerprints,
            "parentRound": msg.parent_round,
        }}
    else:
        raise TypeError(f"not a request type: {type(msg).__name__}")
    ctx = trace_context_of(msg)
    if ctx is not None:
        req["traceCtx"] = {"traceId": ctx.trace_id, "parentSpanId": ctx.parent_span_id,
                           "origin": ctx.origin, "flags": ctx.flags}
    stamp = hlc_of(msg)
    if stamp is not None:
        req["hlc"] = {"physicalMs": stamp.physical_ms, "logical": stamp.logical,
                      "incarnation": stamp.incarnation}
    return req


def to_wire_request(msg: T.RapidMessage) -> bytes:
    """A protocol message in the RapidRequest oneof envelope, as bytes."""
    return proto_wire.encode("RapidRequest", _request(msg))


def _request_back(req: Dict[str, Any]) -> T.RapidMessage:
    msg = _request_content_back(req)
    if "traceCtx" in req:
        tc = req["traceCtx"]
        stamp_trace_context(msg, TraceContext(
            trace_id=int(tc.get("traceId", 0)),
            parent_span_id=int(tc.get("parentSpanId", 0)),
            origin=str(tc.get("origin", "")),
            flags=int(tc.get("flags", 0)),
        ))
    if "hlc" in req:
        h = req["hlc"]
        stamp_hlc(msg, HlcStamp(
            physical_ms=int(h.get("physicalMs", 0)),
            logical=int(h.get("logical", 0)),
            incarnation=max(1, int(h.get("incarnation", 0))),
        ))
    return msg


def from_wire_request(data) -> T.RapidMessage:
    """The protocol message of a RapidRequest's bytes, with its trace
    context and HLC stamp."""
    return _request_back(proto_wire.decode("RapidRequest", data))


def _request_content_back(req: Dict[str, Any]) -> T.RapidMessage:
    which = proto_wire.which_oneof("RapidRequest", req)
    m = req.get(which, {})
    sender = _ep_back(m.get("sender", {}))
    if which == "preJoinMessage":
        return T.PreJoinMessage(sender=sender, node_id=_nid_back(m.get("nodeId", {})))
    if which == "joinMessage":
        return T.JoinMessage(
            sender=sender,
            node_id=_nid_back(m.get("nodeId", {})),
            ring_numbers=tuple(m.get("ringNumber", ())),
            configuration_id=int(m.get("configurationId", 0)),
            metadata=_meta_back(m.get("metadata", {})),
        )
    if which == "batchedAlertMessage":
        return T.BatchedAlertMessage(
            sender=sender,
            messages=tuple(_alert_back(a) for a in m.get("messages", ())),
        )
    if which == "probeMessage":
        return T.ProbeMessage(sender=sender)
    if which == "fastRoundPhase2bMessage":
        return T.FastRoundPhase2bMessage(
            sender=sender,
            configuration_id=int(m.get("configurationId", 0)),
            endpoints=tuple(_ep_back(e) for e in m.get("endpoints", ())),
        )
    if which == "phase1aMessage":
        return T.Phase1aMessage(
            sender=sender,
            configuration_id=int(m.get("configurationId", 0)),
            rank=_rank_back(m.get("rank", {})),
        )
    if which == "phase1bMessage":
        return T.Phase1bMessage(
            sender=sender,
            configuration_id=int(m.get("configurationId", 0)),
            rnd=_rank_back(m.get("rnd", {})),
            vrnd=_rank_back(m.get("vrnd", {})),
            vval=tuple(_ep_back(e) for e in m.get("vval", ())),
        )
    if which == "phase2aMessage":
        return T.Phase2aMessage(
            sender=sender,
            configuration_id=int(m.get("configurationId", 0)),
            rnd=_rank_back(m.get("rnd", {})),
            vval=tuple(_ep_back(e) for e in m.get("vval", ())),
        )
    if which == "phase2bMessage":
        return T.Phase2bMessage(
            sender=sender,
            configuration_id=int(m.get("configurationId", 0)),
            rnd=_rank_back(m.get("rnd", {})),
            endpoints=tuple(_ep_back(e) for e in m.get("endpoints", ())),
        )
    if which == "leaveMessage":
        return T.LeaveMessage(sender=sender)
    if which == "clusterStatusRequest":
        return T.ClusterStatusRequest(sender=sender,
                                      include_history=int(m.get("includeHistory", 0)))
    if which == "handoffRequest":
        return T.HandoffRequest(
            sender=sender,
            session_id=int(m.get("sessionId", 0)),
            partition=int(m.get("partition", 0)),
            offset=int(m.get("offset", 0)),
            length=int(m.get("length", 0)),
            map_version=int(m.get("mapVersion", 0)),
        )
    if which == "handoffAck":
        return T.HandoffAck(
            sender=sender,
            session_id=int(m.get("sessionId", 0)),
            partition=int(m.get("partition", 0)),
            fingerprint=int(m.get("fingerprint", 0)),
            map_version=int(m.get("mapVersion", 0)),
        )
    if which == "get":
        return T.Get(
            sender=sender,
            key=bytes(m.get("key", b"")),
            quorum=int(m.get("quorum", 0)),
            map_version=int(m.get("mapVersion", 0)),
        )
    if which == "put":
        return T.Put(
            sender=sender,
            key=bytes(m.get("key", b"")),
            value=bytes(m.get("value", b"")),
            request_id=int(m.get("requestId", 0)),
            replicate=int(m.get("replicate", 0)),
            version=int(m.get("version", 0)),
            map_version=int(m.get("mapVersion", 0)),
        )
    if which == "messageBatch":
        return T.MessageBatch(
            sender=sender,
            messages=tuple(_request_back(r) for r in m.get("requests", ())),
        )
    if which == "cellDigestMessage":
        return T.CellDigestMessage(
            sender=sender,
            cell=int(m.get("cell", 0)),
            configuration_id=int(m.get("configurationId", 0)),
            membership_size=int(m.get("membershipSize", 0)),
            leader=str(m.get("leader", "")),
            fingerprint=int(m.get("fingerprint", 0)),
            parent_round=int(m.get("parentRound", 0)),
        )
    if which == "globalViewMessage":
        return T.GlobalViewMessage(
            sender=sender,
            parent_configuration_id=int(m.get("parentConfigurationId", 0)),
            global_fingerprint=int(m.get("globalFingerprint", 0)),
            cells=tuple(int(c) for c in m.get("cells", ())),
            epochs=tuple(int(e) for e in m.get("epochs", ())),
            sizes=tuple(int(s) for s in m.get("sizes", ())),
            leaders=tuple(str(leader) for leader in m.get("leaders", ())),
            fingerprints=tuple(int(f) for f in m.get("fingerprints", ())),
            parent_round=int(m.get("parentRound", 0)),
        )
    raise ValueError(f"empty RapidRequest envelope: {which}")


def _response(msg) -> Dict[str, Any]:
    if isinstance(msg, T.JoinResponse):
        return {"joinResponse": {
            "sender": _ep(msg.sender),
            "statusCode": int(msg.status_code),
            "configurationId": msg.configuration_id,
            "endpoints": [_ep(e) for e in msg.endpoints],
            "identifiers": [_nid(i) for i in msg.identifiers],
            "metadataKeys": [_ep(endpoint) for endpoint, _ in msg.metadata],
            "metadataValues": [_meta(metadata) for _, metadata in msg.metadata],
        }}
    if isinstance(msg, T.ProbeResponse):
        return {"probeResponse": {"status": int(msg.status)}}
    if isinstance(msg, T.ConsensusResponse):
        return {"consensusResponse": {}}
    if isinstance(msg, T.ClusterStatusResponse):
        s = {"sender": _ep(msg.sender)}
        for wire, attr, _, _ in _STATUS_FIELDS:
            s[wire] = getattr(msg, attr)
        s["consensusDecided"] = int(msg.consensus_decided)
        return {"clusterStatusResponse": s}
    if isinstance(msg, T.PutAck):
        a = {
            "sender": _ep(msg.sender),
            "status": msg.status,
            "key": msg.key,
            "value": msg.value,
            "version": msg.version,
            "requestId": msg.request_id,
            "mapVersion": msg.map_version,
        }
        if msg.leader is not None:
            a["leader"] = _ep(msg.leader)
        return {"putAck": a}
    if isinstance(msg, T.HandoffChunk):
        return {"handoffChunk": {
            "sender": _ep(msg.sender),
            "sessionId": msg.session_id,
            "partition": msg.partition,
            "offset": msg.offset,
            "data": msg.data,
            "totalSize": msg.total_size,
            "fingerprint": msg.fingerprint,
            "status": msg.status,
        }}
    return {"response": {}}  # Response / None -> empty ack


def to_wire_response(msg) -> bytes:
    """A reply in the RapidResponse oneof envelope, as bytes (``Response``
    or None: the empty ack)."""
    return proto_wire.encode("RapidResponse", _response(msg))


def from_wire_response(data):
    """The reply of a RapidResponse's bytes (an empty envelope: ``Response``)."""
    resp = proto_wire.decode("RapidResponse", data)
    which = proto_wire.which_oneof("RapidResponse", resp)
    m = resp.get(which, {})
    if which == "joinResponse":
        return T.JoinResponse(
            sender=_ep_back(m.get("sender", {})),
            status_code=T.JoinStatusCode(m.get("statusCode", 0)),
            configuration_id=int(m.get("configurationId", 0)),
            endpoints=tuple(_ep_back(e) for e in m.get("endpoints", ())),
            identifiers=tuple(_nid_back(i) for i in m.get("identifiers", ())),
            metadata=tuple(
                (_ep_back(k), _meta_back(v))
                for k, v in zip(m.get("metadataKeys", ()), m.get("metadataValues", ()))
            ),
        )
    if which == "probeResponse":
        return T.ProbeResponse(T.NodeStatus(m.get("status", 0)))
    if which == "consensusResponse":
        return T.ConsensusResponse()
    if which == "clusterStatusResponse":
        fields = {"sender": _ep_back(m.get("sender", {}))}
        for wire, attr, repeated, kind in _STATUS_FIELDS:
            cast = str if kind == "string" else int
            fields[attr] = (tuple(cast(v) for v in m.get(wire, ())) if repeated
                            else cast(m.get(wire, 0)))
        fields["consensus_decided"] = bool(fields["consensus_decided"])
        return T.ClusterStatusResponse(**fields)
    if which == "putAck":
        return T.PutAck(
            sender=_ep_back(m.get("sender", {})),
            status=int(m.get("status", 0)),
            key=bytes(m.get("key", b"")),
            value=bytes(m.get("value", b"")),
            version=int(m.get("version", 0)),
            request_id=int(m.get("requestId", 0)),
            leader=_ep_back(m["leader"]) if "leader" in m else None,
            map_version=int(m.get("mapVersion", 0)),
        )
    if which == "handoffChunk":
        return T.HandoffChunk(
            sender=_ep_back(m.get("sender", {})),
            session_id=int(m.get("sessionId", 0)),
            partition=int(m.get("partition", 0)),
            offset=int(m.get("offset", 0)),
            data=bytes(m.get("data", b"")),
            total_size=int(m.get("totalSize", 0)),
            fingerprint=int(m.get("fingerprint", 0)),
            status=int(m.get("status", 0)),
        )
    return T.Response()
