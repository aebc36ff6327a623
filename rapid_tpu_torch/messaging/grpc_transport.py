"""gRPC transport speaking the reference's exact wire format.

The port's copy of ``rapid_tpu/messaging/grpc_transport.py``, the analogue
of the default GrpcClient/GrpcServer pair (GrpcClient.java,
GrpcServer.java): one unary RPC ``remoting.MembershipService/sendRequest``
(``wire_schema.GRPC_METHOD_PATH``) carrying the RapidRequest / RapidResponse
``oneof`` envelopes, so a port node is byte-compatible on the wire with JVM
Rapid peers and with the JAX package's grpcio nodes.

- The conversions (``_ep`` ... ``_alert_back``, ``to_wire_request``,
  ``from_wire_request``, ``to_wire_response``, ``from_wire_response``) run
  over ``proto_wire.py`` in place of protobuf's message classes: each builds
  or reads the message as a dict of the schema's field names, and the bytes
  are those protobuf's ``SerializeToString`` gives for the JAX package's
  message (with ``deterministic=True`` where a ``Metadata`` map is present).
  The request envelope carries the trace context (field 15) and the HLC
  stamp (field 18) outside its oneof.
- The transport (``GrpcServer``, ``GrpcClient``) runs over ``http2.py``, the
  port's own HTTP/2, HPACK and gRPC framing, on one shared asyncio loop in
  place of grpc.aio's. The client keeps a connection cache with
  per-message-type deadlines and async retries (GrpcClient.java:87-131,
  194-203); the server answers probes BOOTSTRAPPING until the membership
  service is wired (GrpcServer.java:77-96). A failed call raises
  ``http2.GrpcError``, whose ``code().name`` is grpcio's status name.
- Where a deadline runs out, the port's transport loses no message that
  grpcio would have sent in time: the server hands a whole request to the
  service before any reset behind it, a request whose dial outlasted its
  deadline still leaves, and the client keeps the channel (its loop, not
  the connection, was late). Many members share the one loop, and a
  crash's burst of first messages to new peers outlasted 1 s deadlines on a
  busy host (ROADMAP Queue 3).
"""

from __future__ import annotations

import asyncio
import collections
import functools
import logging
import re
import threading
import time
from typing import Any, Callable, Dict, Optional

from .. import types as T
from ..forensics.hlc import HlcStamp, hlc_of, stamp_hlc
from ..observability import TraceContext, stamp_trace_context, trace_context_of
from ..runtime.futures import Promise
from ..runtime.lockdep import make_lock
from ..settings import Settings
from . import http2, proto_wire
from .base import IMessagingClient, IMessagingServer
from .http2 import GrpcError, StatusCode
from .retries import call_with_retries, wall_scheduler
from .wire_schema import GRPC_METHOD_PATH

LOG = logging.getLogger(__name__)

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


# ---------------------------------------------------------------------------
# transport
# ---------------------------------------------------------------------------


class _SharedAioLoop:
    """One process-wide event loop thread hosting every server and client
    connection.

    The JAX package shares one loop because grpc.aio's completion-queue
    poller is process-global; the port keeps the shape, the faithful
    analogue of the reference's lazy shared Netty event-loop group
    (SharedResources.java:48-67): many servers, one reactor. It is also what
    keeps each connection's frames, and so its HPACK tables, on one thread.
    The daemon thread starts on first use and lives for the process --
    individual servers start/stop on it without tearing it down.
    """

    _lock = make_lock("_SharedAioLoop._lock")
    _loop: Optional[asyncio.AbstractEventLoop] = None
    _thread: Optional[threading.Thread] = None
    _tasks: set = set()  # loop-only: what ``call`` started from the loop's own thread

    @classmethod
    def get(cls) -> asyncio.AbstractEventLoop:
        with cls._lock:
            if cls._loop is None or cls._loop.is_closed():
                loop = asyncio.new_event_loop()

                def run() -> None:
                    asyncio.set_event_loop(loop)
                    loop.run_forever()

                thread = threading.Thread(  # noqa: messaging-thread
                    target=run, name="grpc-aio-shared-loop", daemon=True
                )
                thread.start()
                cls._loop, cls._thread = loop, thread
            return cls._loop

    @classmethod
    def call(cls, coro, timeout: float = 10.0):
        """Run a coroutine on the shared loop and wait for its result; on the
        loop's own thread, start it and return None (waiting would deadlock)."""
        loop = cls.get()
        if threading.current_thread() is cls._thread:
            task = loop.create_task(coro)
            cls._tasks.add(task)
            task.add_done_callback(cls._tasks.discard)
            return None
        return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout)


async def _settle() -> None:
    """Nothing: awaited through ``_SharedAioLoop.call``, it returns once the
    loop has run what was scheduled before it (closes, and the transports'
    closing)."""


class GrpcServer(IMessagingServer):
    """Async-completion server: no thread is ever parked on a pending response.

    The reference's server is futures end-to-end -- the RPC completes whenever
    the service's ListenableFuture does, without holding a worker thread
    (GrpcServer.java:77-96). Join phase-2 responses are parked until the view
    change commits (MembershipService.java:229-286), so a thread-per-response
    server deadlocks at >= pool-size concurrent joiners; here the shared
    event loop awaits each Promise, so thousands of parked joins cost nothing
    but memory.

    ``stats`` counts the frames of every connection it accepted (by type and
    direction, ``"DATA out"``), the window stalls, the calls by status
    (``"status OK"``) and the ms spent encoding responses (``"encode_ms"``),
    all on the loop's thread.
    """

    HANDLER_TIMEOUT_S = 30.0
    SHUTDOWN_GRACE_S = 0.5

    def __init__(self, listen_address: T.Endpoint, max_workers: int = 8) -> None:
        self.address = listen_address
        self._service = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._connections: set = set()  # loop-only
        # retained for API compatibility; the loop has no worker pool
        self._max_workers = max_workers
        self.stats: collections.Counter = collections.Counter()

    def _accept(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        conn = http2.Connection(reader, writer, client=False, on_request=self._on_request,
                                stats=self.stats)
        self._connections.add(conn)
        conn.on_close = self._connections.discard
        conn.start()

    def _on_request(self, conn: http2.Connection, stream: http2.Stream) -> None:
        # The request is whole: it goes to the service here, in its frame's
        # own callback, so that a reset the client sends after it (its
        # deadline passed while this loop was behind) abandons the reply and
        # not the message -- a best-effort alert or vote is not lost for a
        # late answer. Only the wait for the service's promise is a task.
        try:
            outcome = self._dispatch(stream)
        except Exception as e:  # noqa: BLE001 -- answered as the status it maps to
            outcome = e
        stream.task = asyncio.get_running_loop().create_task(self._answer(conn, stream, outcome))

    async def _answer(self, conn: http2.Connection, stream: http2.Stream, outcome) -> None:
        try:
            if isinstance(outcome, BaseException):
                raise outcome
            payload = outcome if isinstance(outcome, bytes) else await self._reply(*outcome)
            code, details = StatusCode.OK, ""
        except GrpcError as e:
            code, details, payload = e.code(), e.details(), None
        except Exception as e:  # noqa: BLE001 -- the handler's own fault: the call still ends
            LOG.exception("gRPC handler failed")
            code, details, payload = StatusCode.UNKNOWN, f"Unexpected {type(e)}: {e}", None
        self.stats[f"status {code.name}"] += 1
        try:
            if payload is None:  # trailers-only
                conn.respond(stream, http2.TRAILERS_ONLY_HEADERS + http2.trailers(code, details))
                return
            conn.send_headers(stream, http2.RESPONSE_HEADERS)
            await conn.send_data(stream, http2.grpc_frame(payload), end_stream=False)
            conn.respond(stream, http2.trailers(StatusCode.OK))
        except GrpcError:
            pass  # the client reset the stream, or the connection is gone

    def _dispatch(self, stream: http2.Stream):
        """The request handed to the service: its reply's bytes where the
        server answers alone, else ``(promise, grpc-timeout in s or None)``."""
        if stream.too_large:
            raise http2.too_large(stream.too_large)
        headers = dict(stream.headers)
        if headers.get(":path") != GRPC_METHOD_PATH:
            raise GrpcError(StatusCode.UNIMPLEMENTED, "Method not found!")
        timeout_s = http2.decode_timeout(headers.get("grpc-timeout"))
        data = http2.parse_message(stream.data, headers.get("grpc-encoding", "identity"))
        try:
            request = from_wire_request(data)
        except Exception:  # noqa: BLE001 -- grpcio's answer to a request it cannot parse
            raise GrpcError(StatusCode.INTERNAL, "Exception deserializing request!") from None
        service = self._service
        if service is None:
            if isinstance(request, T.ProbeMessage):
                return to_wire_response(T.ProbeResponse(T.NodeStatus.BOOTSTRAPPING))
            raise GrpcError(StatusCode.UNAVAILABLE, "membership service not ready")
        try:
            return service.handle_message(request), timeout_s
        except Exception as e:  # noqa: BLE001 -- grpc.aio's answer to a handler that raised
            raise GrpcError(StatusCode.UNKNOWN, f"Unexpected {type(e)}: {e}") from None

    async def _reply(self, promise: Promise, timeout_s: Optional[float]) -> bytes:
        """The service's answer, encoded, once its promise settles."""
        loop = asyncio.get_running_loop()
        done: asyncio.Future = loop.create_future()

        def on_complete(p: Promise) -> None:
            def settle() -> None:
                if done.cancelled():
                    return
                exc = p.exception()
                if exc is not None:
                    done.set_exception(exc)
                else:
                    done.set_result(p._result)  # noqa: SLF001

            loop.call_soon_threadsafe(settle)

        promise.add_callback(on_complete)
        deadline = timeout_s is not None and timeout_s < self.HANDLER_TIMEOUT_S
        try:
            result = await asyncio.wait_for(
                done, timeout=timeout_s if deadline else self.HANDLER_TIMEOUT_S)
        except TimeoutError as e:
            if deadline:
                raise GrpcError(StatusCode.DEADLINE_EXCEEDED, "Deadline Exceeded") from None
            raise GrpcError(StatusCode.INTERNAL, str(e)) from None
        except Exception as e:  # noqa: BLE001
            raise GrpcError(StatusCode.INTERNAL, str(e)) from None
        t0 = time.perf_counter()
        data = to_wire_response(result)
        self.stats["encode_ms"] += (time.perf_counter() - t0) * 1e3
        return data

    def start(self) -> None:
        async def boot() -> asyncio.AbstractServer:
            return await asyncio.start_server(
                self._accept, self.address.hostname.decode(), self.address.port,
                reuse_address=True)

        self._server = _SharedAioLoop.call(boot())

    async def _stop(self, server: asyncio.AbstractServer) -> None:
        """Stop listening and send GOAWAY; calls in flight get
        ``SHUTDOWN_GRACE_S`` to finish before every connection closes."""
        server.close()
        connections = list(self._connections)
        for conn in connections:
            conn.goaway()
        loop = asyncio.get_running_loop()
        deadline = loop.time() + self.SHUTDOWN_GRACE_S
        while loop.time() < deadline and any(not c.closed and not c.idle() for c in connections):
            await asyncio.sleep(0.01)
        for conn in connections:
            conn.close(StatusCode.UNAVAILABLE, "the server shut down")

    def shutdown(self) -> None:
        server = self._server
        if server is None:
            return
        self._server = None
        try:
            _SharedAioLoop.call(self._stop(server))
            _SharedAioLoop.call(_settle())
        except Exception:  # noqa: BLE001 -- loop already gone at interpreter exit
            pass

    def set_membership_service(self, service) -> None:
        self._service = service


def _retrieve(task: asyncio.Task) -> None:
    """A dial's outcome, read so that one no caller waits for any more is
    not reported as never retrieved."""
    if not task.cancelled():
        task.exception()


class _Channel:
    """One remote's HTTP/2 connection, dialed on the first call and again
    once it closed or the peer sent GOAWAY, as a grpcio channel reconnects.
    A request whose deadline runs out before it is written still leaves once
    the connection is up (``_send_late``, counted as ``"late requests"``).
    Its state lives on the shared loop; ``call`` and ``close`` may come from
    any thread."""

    DIAL_TIMEOUT_S = 20.0  # grpcio's minimum connect timeout

    def __init__(self, remote: T.Endpoint, stats: collections.Counter) -> None:
        self._host, self._port = remote.hostname.decode(), remote.port
        self._authority = f"{self._host}:{self._port}"
        self._stats = stats  # guarded-by: aio-loop (every writer runs on the shared loop)
        self._conn: Optional[http2.Connection] = None  # loop-only, and the rest
        self._dial: Optional[asyncio.Task] = None
        self._closed = False
        self._calls: set = set()  # guarded-by: aio-loop (_start and its callbacks)

    def call(self, request: bytes, timeout_s: float,
             on_done: Callable[[Optional[bytes], Optional[BaseException]], None]) -> None:
        """One unary call; ``on_done(response, None)`` or ``on_done(None,
        error)`` runs on the loop's thread."""
        _SharedAioLoop.get().call_soon_threadsafe(self._start, request, timeout_s, on_done)

    def _start(self, request: bytes, timeout_s: float, on_done) -> None:
        task = asyncio.get_running_loop().create_task(self._call(request, timeout_s))
        self._calls.add(task)

        def finished(t: asyncio.Task) -> None:
            self._calls.discard(t)
            if t.cancelled():
                on_done(None, GrpcError(StatusCode.CANCELLED, "the channel was closed"))
            elif t.exception() is not None:
                on_done(None, t.exception())
            else:
                on_done(t.result(), None)

        task.add_done_callback(finished)

    async def _call(self, request: bytes, timeout_s: float) -> bytes:
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout_s
        dial = loop.create_task(self._connection())
        dial.add_done_callback(_retrieve)
        try:
            conn = await asyncio.wait_for(asyncio.shield(dial), timeout_s)
        except TimeoutError:
            # The deadline ran out in the dial, before the request left: it
            # leaves once the dial is done, and no one waits for its reply
            dial.add_done_callback(functools.partial(self._send_late, request, timeout_s))
            raise GrpcError(StatusCode.DEADLINE_EXCEEDED, "Deadline Exceeded") from None
        left = deadline - loop.time()
        if left <= 0:  # the dial ended in time but this task woke past the deadline
            self._send_late(request, timeout_s, dial)
            raise GrpcError(StatusCode.DEADLINE_EXCEEDED, "Deadline Exceeded")
        try:
            # the request is written before the first wait, so it leaves
            # even where the deadline comes first
            return await asyncio.wait_for(self._exchange(conn, request, timeout_s), left)
        except TimeoutError:
            raise GrpcError(StatusCode.DEADLINE_EXCEEDED, "Deadline Exceeded") from None

    def _send_late(self, request: bytes, timeout_s: float, dial: asyncio.Task) -> None:
        """A request whose call ran out of time while this channel dialed,
        sent on the dial's connection: the server takes it as any other and
        its reply is refused (RST_STREAM). A message that is only late is
        not lost: on one loop shared by many members, a burst of first
        messages to new peers queues their dials past the deadline, and a
        crash's alerts and votes were lost that way."""
        if dial.cancelled() or dial.exception() is not None or not dial.result().usable():
            return
        self._stats["late requests"] += 1
        task = asyncio.get_running_loop().create_task(
            self._exchange(dial.result(), request, timeout_s, wait=False))
        self._calls.add(task)
        task.add_done_callback(self._calls.discard)
        task.add_done_callback(_retrieve)

    async def _exchange(self, conn: http2.Connection, request: bytes, timeout_s: float,
                        wait: bool = True) -> bytes:
        stream = conn.open_stream()
        try:
            conn.send_headers(stream, http2.request_headers(GRPC_METHOD_PATH, self._authority,
                                                            timeout_s))
            await conn.send_data(stream, http2.grpc_frame(request), end_stream=True)
            if not wait:
                return b""
            await stream.done
            if stream.error is not None:
                raise stream.error
            code, details = http2.response_status(stream.headers, stream.trailers)
            if code != StatusCode.OK:
                raise GrpcError(code, details)
            return http2.parse_message(stream.data,
                                       dict(stream.headers).get("grpc-encoding", "identity"))
        finally:
            conn.release(stream)

    async def _connection(self) -> http2.Connection:
        conn = self._conn
        if conn is not None and conn.usable():
            return conn
        if self._closed:
            raise GrpcError(StatusCode.CANCELLED, "the channel was closed")
        if self._dial is None:
            self._dial = asyncio.get_running_loop().create_task(self._open())
            self._dial.add_done_callback(_retrieve)
        return await asyncio.shield(self._dial)

    async def _open(self) -> http2.Connection:
        try:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(self._host, self._port), self.DIAL_TIMEOUT_S)
        except OSError as e:  # TimeoutError among them
            raise GrpcError(StatusCode.UNAVAILABLE,
                            f"failed to connect to {self._authority}: {e}") from None
        finally:
            self._dial = None
        conn = http2.Connection(reader, writer, client=True, stats=self._stats)
        conn.start()
        self._stats["connections"] += 1
        if self._closed:
            conn.close(StatusCode.CANCELLED, "the channel was closed")
        self._conn = conn
        return conn

    def close(self) -> None:
        """Close the connection; calls in flight fail as CANCELLED, as
        grpcio's ``Channel.close()`` cancels them."""
        _SharedAioLoop.get().call_soon_threadsafe(self._close)

    def _close(self) -> None:
        self._closed = True
        if self._conn is not None:
            self._conn.close(StatusCode.CANCELLED, "the channel was closed")


class GrpcClient(IMessagingClient):
    """Connection-caching client with the reference's lifecycle rules: the
    cached channel is invalidated on call failure (Retries.java:63-66 ->
    GrpcClient.java:113,131) and evicted after 30s idle (GrpcClient.java:87-95),
    so a peer that restarts on the same address is reached over a fresh
    connection within the retry budget instead of starving behind a dead one.

    A call that ran out of time is the one failure that keeps its channel.
    Its deadline says that the peer, or this process's one loop, is behind,
    not that the connection broke: a broken one ends by itself (EOF, reset,
    GOAWAY) and ``_Channel`` redials, and a dial still under way goes on for
    the next call, as a grpcio channel stays CONNECTING past a call's
    deadline. On grpcio a new channel's dial costs the interpreter nothing;
    here it is work on the loop that is already late, and dialing anew after
    every late reply fed itself until a crash's alerts and votes timed out
    at most members of a 21-member process (``chip_smoke.py --grpc-loop``).

    ``_channels`` holds one multiplexed HTTP/2 connection per remote (a
    ``_Channel``, which redials after a close or GOAWAY). ``stats`` counts
    their frames, stalls and dials, and the ms spent decoding responses
    (``"decode_ms"``), all on the loop's thread.
    """

    IDLE_EVICT_S = 30.0
    # as in the JAX package, where grpc-python's Channel.close() hard-cancels
    # in-flight RPCs: invalidated and idle-evicted channels are *retired* --
    # dropped from the cache so new sends dial fresh -- and only closed once
    # their in-flight calls (parked joins run the longest, <= the server's
    # 30s ceiling) have drained.
    RETIRE_CLOSE_S = 60.0

    def __init__(self, address: T.Endpoint, settings: Optional[Settings] = None) -> None:
        self.address = address
        self._settings = settings if settings is not None else Settings()
        self._channels: Dict[T.Endpoint, _Channel] = {}
        self._last_used: Dict[T.Endpoint, float] = {}
        self._retired: list = []  # [(retired_at, channel)]
        self._lock = make_lock("GrpcClient._lock")
        self.stats: collections.Counter = collections.Counter()

    def _stub(self, remote: T.Endpoint) -> _Channel:
        now = time.monotonic()
        with self._lock:
            self._evict_idle_locked(now)
            channel = self._channels.get(remote)
            if channel is None:
                channel = _Channel(remote, self.stats)
                self._channels[remote] = channel
            self._last_used[remote] = now
            return channel

    def _sweep_retired_locked(self, now: float) -> None:
        while self._retired and now - self._retired[0][0] > self.RETIRE_CLOSE_S:
            _, channel = self._retired.pop(0)
            channel.close()

    def _evict_idle_locked(self, now: float) -> None:
        for ep in [
            ep
            for ep, used in self._last_used.items()
            if now - used > self.IDLE_EVICT_S
        ]:
            channel = self._channels.pop(ep, None)
            self._last_used.pop(ep, None)
            if channel is not None:
                self._retired.append((now, channel))
        self._sweep_retired_locked(now)

    def invalidate(self, remote: T.Endpoint) -> None:
        """Drop the cached channel so the next attempt dials fresh
        (GrpcClient.java:113,131 via Retries.onCallFailure). The channel is
        retired, not closed: closing would cancel unrelated in-flight RPCs
        sharing it (e.g. a parked join, while a probe's failure triggered the
        invalidation)."""
        now = time.monotonic()
        with self._lock:
            channel = self._channels.pop(remote, None)
            self._last_used.pop(remote, None)
            if channel is not None:
                self._retired.append((now, channel))
            # sweep here too: a client that stops dialing new stubs must not
            # hold retired channels' sockets past the drain window
            self._sweep_retired_locked(now)

    def _send_once(self, remote: T.Endpoint, msg: T.RapidMessage) -> Promise:
        out: Promise = Promise()
        try:
            channel = self._stub(remote)
            timeout_s = self._settings.timeout_for(msg) / 1000.0
            request = to_wire_request(msg)
        except Exception as e:  # noqa: BLE001
            self.invalidate(remote)
            out.set_exception(e)
            return out

        def on_done(response: Optional[bytes], error: Optional[BaseException]) -> None:
            if error is None:
                try:
                    t0 = time.perf_counter()
                    reply = from_wire_response(response)
                    self.stats["decode_ms"] += (time.perf_counter() - t0) * 1e3
                    out.try_set_result(reply)
                    return
                except Exception as e:  # noqa: BLE001
                    error = e
            if not (isinstance(error, GrpcError) and error.code() == StatusCode.DEADLINE_EXCEEDED):
                self.invalidate(remote)
            out.try_set_exception(error)

        channel.call(request, timeout_s, on_done)
        return out

    def send_message(self, remote: T.Endpoint, msg: T.RapidMessage) -> Promise:
        if self._settings.retry_base_delay_ms > 0:
            return call_with_retries(
                lambda: self._send_once(remote, msg),
                self._settings.message_retries,
                scheduler=wall_scheduler(),
                policy=self._settings.retry_policy(),
                deadline_ms=self._settings.deadline_for(msg),
            )
        return call_with_retries(
            lambda: self._send_once(remote, msg), self._settings.message_retries
        )

    def send_message_best_effort(self, remote: T.Endpoint, msg: T.RapidMessage) -> Promise:
        return self._send_once(remote, msg)

    def shutdown(self) -> None:
        with self._lock:
            channels = list(self._channels.values()) + [c for _, c in self._retired]
            self._channels.clear()
            self._last_used.clear()
            self._retired.clear()
        for channel in channels:
            channel.close()
        if channels:
            try:
                _SharedAioLoop.call(_settle())
            except Exception:  # noqa: BLE001 -- loop already gone at interpreter exit
                pass
