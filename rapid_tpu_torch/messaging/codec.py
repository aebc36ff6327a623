"""Binary wire codec for the framed TCP transport.

The port's own copy of ``rapid_tpu/messaging/codec.py``: the same frames,
byte for byte, so a ``rapid_tpu`` peer and a port peer read each other's
wire. The reference's alternative transport serializes a WrappedRapidRequest
{long reqNo, RapidRequest} with Java object streams over length-prefixed TCP
frames (NettyClientServer.java:283-303). Here the envelope is
``(request_no: u64, type_tag: u8, msgpack payload)`` inside a u32
length-prefixed frame -- compact, language-neutral, and with explicit type
tags playing the role of the reference's protobuf ``oneof`` envelope
(rapid.proto:21-45). The payload is packed by ``msgpack_wire``, the port's
pure-Python MessagePack subset, which gives the C library's bytes; messages
decode into ``rapid_tpu_torch.types``.
"""

from __future__ import annotations

import struct
from collections import OrderedDict
from typing import Any, Dict, Tuple, Type

from ..runtime.lockdep import make_lock
from .. import types as T
from ..forensics.hlc import HlcStamp, hlc_of, stamp_hlc
from ..observability import TraceContext, stamp_trace_context, trace_context_of
from . import msgpack_wire

# Encode memo for LARGE tuples (a 100k-member JoinResponse's endpoint and
# identifier streams): the gateway sends the same configuration content to
# every one of a joiner's K observers and to every joiner of a configuration
# (the bridge reuses the same tuple objects, sim/bridge.py
# _full_config_response), so the Python-level _enc walk -- ~1M dict builds
# per copy at 100k -- runs once per content instead of once per send. Keyed
# by object identity with the tuple held strongly, so a hit is always the
# same (immutable) object; bounded FIFO. Bytes on the wire are unchanged.
_ENC_MEMO_MIN = 4096
_ENC_MEMO_CAP = 8
_enc_memo: "OrderedDict[int, Tuple[tuple, list]]" = OrderedDict()
# concurrent encodes are real (gateway delivery lanes + protocol thread,
# exactly the >=4096-element JoinResponse case the memo targets): guard the
# OrderedDict mutations, or one thread's eviction races another's
# move_to_end into a KeyError and corrupts the dict's internal list
_enc_memo_lock = make_lock("codec._enc_memo_lock")

# Inner-message encode memo (the "__msg" field-value form): bounded LRU of
# whole-message _enc results, hit once per peer after the first walk when a
# broadcaster fans one frozen message object out through batch envelopes or
# gossip relays. Identity-checked like the tuple memo; the strong reference
# in each entry keeps the id() stable for the entry's lifetime.
_MSG_MEMO_CAP = 512
_msg_memo: "OrderedDict[int, Tuple[Any, dict]]" = OrderedDict()
_msg_memo_lock = make_lock("codec._msg_memo_lock")

# Decoded-Endpoint intern table: a cluster talks about the same few hundred
# addresses over and over (every alert, vote, and membership row names
# them), so decoding builds each address once and reuses the frozen
# instance. Plain dict on purpose: reads and writes are GIL-atomic, a lost
# race merely constructs a duplicate, and at the cap the table is cleared
# wholesale -- correctness never depends on a hit.
_EP_INTERN_CAP = 4096
_ep_intern: Dict[Tuple[bytes, int], "T.Endpoint"] = {}

# stable wire tags per message type (appending only; never renumber)
_TYPES: Tuple[Type, ...] = (
    T.PreJoinMessage,  # 0
    T.JoinMessage,  # 1
    T.JoinResponse,  # 2
    T.BatchedAlertMessage,  # 3
    T.AlertMessage,  # 4
    T.ProbeMessage,  # 5
    T.ProbeResponse,  # 6
    T.FastRoundPhase2bMessage,  # 7
    T.Phase1aMessage,  # 8
    T.Phase1bMessage,  # 9
    T.Phase2aMessage,  # 10
    T.Phase2bMessage,  # 11
    T.LeaveMessage,  # 12
    T.Response,  # 13
    T.ConsensusResponse,  # 14
    T.GossipEnvelope,  # 15
    T.FastRoundVoteBatch,  # 16
    T.ClusterStatusRequest,  # 17
    T.ClusterStatusResponse,  # 18
    T.HandoffRequest,  # 19
    T.HandoffChunk,  # 20
    T.HandoffAck,  # 21
    T.Get,  # 22
    T.Put,  # 23
    T.PutAck,  # 24
    T.MessageBatch,  # 25
    T.CellDigestMessage,  # 26
    T.GlobalViewMessage,  # 27
)
_TAG_OF = {cls: tag for tag, cls in enumerate(_TYPES)}

HEADER = struct.Struct("!I")  # frame length
ENVELOPE = struct.Struct("!QB")  # request number, type tag


# values the walks pass through unchanged, tested by exact type first: the
# codec is pure Python here, and a frame holds thousands of them
_PLAIN = frozenset({int, str, bytes, bool, float, type(None)})


def _enc(obj: Any) -> Any:
    t = type(obj)
    if t in _PLAIN:
        return obj
    if t is T.Endpoint or isinstance(obj, T.Endpoint):
        return {"__ep": [obj.hostname, obj.port]}
    if isinstance(obj, T.NodeId):
        return {"__id": [obj.high, obj.low]}
    if isinstance(obj, T.Rank):
        return {"__rk": [obj.round, obj.node_index]}
    if isinstance(obj, (T.EdgeStatus, T.JoinStatusCode, T.NodeStatus)):
        return {"__en": [type(obj).__name__, int(obj)]}
    if isinstance(obj, tuple):
        if len(obj) < _ENC_MEMO_MIN:
            return [x if type(x) in _PLAIN else _enc(x) for x in obj]
        with _enc_memo_lock:
            hit = _enc_memo.get(id(obj))
            if hit is not None and hit[0] is obj:
                _enc_memo.move_to_end(id(obj))
                return hit[1]
        enc = [x if type(x) in _PLAIN else _enc(x) for x in obj]
        with _enc_memo_lock:
            _enc_memo[id(obj)] = (obj, enc)
            while len(_enc_memo) > _ENC_MEMO_CAP:
                _enc_memo.popitem(last=False)
        return enc
    if isinstance(obj, T.AlertMessage):
        # predates the generic "__msg" form; kept for wire stability of
        # BatchedAlertMessage frames across versions
        return {"__al": {k: _enc(v) for k, v in _fields_of(obj).items()}}
    if type(obj) in _TAG_OF:
        # a message carried as a field value (e.g. a GossipEnvelope payload
        # or a MessageBatch inner). A broadcaster fans ONE message object to
        # every peer, and each peer's envelope re-walks it -- with identical
        # output every time, because messages are frozen dataclasses and the
        # inner form never carries trace context. Memoize per object, same
        # identity-checked shape as the tuple memo above.
        with _msg_memo_lock:
            hit = _msg_memo.get(id(obj))
            if hit is not None and hit[0] is obj:
                _msg_memo.move_to_end(id(obj))
                return hit[1]
        enc = {
            "__msg": [
                _TAG_OF[type(obj)],
                {k: _enc(v) for k, v in _fields_of(obj).items()},
            ]
        }
        with _msg_memo_lock:
            _msg_memo[id(obj)] = (obj, enc)
            while len(_msg_memo) > _MSG_MEMO_CAP:
                _msg_memo.popitem(last=False)
        return enc
    if isinstance(obj, dict):
        return {k: _enc(v) for k, v in obj.items()}
    return obj


_ENUMS = {"EdgeStatus": T.EdgeStatus, "JoinStatusCode": T.JoinStatusCode,
          "NodeStatus": T.NodeStatus}


def _dec(obj: Any) -> Any:
    if type(obj) in _PLAIN:
        return obj
    if isinstance(obj, dict):
        if "__ep" in obj:
            host, port = obj["__ep"]
            key = (bytes(host), int(port))
            ep = _ep_intern.get(key)
            if ep is None:
                if len(_ep_intern) >= _EP_INTERN_CAP:
                    _ep_intern.clear()
                ep = T.Endpoint(*key)
                _ep_intern[key] = ep
            return ep
        if "__id" in obj:
            return T.NodeId(*obj["__id"])
        if "__rk" in obj:
            return T.Rank(*obj["__rk"])
        if "__en" in obj:
            name, value = obj["__en"]
            return _ENUMS[name](value)
        if "__al" in obj:
            return T.AlertMessage(**{k: _tupled(_dec(v)) for k, v in obj["__al"].items()})
        if "__msg" in obj:
            tag, fields = obj["__msg"]
            return _TYPES[tag](
                **{k: _tupled(_dec(v)) for k, v in fields.items()}
            )
        return {k: _dec(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [x if type(x) in _PLAIN else _dec(x) for x in obj]
    return obj


def _fields_of(msg: Any) -> Dict[str, Any]:
    return {name: getattr(msg, name) for name in msg.__dataclass_fields__}


def _tupled(value: Any) -> Any:
    """dataclass fields that are tuples on the way in come back as lists."""
    if isinstance(value, list):
        return tuple([_tupled(v) if isinstance(v, list) else v for v in value])
    return value


# Packed-body memo for large messages (the >=64 KB full-configuration
# JoinResponses a swarm bridge streams to every joiner, a decision's vote
# batch sent to every real member): the body depends only on the message
# object, not the request number, and the bridge reuses one response object
# per (configuration, sender) and one packet per decision -- so the packer,
# pure Python here, runs once per object instead of once per send. Same identity-keyed, lock-guarded
# shape as the _enc memo above.
_BODY_MEMO_MIN = 65536
_BODY_MEMO_CAP = 32
_BODY_MEMO_BYTES = 64 * 1024 * 1024  # pinned bodies are MBs at 100k scale
_body_memo: "OrderedDict[int, Tuple[Any, bytes]]" = OrderedDict()
_body_memo_bytes = 0
_body_memo_lock = make_lock("codec._body_memo_lock")


def encode(request_no: int, msg: Any) -> bytes:
    tag = _TAG_OF[type(msg)]
    with _body_memo_lock:
        hit = _body_memo.get(id(msg))
        if hit is not None and hit[0] is msg:
            # a memo hit reuses the body packed at first encode, including
            # whatever trace context was stamped then -- restamping a
            # memoized >=64 KB message later does not change wire bytes
            # (acceptable: only huge JoinResponses reach this path, and
            # their trace context is set before the first send)
            _body_memo.move_to_end(id(msg))
            return ENVELOPE.pack(request_no, tag) + hit[1]
    payload = {k: _enc(v) for k, v in _fields_of(msg).items()}
    ctx = trace_context_of(msg)
    if ctx is not None:
        # reserved key, never a dataclass field name; decoders strip every
        # "__"-prefixed top-level key, so peers that don't know this one
        # (or future reserved keys) parse the frame unchanged
        payload["__tc"] = ctx.to_wire()
    hlc = hlc_of(msg)
    if hlc is not None:
        # same reserved-key discipline as "__tc": absent unless the
        # forensics plane stamped the message, so with the kill switch off
        # the frame is byte-identical to the pre-forensics encoding
        payload["__hlc"] = hlc.to_wire()
    body = msgpack_wire.packb(payload)
    if len(body) >= _BODY_MEMO_MIN:
        global _body_memo_bytes
        with _body_memo_lock:
            # two threads can race to pack the same message: the insert
            # replaces the loser's entry, so its bytes must come off the
            # budget inside the same critical section or the accounting
            # drifts up and evicts live entries early
            prior = _body_memo.get(id(msg))
            if prior is not None:
                _body_memo_bytes -= len(prior[1])
            _body_memo[id(msg)] = (msg, body)
            _body_memo_bytes += len(body)
            # count AND bytes caps: the memo strongly pins message objects
            # and their packed bodies, and at 100k capacity each is several
            # MB -- without a bytes budget, stale configurations' responses
            # would stay resident for the life of the process
            while len(_body_memo) > _BODY_MEMO_CAP or (
                _body_memo_bytes > _BODY_MEMO_BYTES and len(_body_memo) > 1
            ):
                _, (_, old) = _body_memo.popitem(last=False)
                _body_memo_bytes -= len(old)
    return ENVELOPE.pack(request_no, tag) + body


# The wire dialect this codec natively speaks. Rolling upgrades are modeled
# relative to it (faults.py WireVersionRule): a NEWER dialect adds reserved
# "__"-prefixed envelope keys (which every decoder strips) and
# thins optional fields whose value equals the dataclass default (which
# every decoder reconstructs via cls(**kwargs) defaulting); an OLDER dialect
# (< 1) predates the "__tc" trace-context extension and omits it.
WIRE_VERSION = 1


def encode_versioned(request_no: int, msg: Any, version: int) -> bytes:
    """Encode ``msg`` as a peer speaking wire dialect ``version`` would.

    ``version == WIRE_VERSION`` matches :func:`encode` byte-for-byte (minus
    the large-body memo). The bytes differ across versions; the decoded
    message must not -- that invariant is what rolling-upgrade replay pins.
    """
    import dataclasses as _dc

    tag = _TAG_OF[type(msg)]
    fields = _fields_of(msg)
    if version > WIRE_VERSION:
        payload = {}
        defaults = {
            f.name: f.default for f in _dc.fields(msg)
            if f.default is not _dc.MISSING
        }
        for name, value in fields.items():
            # stripped optional tags: a newer encoder omits what the decoder
            # reconstructs (dataclass defaults), shrinking its frames
            if name in defaults and value == defaults[name]:
                continue
            payload[name] = _enc(value)
        # extra reserved fields a current decoder has never seen; the
        # "__"-stripping rule must make them invisible
        payload[f"__v{version}"] = version
        payload[f"__v{version}_ext"] = {"reserved": [version, "future"]}
    else:
        payload = {k: _enc(v) for k, v in fields.items()}
    ctx = trace_context_of(msg)
    if ctx is not None and version >= 1:
        payload["__tc"] = ctx.to_wire()
    hlc = hlc_of(msg)
    if hlc is not None and version >= 1:
        payload["__hlc"] = hlc.to_wire()
    body = msgpack_wire.packb(payload)
    return ENVELOPE.pack(request_no, tag) + body


def wire_roundtrip(msg: Any, version: int) -> Any:
    """``msg`` as a ``version``-speaking peer would put it on the wire and a
    current peer would read it back. Equality with the original (modulo a
    dropped trace context below version 1) is the forward/backward-compat
    contract the rolling-upgrade nemesis replays on live traffic."""
    _, out = decode(encode_versioned(0, msg, version))
    return out


def decode(frame: bytes) -> Tuple[int, Any]:
    request_no, tag = ENVELOPE.unpack_from(frame)
    cls = _TYPES[tag]
    raw = msgpack_wire.unpackb(frame[ENVELOPE.size :])
    # "__"-prefixed top-level keys are envelope extensions (today: "__tc"
    # trace context and "__hlc" hybrid-logical-clock stamps), not dataclass
    # fields -- strip them all so frames from newer peers always construct
    # cleanly
    tc = raw.pop("__tc", None)
    hlc = raw.pop("__hlc", None)
    kwargs = {
        name: _tupled(_dec(value))
        for name, value in raw.items()
        if not name.startswith("__")
    }
    msg = cls(**kwargs)
    if tc is not None:
        stamp_trace_context(msg, TraceContext.from_wire(tc))
    if hlc is not None:
        stamp = HlcStamp.from_wire(hlc)
        if stamp is not None:
            stamp_hlc(msg, stamp)
    return request_no, msg
