"""The frames of ``tests/golden/torch_wire_frames.json``, as specs that either
package rebuilds: ``rapid_tpu``'s codec wrote the file
(``generate_torch_wire_frames.py``), and the port's codec
(``rapid_tpu_torch/messaging/codec.py``) must give the same bytes.

Standard library only at import, and nothing of either package: a caller
hands in a ``Wire`` naming its package's types module and codec functions
(``jax_wire()`` and ``port_wire()`` import them when called), so the tests
and ``chip_smoke.py``'s wire phase (on a machine without JAX or msgpack)
rebuild the same messages. ``convert`` carries a message of one package
into the other's classes by class and field names.

A value spec is JSON: ints, strings, ``None``, bools and floats stand for
themselves; ``{"bytes": hex}`` is bytes, ``{"tuple": [...]}`` a tuple,
``{"enum": [name, value]}`` an enum member, ``{"endpoints": [n, port]}`` the
tuple of ``n`` endpoints ``10.<i>.<j>.<k>:port`` (``i, j, k`` the base-256
digits of the index), ``{"ids": [n, seed]}`` ``n`` node ids from a
``random.Random(seed)``, and ``{"msg": [class, {field: spec}]}`` a message.
A frame spec names its request number, message, the trace context and HLC
stamp it carries (or null), how it is encoded (``encode``; ``versioned``
with a wire version; ``routed`` to an endpoint or to ``"*"``, the swarm
broadcast) and the bytes as hex.
"""

from __future__ import annotations

import dataclasses
import enum
import random
from dataclasses import dataclass
from typing import Any, Callable, Dict, List


@dataclass(frozen=True)
class Wire:
    """One package's side of the wire."""

    types: Any  # the types module
    encode: Callable[[int, Any], bytes]
    decode: Callable[[bytes], Any]
    encode_versioned: Callable[[int, Any, int], bytes]
    encode_routed: Callable[[int, Any, Any], bytes]
    decode_routed: Callable[[bytes], Any]
    swarm_broadcast: Any
    TraceContext: type
    stamp_trace_context: Callable[[Any, Any], Any]
    trace_context_of: Callable[[Any], Any]
    HlcStamp: type
    stamp_hlc: Callable[[Any, Any], None]
    hlc_of: Callable[[Any], Any]


def _wire(types, obs, hlc, codec, gateway) -> Wire:
    return Wire(
        types=types, encode=codec.encode, decode=codec.decode,
        encode_versioned=codec.encode_versioned, encode_routed=gateway.encode_routed,
        decode_routed=gateway.decode_routed, swarm_broadcast=gateway.SWARM_BROADCAST,
        TraceContext=obs.TraceContext, stamp_trace_context=obs.stamp_trace_context,
        trace_context_of=obs.trace_context_of, HlcStamp=hlc.HlcStamp,
        stamp_hlc=hlc.stamp_hlc, hlc_of=hlc.hlc_of,
    )


def jax_wire() -> Wire:
    """``rapid_tpu``'s side of the wire (needs msgpack)."""
    from rapid_tpu import observability, types
    from rapid_tpu.forensics import hlc
    from rapid_tpu.messaging import codec, gateway

    return _wire(types, observability, hlc, codec, gateway)


def port_wire() -> Wire:
    """The port's side of the wire."""
    from rapid_tpu_torch import observability, types
    from rapid_tpu_torch.forensics import hlc
    from rapid_tpu_torch.messaging import codec, gateway

    return _wire(types, observability, hlc, codec, gateway)


def convert(obj: Any, T) -> Any:
    """``obj`` rebuilt in the types module ``T``: dataclasses and enums by
    class name (fields by name), tuples, lists and dicts elementwise."""
    if isinstance(obj, enum.Enum):
        return getattr(T, type(obj).__name__)(obj.value)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = getattr(T, type(obj).__name__)
        return cls(**{f.name: convert(getattr(obj, f.name), T)
                      for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple):
        return tuple(convert(v, T) for v in obj)
    if isinstance(obj, list):
        return [convert(v, T) for v in obj]
    if isinstance(obj, dict):
        return {convert(k, T): convert(v, T) for k, v in obj.items()}
    return obj


def endpoints(T, n: int, port: int) -> tuple:
    return tuple(
        T.Endpoint(f"10.{i >> 16 & 255}.{i >> 8 & 255}.{i & 255}".encode(), port)
        for i in range(n)
    )


def node_ids(T, n: int, seed: int) -> tuple:
    rng = random.Random(seed)
    return tuple(
        T.NodeId(rng.getrandbits(64) - (1 << 63), rng.getrandbits(64) - (1 << 63))
        for _ in range(n)
    )


def value(spec: Any, T) -> Any:
    """The value a spec stands for, built from the types module ``T``."""
    if isinstance(spec, list):
        return [value(v, T) for v in spec]
    if not isinstance(spec, dict):
        return spec
    ((kind, arg),) = spec.items()
    if kind == "bytes":
        return bytes.fromhex(arg)
    if kind == "tuple":
        return tuple(value(v, T) for v in arg)
    if kind == "enum":
        return getattr(T, arg[0])(arg[1])
    if kind == "endpoints":
        return endpoints(T, *arg)
    if kind == "ids":
        return node_ids(T, *arg)
    if kind == "msg":
        cls, fields = arg
        return getattr(T, cls)(**{k: value(v, T) for k, v in fields.items()})
    raise ValueError(f"unknown spec {kind!r}")


def message(frame: Dict[str, Any], wire: Wire) -> Any:
    """The frame's message with its trace context and HLC stamp."""
    msg = value(frame["message"], wire.types)
    if frame.get("trace_context") is not None:
        wire.stamp_trace_context(msg, wire.TraceContext(*frame["trace_context"]))
    if frame.get("hlc") is not None:
        wire.stamp_hlc(msg, wire.HlcStamp(*frame["hlc"]))
    return msg


def destination(frame: Dict[str, Any], wire: Wire) -> Any:
    dst = frame["routed"]
    return wire.swarm_broadcast if dst == "*" else value(dst, wire.types)


def frame_bytes(frame: Dict[str, Any], wire: Wire) -> bytes:
    """The bytes ``wire``'s codec gives for the frame's message."""
    return encode_frame(frame, message(frame, wire), wire)


def encode_frame(frame: Dict[str, Any], msg: Any, wire: Wire) -> bytes:
    """``msg`` encoded the way the frame spec says."""
    if frame.get("routed") is not None:
        return wire.encode_routed(frame["request_no"], destination(frame, wire), msg)
    if frame.get("version") is not None:
        return wire.encode_versioned(frame["request_no"], msg, frame["version"])
    return wire.encode(frame["request_no"], msg)


def _ep(host: str, port: int) -> dict:
    return {"msg": ["Endpoint", {"hostname": {"bytes": host.encode().hex()}, "port": port}]}


def _id(high: int, low: int) -> dict:
    return {"msg": ["NodeId", {"high": high, "low": low}]}


def _rank(rnd: int, index: int) -> dict:
    return {"msg": ["Rank", {"round": rnd, "node_index": index}]}


def _tup(*items) -> dict:
    return {"tuple": list(items)}


def _m(cls: str, **fields) -> dict:
    return {"msg": [cls, fields]}


# ints at every msgpack width boundary: fixint, uint8/16/32/64, negative
# fixint, int8/16/32/64, each on both sides of its edge
BOUNDARY_INTS = (
    0, 1, 31, 32, 127, 128, 255, 256, 65535, 65536, (1 << 32) - 1, 1 << 32,
    (1 << 63) - 1, 1 << 63, (1 << 64) - 1,
    -1, -31, -32, -33, -127, -128, -129, -32768, -32769,
    -(1 << 31), -(1 << 31) - 1, -(1 << 63),
)
# string and bin lengths at every format edge (fixstr 31/32, 8-bit 255/256,
# 16-bit 65535/65536)
BOUNDARY_LENGTHS = (0, 1, 31, 32, 255, 256, 65535, 65536)


def corpus() -> List[Dict[str, Any]]:
    """The frame specs, without their bytes. At least one frame per codec
    tag (all 28), the reserved envelope keys, the inner-message forms, the
    routed frames and the large-tuple memo."""
    a, b, c = _ep("127.0.0.1", 7101), _ep("127.0.0.1", 7102), _ep("10.0.3.7", 5000)
    nid = _id(123456789, -987654321)
    alert_down = _m("AlertMessage", edge_src=a, edge_dst=b,
                    edge_status={"enum": ["EdgeStatus", 1]}, configuration_id=7,
                    ring_numbers=_tup(1, 2))
    alert_up = _m("AlertMessage", edge_src=b, edge_dst=a,
                  edge_status={"enum": ["EdgeStatus", 0]}, configuration_id=7,
                  ring_numbers=_tup(0), node_id=nid,
                  metadata=_tup(_tup("role", {"bytes": b"backend".hex()})))
    vote = _m("FastRoundPhase2bMessage", sender=a, configuration_id=-5,
              endpoints=_tup(a, b))
    probe = _m("ProbeMessage", sender=c)
    frames = []

    def add(name, msg, request_no=77, **extra):
        frames.append(dict({"name": name, "request_no": request_no, "message": msg,
                            "trace_context": None, "hlc": None, "routed": None,
                            "version": None}, **extra))

    add("PreJoinMessage", _m("PreJoinMessage", sender=a, node_id=nid), request_no=0)
    add("JoinMessage", _m("JoinMessage", sender=a, node_id=nid, ring_numbers=_tup(0, 3, 9),
                          configuration_id=-5,
                          metadata=_tup(_tup("role", {"bytes": b"backend".hex()}))))
    add("JoinResponse", _m("JoinResponse", sender=b,
                           status_code={"enum": ["JoinStatusCode", 2]}, configuration_id=42,
                           endpoints=_tup(a, b), identifiers=_tup(nid),
                           metadata=_tup(_tup(a, _tup(_tup("k", {"bytes": "76"}))))))
    add("JoinResponse_5000_endpoints", _m(
        "JoinResponse", sender=c, status_code={"enum": ["JoinStatusCode", 2]},
        configuration_id=-4651904502688146028, endpoints={"endpoints": [5000, 5001]},
        identifiers={"ids": [5000, 8]}), request_no=1 << 40)
    add("BatchedAlertMessage", _m("BatchedAlertMessage", sender=a,
                                  messages=_tup(alert_down, alert_up)))
    add("AlertMessage", alert_up)
    add("ProbeMessage", probe, request_no=(1 << 64) - 1)
    add("ProbeResponse", _m("ProbeResponse", status={"enum": ["NodeStatus", 1]}))
    add("ProbeResponse_default", _m("ProbeResponse"))
    add("FastRoundPhase2bMessage", vote)
    add("Phase1aMessage", _m("Phase1aMessage", sender=a, configuration_id=9, rank=_rank(2, -7)))
    add("Phase1bMessage", _m("Phase1bMessage", sender=b, configuration_id=9, rnd=_rank(2, -7),
                             vrnd=_rank(1, 1), vval=_tup(a)))
    add("Phase2aMessage", _m("Phase2aMessage", sender=a, configuration_id=9, rnd=_rank(3, 0),
                             vval=_tup(a, b, c)))
    add("Phase2bMessage", _m("Phase2bMessage", sender=b, configuration_id=9, rnd=_rank(3, 0),
                             endpoints=_tup()))
    add("LeaveMessage", _m("LeaveMessage", sender=c))
    add("Response", _m("Response"))
    add("ConsensusResponse", _m("ConsensusResponse"))
    add("GossipEnvelope", _m("GossipEnvelope", sender=a, gossip_id=_id(-1, 1), ttl=3,
                             payload=vote))
    add("GossipEnvelope_ihave", _m("GossipEnvelope", sender=a, gossip_id=_id(5, -6), ttl=0,
                                   kind=1))
    add("FastRoundVoteBatch", _m("FastRoundVoteBatch", senders={"endpoints": [300, 65535]},
                                 configuration_id=1 << 62, endpoints=_tup(a, c)))
    add("ClusterStatusRequest", _m("ClusterStatusRequest", sender=a, include_history=8))
    add("ClusterStatusResponse_boundaries", _m(
        "ClusterStatusResponse", sender=b, configuration_id=-(1 << 63), membership_size=65536,
        consensus_decided=True, metric_names=_tup(*("m" * n for n in BOUNDARY_LENGTHS)),
        metric_values=_tup(*BOUNDARY_INTS), journal=_tup(*(f"eé{i}" for i in range(16))),
        fd_rtt_micros=_tup(*range(15)), fd_subjects=_tup(*(str(i) for i in range(16))),
        hlc_physical_ms=(1 << 32) - 1, global_leaders=_tup("ü" * 20)))
    add("HandoffRequest", _m("HandoffRequest", sender=a, session_id=-(1 << 40), partition=3,
                             offset=0, length=1 << 20, map_version=17))
    for n in BOUNDARY_LENGTHS:
        add(f"HandoffChunk_{n}_bytes", _m(
            "HandoffChunk", sender=b, session_id=5, partition=3, offset=n,
            data={"bytes": bytes(i % 251 for i in range(n)).hex()}, total_size=n,
            fingerprint=-(1 << 62)))
    add("HandoffAck", _m("HandoffAck", sender=a, session_id=5, partition=3, fingerprint=-9))
    add("Get", _m("Get", sender=a, key={"bytes": b"user:1".hex()}, quorum=2))
    add("Put", _m("Put", sender=a, key={"bytes": b"user:1".hex()},
                  value={"bytes": b"\x00\xff".hex()}, request_id=99, replicate=1,
                  version=(1 << 32) + 1))
    add("PutAck", _m("PutAck", sender=b, status=1, key={"bytes": "6b"}, leader=c,
                     map_version=3))
    add("PutAck_no_leader", _m("PutAck", sender=b, status=0))
    add("MessageBatch", _m("MessageBatch", sender=a, messages=_tup(
        vote, probe, alert_down, _m("BatchedAlertMessage", sender=a, messages=_tup(alert_up)),
        _m("GossipEnvelope", sender=b, gossip_id=_id(1, 2), ttl=1, payload=probe))))
    add("CellDigestMessage", _m("CellDigestMessage", sender=a, cell=2, configuration_id=-11,
                                membership_size=40, leader="127.0.0.1:7101",
                                fingerprint=(1 << 63) - 1, parent_round=4))
    add("GlobalViewMessage", _m("GlobalViewMessage", sender=a, parent_configuration_id=12,
                                global_fingerprint=-12, cells=_tup(0, 1, 2),
                                epochs=_tup(-1, 2, -3), sizes=_tup(10, 20, 30),
                                leaders=_tup("a", "b", "c"), fingerprints=_tup(1, 2, 3),
                                parent_round=9))
    # the reserved envelope keys
    add("ProbeMessage_trace_context", probe, trace_context=[(1 << 63) + 5, 77, "10.0.3.7:5000", 0])
    add("FastRoundPhase2bMessage_hlc", vote, hlc=[1_700_000_000_000, 3, 2])
    add("BatchedAlertMessage_trace_context_and_hlc",
        _m("BatchedAlertMessage", sender=b, messages=_tup(alert_down)),
        trace_context=[11, 12, "", 1], hlc=[42, 0, 1])
    # routed frames (messaging/gateway.py)
    add("routed_PreJoinMessage", _m("PreJoinMessage", sender=a, node_id=_id(-5, 77)),
        request_no=123, routed=_ep("10.1.2.3", 5042))
    add("routed_ProbeMessage", probe, request_no=9, routed=c)
    add("routed_swarm_broadcast_vote", vote, request_no=(1 << 32) + 3, routed="*")
    add("routed_swarm_broadcast_alerts_trace_context",
        _m("BatchedAlertMessage", sender=a, messages=_tup(alert_down, alert_up)),
        routed="*", trace_context=[3, 4, "x", 0])
    # other wire dialects (encode_versioned): a newer peer's reserved keys
    # and thinned defaults, an older one's missing trace context
    add("versioned_2_AlertMessage", alert_up, version=2, trace_context=[7, 8, "n", 0])
    add("versioned_2_ClusterStatusRequest", _m("ClusterStatusRequest", sender=a), version=2)
    add("versioned_0_ProbeMessage_trace_context", probe, version=0,
        trace_context=[7, 8, "n", 0])
    return frames
