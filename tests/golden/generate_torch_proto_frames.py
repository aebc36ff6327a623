"""Generate tests/golden/torch_proto_frames.json -- the gRPC wire's bytes that
``rapid_tpu.messaging.grpc_transport`` gives for the frames of ``corpus()``
(``to_wire_request`` / ``to_wire_response``, then protobuf's
``SerializeToString(deterministic=True)``), which the port's conversions
(``rapid_tpu_torch/messaging/grpc_transport.py`` on its own proto3 codec)
must reproduce byte for byte.

Run from the repo root, where protobuf is installed:
    python tests/golden/generate_torch_proto_frames.py

The committed JSON is the contract: ``tests/test_torch_proto_wire.py`` checks
that ``rapid_tpu`` still gives every frame, so the file cannot drift, and
``chip_smoke.py`` holds the port to it on a machine without protobuf. A
frame of more than ``INLINE_BYTES`` is kept as its size and SHA-256; one the
JAX conversion refuses keeps the exception's class (``error``). Regenerate
only after a deliberate wire change.
"""

import hashlib
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import torch_wire_fixtures as fx  # noqa: E402

INLINE_BYTES = 1 << 16
BIG_JOIN = 100_000  # the 100k JoinResponse: the bench headline's members

# the classes the conversions handle: to_wire_request takes these, and
# to_wire_response every other class (Response and the rest: the empty ack)
REQUESTS = ("PreJoinMessage", "JoinMessage", "BatchedAlertMessage", "ProbeMessage",
            "FastRoundPhase2bMessage", "Phase1aMessage", "Phase1bMessage", "Phase2aMessage",
            "Phase2bMessage", "LeaveMessage", "ClusterStatusRequest", "HandoffRequest",
            "HandoffAck", "Get", "Put", "MessageBatch", "CellDigestMessage",
            "GlobalViewMessage")
RESPONSES = ("JoinResponse", "ProbeResponse", "ConsensusResponse", "ClusterStatusResponse",
             "PutAck", "HandoffChunk", "Response")


def direction(frame) -> str:
    return "request" if frame["message"]["msg"][0] in REQUESTS else "response"


def corpus():
    """The frame specs, without their bytes: the msgpack golden corpus's
    plain frames, then what the proto3 wire adds -- every request with a
    trace context, an HLC stamp and both; a map's entry order and defaults;
    negative and boundary varints; empty sub-messages; every status field;
    and the 100k JoinResponse."""
    frames = [dict(f) for f in fx.corpus() if f["routed"] is None and f["version"] is None]
    a, b = fx._ep("127.0.0.1", 7101), fx._ep("10.0.3.7", 5000)
    nid = fx._id(-1, (1 << 63) - 1)
    meta = fx._tup(*(fx._tup(k, {"bytes": v.hex()}) for k, v in (
        ("b", b"1"), ("a", b""), ("ab", b"2"), ("", b"3"), ("ba", b"4"), ("A", b"5"),
        ("é", b"6"), ("a", b"dup"))))
    alert = fx._m("AlertMessage", edge_src=a, edge_dst=b,
                  edge_status={"enum": ["EdgeStatus", 1]}, configuration_id=-(1 << 63),
                  ring_numbers=fx._tup(0, -1, (1 << 31) - 1, -(1 << 31)), node_id=nid,
                  metadata=meta)
    probe = fx._m("ProbeMessage", sender=b)

    def add(name, msg, trace_context=None, hlc=None):
        frames.append({"name": name, "request_no": 0, "message": msg,
                       "trace_context": trace_context, "hlc": hlc, "routed": None,
                       "version": None})

    examples = {
        "PreJoinMessage": fx._m("PreJoinMessage", sender=a, node_id=nid),
        "JoinMessage": fx._m("JoinMessage", sender=a, node_id=nid, ring_numbers=fx._tup(-5, 9),
                             configuration_id=1, metadata=meta),
        "BatchedAlertMessage": fx._m("BatchedAlertMessage", sender=a, messages=fx._tup(alert)),
        "ProbeMessage": probe,
        "FastRoundPhase2bMessage": fx._m("FastRoundPhase2bMessage", sender=a,
                                         configuration_id=-1, endpoints=fx._tup(a, b)),
        "Phase1aMessage": fx._m("Phase1aMessage", sender=a, configuration_id=0,
                                rank=fx._rank(0, 0)),
        "Phase1bMessage": fx._m("Phase1bMessage", sender=b, configuration_id=3,
                                rnd=fx._rank(-1, 0), vrnd=fx._rank(0, 0), vval=fx._tup()),
        "Phase2aMessage": fx._m("Phase2aMessage", sender=a, configuration_id=3,
                                rnd=fx._rank(1, -(1 << 31)), vval=fx._tup(b)),
        "Phase2bMessage": fx._m("Phase2bMessage", sender=b, configuration_id=3,
                                rnd=fx._rank((1 << 31) - 1, 2), endpoints=fx._tup(a)),
        "LeaveMessage": fx._m("LeaveMessage", sender=a),
        "ClusterStatusRequest": fx._m("ClusterStatusRequest", sender=a, include_history=-3),
        "HandoffRequest": fx._m("HandoffRequest", sender=a, session_id=1, partition=-2,
                                offset=3, length=0, map_version=(1 << 63) - 1),
        "HandoffAck": fx._m("HandoffAck", sender=b, session_id=-1, partition=0,
                            fingerprint=1 << 40, map_version=2),
        "Get": fx._m("Get", sender=a, key={"bytes": ""}, quorum=0, map_version=-1),
        "Put": fx._m("Put", sender=a, key={"bytes": "00"}, value={"bytes": ""},
                     request_id=-7, replicate=0, version=0, map_version=5),
        "MessageBatch": fx._m("MessageBatch", sender=a, messages=fx._tup(
            probe, fx._m("BatchedAlertMessage", sender=b, messages=fx._tup(alert)),
            fx._m("LeaveMessage", sender=b))),
        "CellDigestMessage": fx._m("CellDigestMessage", sender=a, cell=0, configuration_id=0,
                                   membership_size=0, leader="", fingerprint=0,
                                   parent_round=0),
        "GlobalViewMessage": fx._m("GlobalViewMessage", sender=b, parent_configuration_id=-1,
                                   global_fingerprint=1, cells=fx._tup(), epochs=fx._tup(0),
                                   sizes=fx._tup(0, 0), leaders=fx._tup("", "é"),
                                   fingerprints=fx._tup(-(1 << 63)), parent_round=1),
    }
    contexts = {"trace_context": [(1 << 63) - 1, 12, "10.0.3.7:5000", 1],
                "hlc": [1_700_000_000_000, 7, 0]}
    for name, msg in examples.items():
        add(f"{name}_proto", msg)
        add(f"{name}_trace_context", msg, trace_context=contexts["trace_context"])
        add(f"{name}_hlc", msg, hlc=contexts["hlc"])
        add(f"{name}_trace_context_and_hlc", msg, **contexts)
    add("MessageBatch_inner_contexts", fx._m("MessageBatch", sender=a, messages=fx._tup(probe)),
        trace_context=[0, 0, "", 0], hlc=[0, 0, 5])
    add("JoinResponse_metadata", fx._m(
        "JoinResponse", sender=b, status_code={"enum": ["JoinStatusCode", 0]},
        configuration_id=-9, endpoints=fx._tup(a, b), identifiers=fx._tup(nid, fx._id(0, 0)),
        metadata=fx._tup(fx._tup(a, meta), fx._tup(b, fx._tup()))))
    add("ProbeResponse_bootstrapping", fx._m("ProbeResponse",
                                             status={"enum": ["NodeStatus", 1]}))
    add("PutAck_leader", fx._m("PutAck", sender=a, status=-1, key={"bytes": "6b"},
                               value={"bytes": "76"}, version=-2, request_id=3, leader=b,
                               map_version=0))
    add("HandoffChunk_defaults", fx._m("HandoffChunk", sender=a, session_id=0, partition=0,
                                       offset=0))
    add("ClusterStatusResponse_defaults", fx._m("ClusterStatusResponse", sender=a,
                                                configuration_id=0, membership_size=0))
    add("ClusterStatusResponse_every_field", fx._m(
        "ClusterStatusResponse", sender=b, configuration_id=-6148914691236517206,
        membership_size=3, reports_tracked=4, pre_proposal_size=1, proposal_size=2,
        updates_in_progress=1, consensus_decided=True, consensus_votes=2,
        metric_names=fx._tup("rounds", "msg.queue_depth{peer=10.0.0.2:7}"),
        metric_values=fx._tup(5, -(1 << 63)), journal=fx._tup('{"kind": "x"}', "é"),
        placement_version=3, placement_partitions=32, placement_owned=11, handoff_in_flight=1,
        handoff_completed=4, handoff_failed=-1, handoff_partitions=fx._tup(0, 1),
        handoff_fingerprints=fx._tup(10, -20), serving_gets=3, serving_puts=2,
        serving_put_acks=4, serving_partitions=fx._tup(0, 1),
        serving_leaders=fx._tup("h:1", ""), fd_subjects=fx._tup("h:2"),
        fd_rtt_micros=fx._tup(1500), fd_suspicion_milli=fx._tup(2500),
        fd_tiers=fx._tup("local", "remote"), fd_tier_interval_ms=fx._tup(100, 1000),
        fd_tier_threshold=fx._tup(3, 5), fd_tier_flush_ms=fx._tup(5, 50),
        history=fx._tup('{"seq": 1}'), durability_segments=2, durability_snapshot_version=9,
        durability_replayed=17, slo_names=fx._tup("serving.latency:fast"),
        slo_burn_milli=fx._tup(42_100), slo_firing=fx._tup(1), slo_attributed_trace=fx._tup(7),
        journal_dropped=2, journal_capacity=512, hlc_physical_ms=1 << 41, hlc_logical=3,
        hlc_incarnation=2, cell_id=1, cell_size=2, parent_configuration_id=777,
        global_fingerprint=-4242, global_cells=fx._tup(0, 1), global_epochs=fx._tup(10, 11),
        global_sizes=fx._tup(2, 2), global_leaders=fx._tup("h:1", "h:3")))
    # out of range for the schema: int32 and int64 both refuse
    add("Phase1aMessage_int32_out_of_range", fx._m(
        "Phase1aMessage", sender=a, configuration_id=0, rank=fx._rank(1 << 31, 0)))
    add("HandoffAck_int64_out_of_range", fx._m(
        "HandoffAck", sender=a, session_id=1 << 63, partition=0, fingerprint=0))
    add(f"JoinResponse_{BIG_JOIN}_endpoints", fx._m(
        "JoinResponse", sender=b, status_code={"enum": ["JoinStatusCode", 2]},
        configuration_id=-4651904502688146028, endpoints={"endpoints": [BIG_JOIN, 5001]},
        identifiers={"ids": [BIG_JOIN, 8]}))
    return frames


def jax_bytes(frame) -> bytes:
    """``rapid_tpu``'s bytes for the frame (needs protobuf)."""
    from rapid_tpu.messaging import grpc_transport

    msg = fx.message(frame, fx.jax_wire())
    convert = (grpc_transport.to_wire_request if direction(frame) == "request"
               else grpc_transport.to_wire_response)
    return convert(msg).SerializeToString(deterministic=True)


def record(frame, data: bytes) -> dict:
    """What the file keeps of a frame's bytes."""
    if len(data) > INLINE_BYTES:
        return {"size": len(data), "sha256": hashlib.sha256(data).hexdigest()}
    return {"hex": data.hex()}


def main() -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    frames = []
    for frame in corpus():
        out = dict(frame, direction=direction(frame))
        try:
            out.update(record(frame, jax_bytes(frame)))
        except (TypeError, ValueError) as exc:
            out["error"] = type(exc).__name__
        frames.append(out)
    doc = {
        "_provenance": (
            "generated by tests/golden/generate_torch_proto_frames.py with "
            "rapid_tpu.messaging.grpc_transport and protobuf's "
            "SerializeToString(deterministic=True); the port's grpc_transport must give "
            "every frame byte for byte"
        ),
        "frames": frames,
    }
    with open(os.path.join(HERE, "torch_proto_frames.json"), "w") as f:
        json.dump(doc, f, indent=0, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
