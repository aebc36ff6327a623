"""The port's proto3 codec of the gRPC wire (``rapid_tpu_torch/messaging/
proto_wire.py``, ``wire_schema.py`` and the conversions in
``grpc_transport.py``) against ``rapid_tpu.messaging.grpc_transport`` on
protobuf.

- The golden frames (``tests/golden/torch_proto_frames.json``, which
  ``rapid_tpu`` and protobuf wrote): JAX still gives every frame, and the
  port gives it too and decodes it back (``chip_smoke.proto_frame_miss``,
  the check the card runs).
- Per frame, across the packages: the port's bytes equal JAX's
  ``to_wire_*(msg).SerializeToString(deterministic=True)``, the port's
  ``from_wire_*`` of JAX's bytes equals JAX's (carried across by class and
  field names, as the msgpack twins do, with the trace context and HLC
  stamp), and JAX parses the port's bytes into the same message.
- A seeded random corpus of every request and response class, with and
  without a trace context and an HLC stamp, held the same way.
- The decoder's edge cases against protobuf's parser: unpacked repeated
  scalars, unknown fields of every wire type (a group too), a truncated
  frame at every length, repeated singular fields, two oneof members, map
  keys twice, a varint field sent length-delimited, and values out of
  range."""

import dataclasses
import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import pytest
from test_torch_wire import _Random

import chip_smoke
import rapid_tpu.types as rtypes
from rapid_tpu.messaging import grpc_transport as jax_gt
from rapid_tpu.messaging.wire_schema import MSG
from rapid_tpu_torch import types as ptypes
from rapid_tpu_torch.messaging import grpc_transport as port_gt
from rapid_tpu_torch.messaging import proto_wire, wire_schema

sys.path.insert(0, str(Path(__file__).parent / "golden"))
import generate_torch_proto_frames as gen  # noqa: E402
import torch_wire_fixtures as fx  # noqa: E402

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py

GOLDEN = json.loads((Path(__file__).parent / "golden" / "torch_proto_frames.json").read_text())
FRAMES = GOLDEN["frames"]
IDS = [f["name"] for f in FRAMES]
JAX, PORT = fx.jax_wire(), fx.port_wire()


def jax_encode(msg, request: bool) -> bytes:
    convert = jax_gt.to_wire_request if request else jax_gt.to_wire_response
    return convert(msg).SerializeToString(deterministic=True)


def jax_decode(data: bytes, request: bool):
    if request:
        return jax_gt.from_wire_request(MSG["RapidRequest"].FromString(data))
    return jax_gt.from_wire_response(MSG["RapidResponse"].FromString(data))


def port_encode(msg, request: bool) -> bytes:
    return (port_gt.to_wire_request if request else port_gt.to_wire_response)(msg)


def port_decode(data: bytes, request: bool):
    return (port_gt.from_wire_request if request else port_gt.from_wire_response)(data)


def contexts(msg, wire):
    """The trace context and HLC stamp a message carries, as plain tuples."""
    tc, hlc = wire.trace_context_of(msg), wire.hlc_of(msg)
    return (None if tc is None else dataclasses.astuple(tc),
            None if hlc is None else dataclasses.astuple(hlc))


def decoding(data: bytes, request: bool, package: str):
    """What one package's ``from_wire_*`` makes of ``data``, in the port's
    classes: the message and its contexts, or the ValueError it raised (a
    request envelope with no member)."""
    try:
        if package == "jax":
            msg = jax_decode(data, request)
            return fx.convert(msg, ptypes), contexts(msg, JAX) if request else None
        msg = port_decode(data, request)
        assert type(msg).__module__ == "rapid_tpu_torch.types"
        return msg, contexts(msg, PORT) if request else None
    except ValueError as exc:
        return "raised", str(exc)


def same_decoding(data: bytes, request: bool) -> None:
    """Both packages decode ``data`` to the same message and contexts."""
    assert decoding(data, request, "port") == decoding(data, request, "jax")


# --------------------------------------------------------------------- #
# the golden frames
# --------------------------------------------------------------------- #


def test_the_file_covers_every_class_with_and_without_contexts():
    by_class = {}
    for f in FRAMES:
        by_class.setdefault(f["message"]["msg"][0], []).append(f)
    assert set(gen.REQUESTS) | set(gen.RESPONSES) <= set(by_class)
    for cls in gen.REQUESTS:
        carried = {(f["trace_context"] is not None, f["hlc"] is not None)
                   for f in by_class[cls] if "error" not in f}
        assert carried == {(False, False), (True, False), (False, True), (True, True)}, cls
    big = next(f for f in FRAMES if f["name"] == chip_smoke.PROTO_BIG)
    assert big["size"] > 4_000_000 and len(fx.value(big["message"], PORT.types).endpoints) \
        == gen.BIG_JOIN
    assert {f["error"] for f in FRAMES if "error" in f} == {"TypeError", "ValueError"}


@pytest.mark.parametrize("frame", FRAMES, ids=IDS)
def test_jax_still_gives_the_frame(frame):
    try:
        data = gen.jax_bytes(frame)
    except (TypeError, ValueError) as exc:
        assert frame.get("error") == type(exc).__name__
        return
    assert gen.record(frame, data) == {k: frame[k] for k in ("hex", "size", "sha256")
                                       if k in frame}


@pytest.mark.parametrize("frame", FRAMES, ids=IDS)
def test_port_gives_the_frame_and_decodes_it_back(frame):
    assert chip_smoke.proto_frame_miss(frame, PORT) is None


@pytest.mark.parametrize("frame", [f for f in FRAMES if "hex" in f],
                         ids=[f["name"] for f in FRAMES if "hex" in f])
def test_each_package_decodes_the_others_bytes(frame):
    request = frame["direction"] == "request"
    data = bytes.fromhex(frame["hex"])
    same_decoding(data, request)
    # JAX parses the port's bytes into the message it parses its own into
    port_bytes = port_encode(fx.message(frame, PORT), request)
    assert fx.convert(jax_decode(port_bytes, request), ptypes) == \
        fx.convert(jax_decode(data, request), ptypes)


# --------------------------------------------------------------------- #
# a random corpus of every class
# --------------------------------------------------------------------- #


class _ProtoRandom(_Random):
    """Random field values within the schema's ranges: ints within int32
    (every int field is int32 or int64), ports within 16 bits, and batches
    of request classes only."""

    def int(self) -> int:
        kind = self.rng.integers(3)
        if kind == 0:
            return int(self.rng.choice([0, 1, -1, 127, 128, (1 << 31) - 1, -(1 << 31)]))
        if kind == 1:
            return int(self.rng.integers(-(1 << 31), 1 << 31))
        return int(self.rng.integers(-1000, 1000))

    def inner(self):
        cls = self.rng.choice(["ProbeMessage", "LeaveMessage", "FastRoundPhase2bMessage",
                               "BatchedAlertMessage", "Put"])
        return self.message(getattr(self.T, str(cls)))


def _random_corpus(seed=16, per_class=10):
    rng = np.random.default_rng(seed)
    make = _ProtoRandom(rng, rtypes)
    out = []
    for name in gen.REQUESTS + gen.RESPONSES:
        for i in range(per_class):
            msg = make.message(getattr(rtypes, name))
            tc = hlc = None
            if name in gen.REQUESTS and i % 2:
                tc = [int(rng.integers(0, 1 << 62)), int(rng.integers(-5, 5)), make.text(),
                      int(rng.integers(0, 3))]
            if name in gen.REQUESTS and i % 4 >= 2:
                hlc = [int(rng.integers(0, 1 << 45)), int(rng.integers(0, 9)),
                       int(rng.integers(0, 4))]
            out.append((name, msg, tc, hlc))
    return out


CORPUS = _random_corpus()


@pytest.mark.parametrize("cls", gen.REQUESTS + gen.RESPONSES)
def test_random_messages_twin(cls):
    for name, msg, tc, hlc in CORPUS:
        if name != cls:
            continue
        request = name in gen.REQUESTS
        port = fx.convert(msg, ptypes)
        for wire, m in ((JAX, msg), (PORT, port)):
            if tc is not None:
                wire.stamp_trace_context(m, wire.TraceContext(*tc))
            if hlc is not None:
                wire.stamp_hlc(m, wire.HlcStamp(*hlc))
        data = jax_encode(msg, request)
        assert port_encode(port, request) == data
        same_decoding(data, request)


# --------------------------------------------------------------------- #
# the decoder's edge cases, against protobuf's parser
# --------------------------------------------------------------------- #


def _key(number, wire):
    return proto_wire._varint(number << 3 | wire)


def _len(body):
    return proto_wire._varint(len(body)) + body


ALERT = rtypes.AlertMessage(rtypes.Endpoint(b"a", 1), rtypes.Endpoint(b"b", 2),
                            rtypes.EdgeStatus.DOWN, -3, (0, -1, 9), rtypes.NodeId(5, -6),
                            (("j", b""), ("k", b"v")))
JOIN = rtypes.JoinMessage(rtypes.Endpoint(b"a", 1), rtypes.NodeId(-1, 2), (4, -5, 6), -7,
                          (("role", b"x"),))


def test_unpacked_repeated_scalars_decode_as_packed():
    # JoinMessage.ringNumber (3) and GlobalViewMessage.cells (4), one record each
    join = (_key(1, 2) + _len(_key(1, 2) + _len(b"h") + _key(2, 0) + b"\x07")
            + b"".join(_key(3, 0) + proto_wire._varint(v & (1 << 64) - 1) for v in (4, -5, 6))
            + _key(4, 0) + b"\x02")
    data = _key(2, 2) + _len(join)
    same_decoding(data, True)
    assert port_decode(data, True).ring_numbers == (4, -5, 6)
    # packed and unpacked records of one field concatenate
    mixed = _key(2, 2) + _len(_key(3, 2) + _len(b"\x01\x02") + _key(3, 0) + b"\x03")
    same_decoding(mixed, True)
    assert port_decode(mixed, True).ring_numbers == (1, 2, 3)


UNKNOWN = (_key(90, 0) + b"\x96\x01" + _key(91, 1) + bytes(8) + _key(92, 2) + _len(b"xyz")
           + _key(93, 5) + bytes(4) + _key(94, 3) + _key(1, 0) + b"\x01" + _key(2, 2) + _len(b"")
           + _key(94, 4))


@pytest.mark.parametrize("where", ["envelope", "message", "nested", "metadata"])
def test_unknown_fields_of_every_wire_type_are_skipped(where):
    data = bytearray(jax_encode(ALERT_BATCH, True))
    msg = MSG["RapidRequest"].FromString(bytes(data))
    if where == "envelope":
        blob = UNKNOWN + bytes(data) + UNKNOWN
    else:
        inner = msg.batchedAlertMessage
        target = {"message": inner, "nested": inner.messages[0].edgeSrc,
                  "metadata": inner.messages[0].metadata}[where]
        target.MergeFromString(UNKNOWN)  # protobuf keeps unknown fields and writes them back
        blob = msg.SerializeToString(deterministic=True)
        assert UNKNOWN in blob
    same_decoding(blob, True)
    assert port_decode(blob, True) == fx.convert(ALERT_BATCH, ptypes)


ALERT_BATCH = rtypes.BatchedAlertMessage(rtypes.Endpoint(b"s", 9), (ALERT,))


@pytest.mark.parametrize("msg,is_request", [(ALERT_BATCH, True), (JOIN, True),
                                         (rtypes.JoinResponse(rtypes.Endpoint(b"z", 1),
                                                              rtypes.JoinStatusCode(2), 9,
                                                              (rtypes.Endpoint(b"y", 2),),
                                                              (rtypes.NodeId(1, 2),),
                                                              ((rtypes.Endpoint(b"y", 2),
                                                                (("é", b"v"),)),)), False)],
                         ids=["BatchedAlertMessage", "JoinMessage", "JoinResponse"])
def test_a_truncated_frame_raises_where_protobuf_refuses_it(msg, is_request):
    request = is_request
    data = jax_encode(msg, request)
    envelope = MSG["RapidRequest" if request else "RapidResponse"]
    refused = 0
    for n in range(len(data)):
        prefix = data[:n]
        try:
            envelope.FromString(prefix)
        except Exception:  # noqa: BLE001 -- protobuf's DecodeError
            refused += 1
            with pytest.raises(ValueError):
                proto_wire.decode(envelope.DESCRIPTOR.name, prefix)
            continue
        same_decoding(prefix, request)
    assert refused > len(data) // 2


@pytest.mark.parametrize("name,blob", [
    # a singular scalar twice: the last wins
    ("scalar_twice", _key(6, 2) + _len(_key(2, 0) + b"\x05" + _key(2, 0) + b"\x09")),
    # a singular message twice: the two merge
    ("message_twice", _key(6, 2) + _len(_key(3, 2) + _len(_key(1, 0) + b"\x02")
                                        + _key(3, 2) + _len(_key(2, 0) + b"\x03"))),
    # two oneof members: the last wins, the first is cleared
    ("two_oneof_members", _key(4, 2) + _len(_key(1, 2) + _len(_key(2, 0) + b"\x01"))
     + _key(10, 2) + _len(_key(1, 2) + _len(_key(2, 0) + b"\x02"))),
    # a map key twice: the last value wins
    ("map_key_twice", _key(2, 2) + _len(_key(5, 2) + _len(
        _key(1, 2) + _len(_key(1, 2) + _len(b"k") + _key(2, 2) + _len(b"1"))
        + _key(1, 2) + _len(_key(1, 2) + _len(b"k") + _key(2, 2) + _len(b"2"))))),
    # a map entry without its key or value: the defaults
    ("map_entry_empty", _key(2, 2) + _len(_key(5, 2) + _len(_key(1, 2) + _len(b"")))),
    # a varint field sent length-delimited: not its wire type, so unknown
    ("varint_field_length_delimited", _key(6, 2) + _len(_key(2, 2) + _len(b"\x05"))),
    # an envelope with a trace context and no member: both refuse it
    ("envelope_without_a_member", _key(15, 2) + _len(_key(3, 2) + _len(b"o"))),
    # an enum value outside its enum: a number on the wire, refused alike
    ("probe_response_status_99", None),
])
def test_decoder_edge_cases_twin(name, blob):
    if blob is None:
        data = _key(4, 2) + _len(_key(1, 0) + b"\x63")
        with pytest.raises(ValueError) as want:
            jax_decode(data, False)
        with pytest.raises(ValueError) as got:
            port_decode(data, False)
        assert str(got.value) == str(want.value)
        return
    same_decoding(blob, True)


@pytest.mark.parametrize("blob", [b"\x08", b"\x80", _key(1, 6) + b"\x00", _key(1, 7),
                                  b"\x00\x00", _key(1, 2) + b"\x05ab", _key(7, 3) + _key(8, 4),
                                  b"\xff" * 11])
def test_malformed_frames_raise_value_error(blob):
    with pytest.raises(Exception):  # noqa: B017 -- protobuf's DecodeError
        MSG["RapidRequest"].FromString(blob)
    with pytest.raises(ValueError):
        proto_wire.decode("RapidRequest", blob)


@pytest.mark.parametrize("msg", [
    rtypes.Phase1aMessage(rtypes.Endpoint(b"a", 1), 0, rtypes.Rank(1 << 31, 0)),
    rtypes.HandoffAck(rtypes.Endpoint(b"a", 1), -(1 << 63) - 1, 0, 0),
    rtypes.ProbeMessage(rtypes.Endpoint(b"a", 1 << 31)),
], ids=["int32_high", "int64_low", "port_int32"])
def test_values_out_of_range_raise_in_both(msg):
    with pytest.raises(ValueError):
        jax_encode(msg, True)
    with pytest.raises(ValueError):
        port_encode(fx.convert(msg, ptypes), True)


def test_map_entries_follow_protobufs_deterministic_order():
    keys = ["b", "a", "ab", "", "ba", "aa", "é", "A", "a\x00", "\x7f", "ü"]
    m = MSG["Metadata"]()
    for k in keys:
        m.metadata[k] = k.encode()
    want = m.SerializeToString(deterministic=True)
    got = proto_wire.encode("Metadata", {"metadata": proto_wire.map_entries(
        (k, k.encode()) for k in keys)})
    assert got == want


def test_the_schema_table_equals_the_jax_packages():
    from rapid_tpu.messaging import wire_schema as jax_schema

    for name in ("_MESSAGES", "_REQUEST_ONEOF", "_RESPONSE_ONEOF", "_ENUMS", "PACKAGE",
                 "SERVICE", "METHOD", "GRPC_METHOD_PATH", "TRACE_CTX_FIELD_NUMBER",
                 "HLC_FIELD_NUMBER"):
        assert getattr(wire_schema, name) == getattr(jax_schema, name), name
    # every message of JAX's descriptor pool, field for field
    for name, fields in proto_wire.SCHEMA.items():
        descriptor = MSG[name.split(".")[0]].DESCRIPTOR
        if "." in name:
            descriptor = descriptor.nested_types_by_name[name.split(".")[1]]
        assert [(f.name, f.number) for f in fields] == sorted(
            ((f.name, f.number) for f in descriptor.fields), key=lambda nf: nf[1]), name
        oneof = {f.name for f in fields if f.oneof}
        assert oneof == {f.name for o in descriptor.oneofs for f in o.fields}, name


def test_the_big_join_response_digest():
    big = next(f for f in FRAMES if f["name"] == chip_smoke.PROTO_BIG)
    data = port_gt.to_wire_response(fx.message(big, PORT))
    assert (len(data), hashlib.sha256(data).hexdigest()) == (big["size"], big["sha256"])


def test_chip_smoke_proto_phase():
    """``chip_smoke.proto_phase``, the step the card runs: every golden
    frame, and the 100k JoinResponse on both codecs."""
    out = chip_smoke.proto_phase("cpu", reps=1, without_protobuf=False)
    assert out["frames"] == len(FRAMES) and out["refused"] == 5
    walls = out["join_response_100k"]
    assert walls["proto3"]["bytes"] == next(
        f["size"] for f in FRAMES if f["name"] == chip_smoke.PROTO_BIG)
    assert walls["msgpack"]["bytes"] > walls["proto3"]["bytes"]
