"""The port's MessagePack subset and wire codec against the JAX package's.

``rapid_tpu_torch/messaging/msgpack_wire.py`` is held against the C
library (``msgpack.packb(..., use_bin_type=True)`` bytes,
``msgpack.unpackb(..., raw=False)`` values) under hypothesis and at every
width boundary, with its type, overflow and truncation errors. Then
``rapid_tpu_torch/messaging/codec.py`` against ``rapid_tpu.messaging.codec``
on a corpus of every message class with random fields, built from one numpy
seed in both packages' classes (``torch_wire_fixtures.convert`` carries a
``rapid_tpu`` message into the port's by field names): ``encode``,
``encode_versioned`` (older and newer dialects), ``decode`` and
``wire_roundtrip`` agree byte for byte and value for value, the reserved
``__tc``/``__hlc`` keys are stripped into the sidecars, and a newer peer's
unknown ``__`` keys are ignored. The port's codec must run on its own
packer, never the C library."""

import dataclasses
import math
import re
import sys
from pathlib import Path

import msgpack
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import rapid_tpu.types as rtypes
from rapid_tpu.messaging import codec as jax_codec
from rapid_tpu_torch import types as ptypes
from rapid_tpu_torch.messaging import codec as port_codec
from rapid_tpu_torch.messaging import msgpack_wire as W

sys.path.insert(0, str(Path(__file__).parent / "golden"))

import torch_wire_fixtures as fx  # noqa: E402

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py

JAX, PORT = fx.jax_wire(), fx.port_wire()

# --------------------------------------------------------------------------- #
# msgpack_wire against the C library
# --------------------------------------------------------------------------- #

INTS = st.integers(min_value=-(1 << 63), max_value=(1 << 64) - 1)
SCALARS = (st.none() | st.booleans() | INTS
           | st.floats(allow_nan=False) | st.text() | st.binary())
VALUES = st.recursive(
    SCALARS,
    lambda inner: (st.lists(inner, max_size=20) | st.tuples(inner, inner)
                   | st.dictionaries(st.text(max_size=8), inner, max_size=20)),
    max_leaves=60,
)


def _library(value):
    return msgpack.packb(value, use_bin_type=True)


@settings(max_examples=400, deadline=None)
@given(VALUES)
def test_packb_and_unpackb_equal_the_library(value):
    data = _library(value)
    assert W.packb(value) == data
    assert W.unpackb(data) == msgpack.unpackb(data, raw=False)
    assert W.unpackb(memoryview(data)) == msgpack.unpackb(data, raw=False)


@settings(max_examples=200, deadline=None)
@given(st.lists(st.fixed_dictionaries({"__ep": st.tuples(st.binary(max_size=300), INTS)
                                       .map(list)}), max_size=40)
       | st.lists(st.fixed_dictionaries({"__id": st.tuples(INTS, INTS).map(list)}), max_size=40)
       | st.lists(st.fixed_dictionaries({"__rk": st.tuples(INTS, st.text(max_size=3))
                                         .map(list)}), max_size=10))
def test_the_pair_fast_paths_equal_the_library(value):
    data = _library(value)
    assert W.packb(value) == data
    assert W.unpackb(data) == msgpack.unpackb(data, raw=False)


@settings(max_examples=100, deadline=None)
@given(st.floats(allow_nan=True))
def test_floats_pack_as_float64(value):
    data = _library(value)
    assert W.packb(value) == data and data[0] == 0xCB
    back = W.unpackb(data)
    assert (math.isnan(back) and math.isnan(value)) or back == value


BOUNDARIES = [0, 1, 31, 32, 127, 128, 255, 256, 65535, 65536, (1 << 32) - 1, 1 << 32,
              (1 << 63) - 1, 1 << 63, (1 << 64) - 1, -1, -31, -32, -33, -127, -128, -129,
              -32768, -32769, -(1 << 31), -(1 << 31) - 1, -(1 << 63)]
LENGTHS = [0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536]


@pytest.mark.parametrize("value", BOUNDARIES)
def test_int_boundaries(value):
    assert W.packb(value) == _library(value)
    assert W.unpackb(_library(value)) == value


@pytest.mark.parametrize("n", LENGTHS)
def test_length_boundaries(n):
    for value in ("a" * n, "é" * (n // 2), b"\x01" * n, bytearray(n), memoryview(b"\x02" * n),
                  list(range(n)), tuple(range(n)), {str(i): i for i in range(n)}):
        data = _library(value)
        assert W.packb(value) == data, (type(value), n)
        assert W.unpackb(data) == msgpack.unpackb(data, raw=False)


def test_bool_before_int_and_subclasses_as_their_base():
    import enum

    class Flag(enum.IntEnum):
        A = 300

    class Text(str):
        pass

    value = [True, False, 1, 0, Flag.A, Text("x"), {Text("k"): b""}]
    assert W.packb(value) == _library(value)
    assert W.packb(True) == b"\xc3" and W.packb(1) == b"\x01"


@pytest.mark.parametrize("value", [set(), frozenset(), object(), 1j, np.int64(3), np.float32(1),
                                   [1, {2}], {"k": object()}])
def test_types_outside_the_subset_raise_type_error(value):
    with pytest.raises(TypeError):
        _library(value)
    with pytest.raises(TypeError):
        W.packb(value)


@pytest.mark.parametrize("value", [1 << 64, -(1 << 63) - 1])
def test_ints_out_of_range_overflow(value):
    with pytest.raises(OverflowError):
        W.packb(value)


def test_truncated_input_raises_value_error():
    data = _library({"a": [1, 2.5, "xyz", b"\x00" * 300, {"__ep": [b"10.0.0.1", 5000]},
                           -(1 << 40), None, True]})
    for cut in range(len(data)):
        with pytest.raises(ValueError):
            W.unpackb(data[:cut])


@pytest.mark.parametrize("data", [
    b"\x01\x02",  # extra data
    b"\xc1",  # never used
    b"\xd4\x01\x02",  # fixext: outside the subset
    b"\xc7\x01\x05\x00",  # ext8
    b"\xa2\xff\xfe",  # bad UTF-8 (raw=False raises)
    b"\x81\x01\x02",  # a map key that is neither str nor bytes
    b"",
])
def test_invalid_input_raises_value_error(data):
    with pytest.raises(ValueError):
        msgpack.unpackb(data, raw=False, ext_hook=lambda *_: (_ for _ in ()).throw(ValueError()))
    with pytest.raises(ValueError):
        W.unpackb(data)


_FORBIDDEN_IMPORT = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|msgpack|google\.protobuf|google|grpc|rapid_tpu)"
    r"\b(?!_torch)")


def test_the_port_imports_no_jax_msgpack_protobuf_or_rapid_tpu():
    """The import lines of ``rapid_tpu_torch/`` and ``chip_smoke.py`` name no
    JAX, msgpack, protobuf, grpc or ``rapid_tpu`` module (``rapid_tpu_torch``
    aside): the codec's packer is ``msgpack_wire``, the gRPC transport's
    HTTP/2 is ``http2``."""
    root = Path(__file__).resolve().parents[1]
    paths = sorted((root / "rapid_tpu_torch").rglob("*.py")) + [root / "chip_smoke.py"]
    bad = [(str(path.relative_to(root)), line) for path in paths
           for line in path.read_text().splitlines() if _FORBIDDEN_IMPORT.match(line)]
    assert not bad, bad
    assert port_codec.msgpack_wire is W
    assert "msgpack" not in vars(port_codec)


# --------------------------------------------------------------------------- #
# the codec against rapid_tpu's, on a random corpus
# --------------------------------------------------------------------------- #


class _Random:
    """Random field values for a message class, by field annotation."""

    def __init__(self, rng: np.random.Generator, T) -> None:
        self.rng, self.T = rng, T

    def int(self) -> int:
        kind = self.rng.integers(4)
        if kind == 0:
            return int(self.rng.choice(BOUNDARIES[:13] + BOUNDARIES[15:]))
        if kind == 1:
            return int(self.rng.integers(-(1 << 62), 1 << 62))
        return int(self.rng.integers(-1000, 1000))

    def text(self) -> str:
        return "".join(self.rng.choice(list("abcé€😀 :"), size=int(self.rng.integers(0, 40))))

    def blob(self) -> bytes:
        return self.rng.bytes(int(self.rng.choice([0, 3, 40, 300])))

    def endpoint(self):
        host = f"10.{self.rng.integers(256)}.{self.rng.integers(256)}.{self.rng.integers(256)}"
        return self.T.Endpoint(host.encode(), int(self.rng.integers(0, 65536)))

    def node_id(self):
        return self.T.NodeId(int(self.rng.integers(-(1 << 63), 1 << 63, dtype=np.int64)),
                             int(self.rng.integers(-(1 << 63), 1 << 63, dtype=np.int64)))

    def many(self, make, most=6) -> tuple:
        return tuple(make() for _ in range(int(self.rng.integers(0, most))))

    def metadata(self) -> tuple:
        return tuple(sorted({self.text(): self.blob() for _ in range(self.rng.integers(3))}.items()))

    def inner(self):
        cls = self.rng.choice(["ProbeMessage", "LeaveMessage", "AlertMessage",
                               "FastRoundPhase2bMessage", "Response"])
        return self.message(getattr(self.T, str(cls)))

    def field(self, annotation: str):
        a = annotation.replace("'", "")
        simple = {
            "Endpoint": self.endpoint, "NodeId": self.node_id, "int": self.int,
            "bool": lambda: bool(self.rng.integers(2)), "bytes": self.blob, "str": self.text,
            "Rank": lambda: self.T.Rank(self.int(), self.int()),
            "EdgeStatus": lambda: self.T.EdgeStatus(int(self.rng.integers(2))),
            "JoinStatusCode": lambda: self.T.JoinStatusCode(int(self.rng.integers(5))),
            "NodeStatus": lambda: self.T.NodeStatus(int(self.rng.integers(2))),
            "Optional[Endpoint]": lambda: self.endpoint() if self.rng.integers(2) else None,
            "Optional[NodeId]": lambda: self.node_id() if self.rng.integers(2) else None,
            "Tuple[Endpoint, ...]": lambda: self.many(self.endpoint, 30),
            "Tuple[NodeId, ...]": lambda: self.many(self.node_id, 30),
            "Tuple[int, ...]": lambda: self.many(self.int, 20),
            "Tuple[str, ...]": lambda: self.many(self.text),
            "Tuple[Tuple[str, bytes], ...]": self.metadata,
            "Tuple[Tuple[Endpoint, Tuple[Tuple[str, bytes], ...]], ...]":
                lambda: self.many(lambda: (self.endpoint(), self.metadata()), 4),
            "Tuple[AlertMessage, ...]":
                lambda: self.many(lambda: self.message(self.T.AlertMessage), 4),
            "Tuple[object, ...]": lambda: self.many(self.inner, 4),
            "object": lambda: self.inner() if self.rng.integers(2) else None,
        }
        return simple[a]()

    def message(self, cls):
        return cls(**{f.name: self.field(str(f.type)) for f in dataclasses.fields(cls)})


def _corpus(seed: int = 2024, per_class: int = 12):
    rng = np.random.default_rng(seed)
    make = _Random(rng, rtypes)
    return [make.message(cls) for cls in jax_codec._TYPES for _ in range(per_class)]  # noqa: SLF001


CORPUS = _corpus()


def test_the_corpus_covers_every_class_and_converts_by_field_names():
    assert {type(m) for m in CORPUS} == set(jax_codec._TYPES)  # noqa: SLF001
    for msg in CORPUS:
        port = fx.convert(msg, ptypes)
        assert type(port).__module__ == "rapid_tpu_torch.types"
        assert type(port).__name__ == type(msg).__name__
        assert fx.convert(port, rtypes) == msg


@pytest.mark.parametrize("cls", jax_codec._TYPES, ids=lambda c: c.__name__)  # noqa: SLF001
def test_encode_decode_and_dialects_equal_rapid_tpu(cls):
    for i, msg in enumerate(m for m in CORPUS if type(m) is cls):
        port = fx.convert(msg, ptypes)
        request_no = (i * 7919) % (1 << 64)
        frame = jax_codec.encode(request_no, msg)
        assert port_codec.encode(request_no, port) == frame
        got_no, got = port_codec.decode(frame)
        assert got_no == request_no and got == port
        assert fx.convert(jax_codec.decode(port_codec.encode(request_no, port))[1], ptypes) == port
        for version in (0, 1, 2, 3):
            assert (port_codec.encode_versioned(request_no, port, version)
                    == jax_codec.encode_versioned(request_no, msg, version))
            assert port_codec.wire_roundtrip(port, version) == port
            assert (fx.convert(jax_codec.wire_roundtrip(msg, version), ptypes)
                    == port_codec.wire_roundtrip(port, version))


def test_reserved_keys_are_stripped_into_the_sidecars():
    msg = ptypes.FastRoundPhase2bMessage(
        ptypes.Endpoint(b"10.0.0.1", 1), 5, (ptypes.Endpoint(b"10.0.0.2", 2),))
    PORT.stamp_trace_context(msg, PORT.TraceContext(1 << 63, 9, "origin", 0))
    PORT.stamp_hlc(msg, PORT.HlcStamp(1_700_000_000_000, 4, 2))
    jax_msg = fx.convert(msg, rtypes)
    JAX.stamp_trace_context(jax_msg, JAX.TraceContext(1 << 63, 9, "origin", 0))
    JAX.stamp_hlc(jax_msg, JAX.HlcStamp(1_700_000_000_000, 4, 2))
    frame = port_codec.encode(3, msg)
    assert frame == jax_codec.encode(3, jax_msg)
    payload = W.unpackb(frame[port_codec.ENVELOPE.size:])
    assert list(payload)[-2:] == ["__tc", "__hlc"]
    _, back = port_codec.decode(frame)
    assert back == msg and not hasattr(back, "__tc")
    assert PORT.trace_context_of(back) == PORT.TraceContext(1 << 63, 9, "origin", 0)
    assert PORT.hlc_of(back) == PORT.HlcStamp(1_700_000_000_000, 4, 2)
    _, plain = port_codec.decode(port_codec.encode(3, fx.convert(jax_msg, ptypes)))
    assert PORT.trace_context_of(plain) is None and PORT.hlc_of(plain) is None


def test_malformed_sidecars_never_break_decoding():
    body = {"sender": {"__ep": [b"10.0.0.1", 1]}, "__tc": "garbage", "__hlc": [-1, 0]}
    frame = port_codec.ENVELOPE.pack(4, 5) + W.packb(body)
    _, msg = port_codec.decode(frame)
    assert msg == ptypes.ProbeMessage(ptypes.Endpoint(b"10.0.0.1", 1))
    assert PORT.trace_context_of(msg) is None and PORT.hlc_of(msg) is None


def test_frames_from_a_newer_peer_with_unknown_reserved_keys_decode():
    """A newer peer adds reserved ``__`` keys at the top level (and thins
    defaults); both codecs read its frame to the same message."""
    alert = ptypes.AlertMessage(ptypes.Endpoint(b"a", 1), ptypes.Endpoint(b"b", 2),
                                ptypes.EdgeStatus.DOWN, -7, (0, 1))
    body = {"edge_src": {"__ep": [b"a", 1]}, "edge_dst": {"__ep": [b"b", 2]},
            "edge_status": {"__en": ["EdgeStatus", 1]}, "configuration_id": -7,
            "ring_numbers": [0, 1], "__future": {"x": [1, 2, "y"]}, "__v9": 9}
    frame = port_codec.ENVELOPE.pack(11, 4) + msgpack.packb(body, use_bin_type=True)
    assert port_codec.decode(frame) == (11, alert)
    assert fx.convert(jax_codec.decode(frame)[1], ptypes) == alert
    newer = jax_codec.encode_versioned(11, fx.convert(alert, rtypes), 5)
    assert port_codec.decode(newer) == (11, alert)


def test_large_tuples_and_bodies_are_memoized_without_changing_bytes():
    """The 4096-element tuple memo and the 64 KB body memo: a repeat encode
    of the same 5000-endpoint response is a memo hit with the same bytes as
    rapid_tpu's."""
    make = _Random(np.random.default_rng(7), ptypes)
    eps = tuple(make.endpoint() for _ in range(5000))
    msg = ptypes.JoinResponse(eps[0], ptypes.JoinStatusCode.SAFE_TO_JOIN, 3, eps,
                              tuple(make.node_id() for _ in range(5000)))
    first = port_codec.encode(1, msg)
    assert id(msg.endpoints) in port_codec._enc_memo  # noqa: SLF001
    assert id(msg) in port_codec._body_memo  # noqa: SLF001
    assert port_codec.encode(2, msg)[9:] == first[9:]
    assert first == jax_codec.encode(1, fx.convert(msg, rtypes))
