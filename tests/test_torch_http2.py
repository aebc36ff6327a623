"""The port's HTTP/2, HPACK and gRPC framing (``rapid_tpu_torch/messaging/
http2.py``), which grpcio does for the JAX package.

- HPACK: the Huffman code's 257 lengths satisfy Kraft's equality with EOS
  and give RFC 7541's examples (Appendix C), every byte value and random
  strings round-trip, prefix integers at their edges, the static table, and
  the dynamic table through RFC 7541's request and response sequences
  (C.3-C.6: size accounting, eviction) and size updates.
- Frames: a byte stream parsed at any split, HEADERS split into
  CONTINUATION, padding and priority stripped, unknown frame types and
  settings ids ignored, an oversized frame refused.
- Connections on real sockets: the port's server against a raw client that
  keeps HTTP/2's default settings (DATA split at 16 384 B, the sender
  stopping at the 65 535 B window until WINDOW_UPDATE); PING ACK and GOAWAY
  against the port's client; grpcio's own header blocks, client and server,
  decoded from raw sockets.
- gRPC: the message prefix, gzip and deflate messages, ``grpc-timeout``,
  ``grpc-message``'s percent-encoding and the status of a reply."""

import base64
import gzip
import random
import socket
import struct
import threading
import zlib
from fractions import Fraction

import grpc
import pytest

import chip_smoke
import rapid_tpu.types as rtypes
from rapid_tpu.messaging import grpc_transport as jax_gt
from rapid_tpu_torch import types as ptypes
from rapid_tpu_torch.messaging import grpc_transport as port_gt
from rapid_tpu_torch.messaging import http2
from rapid_tpu_torch.messaging.http2 import GrpcError, StatusCode
from rapid_tpu_torch.messaging.ports import free_port_base
from rapid_tpu_torch.messaging.wire_schema import GRPC_METHOD_PATH

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py

WAIT_S = 10.0


# ---------------------------------------------------------------------------
# HPACK
# ---------------------------------------------------------------------------


def test_huffman_lengths_satisfy_krafts_equality():
    assert len(http2.HUFFMAN_LENGTHS) == 257
    assert sum(Fraction(1, 2 ** n) for n in http2.HUFFMAN_LENGTHS) == 1
    assert http2.HUFFMAN_LENGTHS[http2.EOS] == 30
    assert http2.HUFFMAN_CODES[http2.EOS] == (1 << 30) - 1  # EOS is all ones
    assert len(set(zip(http2.HUFFMAN_LENGTHS, http2.HUFFMAN_CODES))) == 257


# RFC 7541 Appendix C.4 and C.6: strings and their Huffman codes
RFC_HUFFMAN = [
    (b"www.example.com", "f1e3c2e5f23a6ba0ab90f4ff"),
    (b"no-cache", "a8eb10649cbf"),
    (b"custom-key", "25a849e95ba97d7f"),
    (b"custom-value", "25a849e95bb8e8b4bf"),
    (b"302", "6402"),
    (b"307", "640eff"),
    (b"private", "aec3771a4b"),
    (b"Mon, 21 Oct 2013 20:13:21 GMT", "d07abe941054d444a8200595040b8166e082a62d1bff"),
    (b"https://www.example.com", "9d29ad171863c78f0b97c8e9ae82ae43d3"),
    (b"gzip", "9bd9ab"),
    (b"foo=ASDJKHQKBZXOQWEOPIUAXQWEOIU; max-age=3600; version=1",
     "94e7821dd7f2e6c7b335dfdfcd5b3960d5af27087f3672c1ab270fb5291f9587316065c003ed4ee5b1063d5007"),
]


@pytest.mark.parametrize("raw,coded", RFC_HUFFMAN, ids=[r.decode()[:16] for r, _ in RFC_HUFFMAN])
def test_huffman_gives_rfc_7541_examples(raw, coded):
    assert http2.huffman_encode(raw).hex() == coded
    assert http2.huffman_decode(bytes.fromhex(coded)) == raw


def test_huffman_round_trips_every_byte_value():
    for byte in range(256):
        for n in (1, 2, 3, 7):
            data = bytes([byte]) * n
            assert http2.huffman_decode(http2.huffman_encode(data)) == data, (byte, n)
    everything = bytes(range(256))
    assert http2.huffman_decode(http2.huffman_encode(everything)) == everything


@pytest.mark.parametrize("seed", range(4))
def test_huffman_round_trips_random_strings(seed):
    rng = random.Random(seed)
    for _ in range(200):
        data = bytes(rng.getrandbits(8) for _ in range(rng.randrange(0, 120)))
        assert http2.huffman_decode(http2.huffman_encode(data)) == data
        text = "".join(rng.choice("abcdefghijklmnopqrstuvwxyz0123456789-_./:") for _ in
                       range(rng.randrange(0, 80))).encode()
        coded = http2.huffman_encode(text)
        assert http2.huffman_decode(coded) == text
        assert http2.decode_string(http2.encode_string(text, huffman=True), 0) == (
            text, len(http2.encode_string(text, huffman=True)))


@pytest.mark.parametrize("coded", [
    "ff",  # 8 bits of padding
    "fffffffc",  # EOS itself
    "00",  # '0' then 3 bits of zero padding
])
def test_huffman_refuses_bad_padding_and_eos(coded):
    with pytest.raises(http2.HpackError):
        http2.huffman_decode(bytes.fromhex(coded))


# RFC 7541 C.1 and the prefix boundaries: (value, prefix bits, encoding)
INTEGERS = [
    (10, 5, "0a"), (1337, 5, "1f9a0a"), (42, 8, "2a"),
    (30, 5, "1e"), (31, 5, "1f00"), (32, 5, "1f01"), (31 + 127, 5, "1f7f"),
    (31 + 128, 5, "1f8001"), (0, 1, "00"), (1, 1, "0100"), (126, 7, "7e"), (127, 7, "7f00"),
    (254, 8, "fe"), (255, 8, "ff00"), (2 ** 62, 4, None),
]


@pytest.mark.parametrize("value,prefix,coded", INTEGERS)
def test_integer_prefix_edge_cases(value, prefix, coded):
    data = http2.encode_int(value, prefix)
    if coded is not None:
        assert data.hex() == coded
    assert http2.decode_int(data, 0, prefix) == (value, len(data))
    # the first byte's bits above the prefix belong to the representation
    flags = (0xFF << prefix) & 0xFF
    flagged = http2.encode_int(value, prefix, flags)
    assert flagged[0] & flags == flags
    assert http2.decode_int(b"\x99" + flagged, 1, prefix) == (value, len(flagged) + 1)


def test_integer_truncated_and_overlong_are_refused():
    with pytest.raises(http2.HpackError):
        http2.decode_int(bytes.fromhex("1f9a"), 0, 5)
    with pytest.raises(http2.HpackError):
        http2.decode_int(bytes.fromhex("1f" + "80" * 10 + "01"), 0, 5)


def test_static_table():
    table = http2.STATIC_TABLE
    assert len(table) == 61
    assert table[0] == (":authority", "")
    assert table[1] == (":method", "GET") and table[2] == (":method", "POST")
    assert table[7] == (":status", "200") and table[13] == (":status", "500")
    assert table[15] == ("accept-encoding", "gzip, deflate")
    assert table[30] == ("content-type", "") and table[57] == ("user-agent", "")
    assert table[60] == ("www-authenticate", "")


def _lit(name_index, value, name=None, indexing=True, huffman=False):
    """A literal representation: with incremental indexing (6-bit name
    index), or without (4-bit)."""
    out = http2.encode_int(name_index, 6 if indexing else 4, 0x40 if indexing else 0)
    if not name_index:
        out += http2.encode_string(name.encode(), huffman)
    return out + http2.encode_string(value.encode(), huffman)


def _idx(index):
    return http2.encode_int(index, 7, 0x80)


@pytest.mark.parametrize("huffman", [False, True], ids=["C.3 raw", "C.4 Huffman"])
def test_rfc_7541_request_sequence(huffman):
    """RFC 7541 C.3 / C.4: three requests on one decoder, the dynamic table
    growing 57, 110, 164 octets."""
    d = http2.Decoder()
    first = _idx(2) + _idx(6) + _idx(4) + _lit(1, "www.example.com", huffman=huffman)
    if huffman:
        assert first.hex() == "828684418cf1e3c2e5f23a6ba0ab90f4ff"
    else:
        assert first.hex() == "828684410f7777772e6578616d706c652e636f6d"
    assert d.decode(first) == [(":method", "GET"), (":scheme", "http"), (":path", "/"),
                               (":authority", "www.example.com")]
    assert d.size == 57
    assert d.decode(_idx(2) + _idx(6) + _idx(4) + _idx(62)
                    + _lit(24, "no-cache", huffman=huffman)) == [
        (":method", "GET"), (":scheme", "http"), (":path", "/"),
        (":authority", "www.example.com"), ("cache-control", "no-cache")]
    assert d.size == 110
    assert d.decode(_idx(2) + _idx(7) + _idx(5) + _idx(63)
                    + _lit(0, "custom-value", "custom-key", huffman=huffman)) == [
        (":method", "GET"), (":scheme", "https"), (":path", "/index.html"),
        (":authority", "www.example.com"), ("custom-key", "custom-value")]
    assert d.size == 164
    assert list(d.table) == [("custom-key", "custom-value"), ("cache-control", "no-cache"),
                             (":authority", "www.example.com")]


@pytest.mark.parametrize("huffman", [False, True], ids=["C.5 raw", "C.6 Huffman"])
def test_rfc_7541_response_sequence_evicts(huffman):
    """RFC 7541 C.5 / C.6: three responses on a 256-octet table, each adding
    past the limit and evicting the oldest entries."""
    d = http2.Decoder(256)
    date1, date2 = "Mon, 21 Oct 2013 20:13:21 GMT", "Mon, 21 Oct 2013 20:13:22 GMT"
    loc = "https://www.example.com"
    cookie = "foo=ASDJKHQKBZXOQWEOPIUAXQWEOIU; max-age=3600; version=1"
    assert d.decode(_lit(8, "302", huffman=huffman) + _lit(24, "private", huffman=huffman)
                    + _lit(33, date1, huffman=huffman) + _lit(46, loc, huffman=huffman)) == [
        (":status", "302"), ("cache-control", "private"), ("date", date1), ("location", loc)]
    assert d.size == 222
    assert d.decode(_lit(8, "307", huffman=huffman) + _idx(65) + _idx(64) + _idx(63)) == [
        (":status", "307"), ("cache-control", "private"), ("date", date1), ("location", loc)]
    assert d.size == 222 and (":status", "302") not in d.table
    assert d.decode(_idx(8) + _idx(65) + _lit(33, date2, huffman=huffman) + _idx(64)
                    + _lit(26, "gzip", huffman=huffman)
                    + _lit(55, cookie, huffman=huffman)) == [
        (":status", "200"), ("cache-control", "private"), ("date", date2), ("location", loc),
        ("content-encoding", "gzip"), ("set-cookie", cookie)]
    assert d.size == 215
    assert list(d.table) == [("set-cookie", cookie), ("content-encoding", "gzip"),
                             ("date", date2)]


def test_dynamic_table_size_updates():
    d = http2.Decoder()
    d.decode(_lit(0, "a" * 10, "x-one") + _lit(0, "b" * 10, "x-two"))
    assert d.size == 2 * (5 + 10 + 32)
    # a size update at the block's start evicts down to the new size
    assert d.decode(http2.encode_int(50, 5, 0x20) + _idx(62)) == [("x-two", "b" * 10)]
    assert d.size == 47 and d.max_size == 50
    # an entry larger than the table empties it and is not added
    assert d.decode(_lit(0, "c" * 40, "x-big")) == [("x-big", "c" * 40)]
    assert d.size == 0 and not d.table
    # back up to the limit; never above it; never after a field
    d.decode(http2.encode_int(4096, 5, 0x20))
    assert d.max_size == 4096
    with pytest.raises(http2.HpackError):
        d.decode(http2.encode_int(4097, 5, 0x20))
    with pytest.raises(http2.HpackError):
        d.decode(_idx(2) + http2.encode_int(100, 5, 0x20))
    with pytest.raises(http2.HpackError):
        d.decode(_idx(70))  # beyond the (empty) dynamic table
    with pytest.raises(http2.HpackError):
        d.decode(_idx(0))


def test_never_indexed_and_without_indexing_leave_the_table():
    d = http2.Decoder()
    block = (_lit(0, "v1", "x-a", indexing=False) + bytes([0x10])
             + http2.encode_string(b"x-b") + http2.encode_string(b"v2")
             + _lit(58, "ua", indexing=False))
    assert d.decode(block) == [("x-a", "v1"), ("x-b", "v2"), ("user-agent", "ua")]
    assert d.size == 0


def test_encode_headers_round_trips_and_leaves_no_state():
    headers = http2.request_headers(GRPC_METHOD_PATH, "127.0.0.1:5000", 1.5) + [
        ("x-bytes", bytes(range(256)).decode("latin-1")), ("x-empty", "")]
    block = http2.encode_headers(headers)
    d = http2.Decoder()
    assert d.decode(block) == headers and d.size == 0
    assert http2.encode_headers([(":method", "POST")]) == b"\x83"  # the static entry


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------


def test_frame_reader_at_any_split():
    stream = (http2.settings_frame(http2.CLIENT_SETTINGS) + http2.window_update(0, 99)
              + http2.ping(b"12345678") + http2.frame(http2.DATA, 1, 3, b"x" * 300)
              + http2.goaway(7, http2.NO_ERROR, b"bye") + http2.rst_stream(5, http2.CANCEL))
    whole = http2.FrameReader().feed(stream)
    assert [f.type for f in whole] == [http2.SETTINGS, http2.WINDOW_UPDATE, http2.PING,
                                       http2.DATA, http2.GOAWAY, http2.RST_STREAM]
    assert whole[3] == http2.Frame(http2.DATA, 1, 3, b"x" * 300)
    for step in (1, 7, 9, 64):
        reader, got = http2.FrameReader(), []
        for i in range(0, len(stream), step):
            got += reader.feed(stream[i:i + step])
        assert got == whole, step


def test_frame_above_max_frame_size_is_refused():
    reader = http2.FrameReader(http2.DEFAULT_MAX_FRAME)
    with pytest.raises(http2.ProtocolError) as info:
        reader.feed(http2.frame_head(http2.DATA, 0, 1, http2.DEFAULT_MAX_FRAME + 1))
    assert info.value.code == http2.FRAME_SIZE_ERROR


def test_header_block_split_into_continuation():
    block = http2.encode_headers(http2.request_headers(GRPC_METHOD_PATH, "h:1", 2.0))
    data = http2.header_frames(5, block, 20, end_stream=True)
    frames = http2.FrameReader().feed(data)
    assert frames[0].type == http2.HEADERS and frames[0].flags == http2.END_STREAM
    assert all(f.type == http2.CONTINUATION for f in frames[1:])
    assert all(len(f.payload) <= 20 for f in frames) and len(frames) == -(-len(block) // 20)
    assert frames[-1].flags & http2.END_HEADERS and not frames[0].flags & http2.END_HEADERS
    assert b"".join(f.payload for f in frames) == block
    one = http2.FrameReader().feed(http2.header_frames(5, block, 1 << 14, end_stream=False))
    assert len(one) == 1 and one[0].flags == http2.END_HEADERS


def test_padding_and_priority_are_stripped():
    padded = http2.Frame(http2.DATA, http2.PADDED, 1, bytes([3]) + b"body" + b"\0\0\0")
    assert http2.frame_body(padded) == b"body"
    both = http2.Frame(http2.HEADERS, http2.PADDED | http2.PRIORITY_FLAG, 1,
                       bytes([2]) + b"\x80\0\0\x03\x10" + b"blk" + b"\0\0")
    assert http2.frame_body(both) == b"blk"
    assert http2.frame_body(http2.Frame(http2.HEADERS, http2.PRIORITY_FLAG, 1,
                                        b"\0\0\0\0\x01" + b"blk")) == b"blk"
    with pytest.raises(http2.ProtocolError):
        http2.frame_body(http2.Frame(http2.DATA, http2.PADDED, 1, bytes([9]) + b"ab"))


# ---------------------------------------------------------------------------
# gRPC framing
# ---------------------------------------------------------------------------


def test_message_prefix_and_compression():
    body = b"rapid" * 1000
    assert http2.grpc_frame(body) == b"\0" + struct.pack(">I", len(body)) + body
    assert http2.parse_message(http2.grpc_frame(body)) == body
    for encoding, packed in (("gzip", gzip.compress(body)), ("deflate", zlib.compress(body)),
                             ("deflate", zlib.compress(body)[2:-4])):  # raw deflate too
        framed = b"\1" + struct.pack(">I", len(packed)) + packed
        assert http2.parse_message(framed, encoding) == body, encoding
    with pytest.raises(GrpcError) as info:
        http2.parse_message(b"\1\0\0\0\2ab", "identity")
    assert info.value.code() is StatusCode.INTERNAL
    with pytest.raises(GrpcError):
        http2.parse_message(http2.grpc_frame(body)[:-1])
    assert http2.message_length(b"\0\0\0\1") is None
    assert http2.message_length(b"\0\x00\x40\x00\x01") == http2.MAX_MESSAGE + 1
    assert http2.too_large(5).code() is StatusCode.RESOURCE_EXHAUSTED


@pytest.mark.parametrize("text,seconds", [
    ("1500m", 1.5), ("3S", 3.0), ("2M", 120.0), ("1H", 3600.0), ("250u", 250e-6),
    ("999n", 999e-9), ("99999999m", 99999.999)])
def test_grpc_timeout_units(text, seconds):
    assert http2.decode_timeout(text) == pytest.approx(seconds)


def test_grpc_timeout_encoding():
    assert http2.encode_timeout(1.5) == "1500m"
    assert http2.encode_timeout(0.0001) == "1m"  # rounded up
    assert http2.encode_timeout(200_000.0) == "200000S"
    assert http2.encode_timeout(10 ** 9) == "16666667M"
    assert http2.decode_timeout(None) is None
    for bad in ("15x", "m", "123456789m", "-1m"):
        with pytest.raises(GrpcError):
            http2.decode_timeout(bad)


def test_grpc_message_percent_encoding():
    for text in ("membership service not ready", "100% done", "élan\n\ttab", "", "%zz"):
        assert http2.percent_decode(http2.percent_encode(text)) == text
    assert http2.percent_encode("a%b\n") == "a%25b%0A"
    assert http2.percent_decode("%zz%4") == "%zz%4"  # invalid escapes stay as they are


def test_reply_status():
    ok = http2.RESPONSE_HEADERS
    assert http2.response_status(ok, http2.trailers(StatusCode.OK)) == (StatusCode.OK, "")
    only = http2.TRAILERS_ONLY_HEADERS + http2.trailers(StatusCode.UNAVAILABLE, "not 100%")
    assert http2.response_status(only, None) == (StatusCode.UNAVAILABLE, "not 100%")
    assert http2.response_status([(":status", "503")], None)[0] is StatusCode.UNAVAILABLE
    assert http2.response_status([(":status", "404")], None)[0] is StatusCode.UNIMPLEMENTED
    assert http2.response_status(ok, [("grpc-status", "77")])[0] is StatusCode.UNKNOWN
    assert http2.response_status(ok, [])[0] is StatusCode.UNKNOWN
    err = GrpcError(StatusCode.DEADLINE_EXCEEDED, "Deadline Exceeded")
    assert err.code().name == grpc.StatusCode.DEADLINE_EXCEEDED.name
    assert [c.value for c in StatusCode] == [c.value[0] for c in grpc.StatusCode]
    assert [c.name for c in StatusCode] == [c.name for c in grpc.StatusCode]


# ---------------------------------------------------------------------------
# connections on real sockets
# ---------------------------------------------------------------------------


def _read_until(sock, reader, frames, done, timeout=WAIT_S):
    sock.settimeout(timeout)
    while not done(frames):
        data = sock.recv(1 << 16)
        assert data, "the peer closed the connection"
        frames += reader.feed(data)
    return frames


def _drain(sock, reader, frames, quiet_s=0.3):
    """Whatever arrives until the peer is quiet for ``quiet_s``."""
    sock.settimeout(quiet_s)
    try:
        while True:
            data = sock.recv(1 << 16)
            if not data:
                break
            frames += reader.feed(data)
    except socket.timeout:
        pass
    return frames


@pytest.fixture
def port_server():
    me = ptypes.Endpoint(b"127.0.0.1", 7000)
    reply = ptypes.JoinResponse(
        sender=me, status_code=ptypes.JoinStatusCode.SAFE_TO_JOIN, configuration_id=-3,
        endpoints=tuple(ptypes.Endpoint(b"10.0.%d.%d" % (i >> 8, i & 255), 5000)
                        for i in range(12_000)))
    server = port_gt.GrpcServer(ptypes.Endpoint.from_parts("127.0.0.1", free_port_base(1)))
    server.set_membership_service(chip_smoke.AnswerService(reply))
    server.start()
    try:
        yield server, reply
    finally:
        server.shutdown()


def _request_frames(stream_id=1, headers_max_frame=1 << 14, padded=False):
    request = port_gt.to_wire_request(ptypes.ProbeMessage(sender=ptypes.Endpoint(b"h", 1)))
    block = http2.encode_headers(http2.request_headers(GRPC_METHOD_PATH, "h:1", 5.0))
    body = http2.grpc_frame(request)
    if padded:
        headers = http2.frame(http2.HEADERS, http2.END_HEADERS | http2.PADDED | http2.PRIORITY_FLAG,
                              stream_id, bytes([4]) + b"\0\0\0\0\x10" + block + b"\0" * 4)
        data = http2.frame(http2.DATA, http2.END_STREAM | http2.PADDED, stream_id,
                           bytes([7]) + body + b"\0" * 7)
        return headers + data
    return (http2.header_frames(stream_id, block, headers_max_frame, end_stream=False)
            + http2.frame(http2.DATA, http2.END_STREAM, stream_id, body))


def _data_of(frames, stream_id):
    return [f for f in frames if f.type == http2.DATA and f.stream_id == stream_id]


def test_port_server_splits_data_and_waits_for_window(port_server):
    """A client that keeps HTTP/2's defaults (16 384 B frames, 65 535 B
    windows): the port's server sends exactly the window in frames of at most
    16 384 B, stops, and sends the rest once the client grants more."""
    server, reply = port_server
    sock = socket.create_connection(("127.0.0.1", server.address.port))
    try:
        sock.sendall(http2.PREFACE + http2.settings_frame(()) + _request_frames())
        reader, frames = http2.FrameReader(), []
        _read_until(sock, reader, frames, lambda fs: sum(
            len(f.payload) for f in _data_of(fs, 1)) >= http2.DEFAULT_WINDOW)
        _drain(sock, reader, frames, quiet_s=0.5)  # nothing more comes until the grant
        data = _data_of(frames, 1)
        assert sum(len(f.payload) for f in data) == http2.DEFAULT_WINDOW
        assert max(len(f.payload) for f in data) == http2.DEFAULT_MAX_FRAME
        assert server.stats["stalls"] >= 1
        sock.sendall(http2.window_update(0, 1 << 24) + http2.window_update(1, 1 << 24))
        _read_until(sock, reader, frames, lambda fs: any(
            f.type == http2.HEADERS and f.flags & http2.END_STREAM for f in fs))
        body = b"".join(f.payload for f in _data_of(frames, 1))
        assert all(len(f.payload) <= http2.DEFAULT_MAX_FRAME for f in _data_of(frames, 1))
        assert port_gt.from_wire_response(http2.parse_message(body)) == reply
        assert len(body) > 3 * http2.DEFAULT_WINDOW
    finally:
        sock.close()


@pytest.mark.parametrize("variant", ["continuation", "padded and priority", "unknown frames"])
def test_port_server_reads_every_frame_form(port_server, variant):
    """HEADERS split into CONTINUATION, padded HEADERS and DATA with a
    priority field, and unknown frame types and settings ids (grpcio's
    0xfe03) among them: the port's server answers each the same way, and
    ACKs the client's SETTINGS and PING."""
    server, reply = port_server
    sock = socket.create_connection(("127.0.0.1", server.address.port))
    try:
        out = http2.PREFACE + http2.settings_frame(
            ((0xFE03, 1), (http2.INITIAL_WINDOW_SIZE, 1 << 22), (0x99, 7),
             (http2.MAX_FRAME_SIZE, 1 << 20)))
        if variant == "continuation":
            out += _request_frames(headers_max_frame=16)
        elif variant == "padded and priority":
            out += http2.frame(http2.PRIORITY, 0, 1, b"\0\0\0\0\x10") + _request_frames(padded=True)
        else:
            out += (http2.frame(0x0B, 0, 0, b"?") + http2.frame(0xFA, 0xFF, 1, b"abc")
                    + _request_frames())
        out += http2.ping(b"pingpong") + http2.window_update(0, 1 << 24)
        sock.sendall(out)
        reader, frames = http2.FrameReader(), []
        _read_until(sock, reader, frames, lambda fs: any(
            f.type == http2.HEADERS and f.flags & http2.END_STREAM for f in fs))
        assert http2.Frame(http2.SETTINGS, http2.ACK, 0, b"") in frames
        assert http2.Frame(http2.PING, http2.ACK, 0, b"pingpong") in frames
        body = b"".join(f.payload for f in _data_of(frames, 1))
        assert port_gt.from_wire_response(http2.parse_message(body)) == reply
    finally:
        sock.close()


def test_oversized_frame_gets_goaway(port_server):
    server, _ = port_server
    sock = socket.create_connection(("127.0.0.1", server.address.port))
    try:
        sock.sendall(http2.PREFACE + http2.settings_frame(())
                     + http2.frame_head(http2.DATA, 0, 1, http2.WINDOW + 1))
        frames = _read_until(sock, http2.FrameReader(), [], lambda fs: any(
            f.type == http2.GOAWAY for f in fs))
        goaways = [f for f in frames if f.type == http2.GOAWAY]
        assert goaways and struct.unpack_from(">I", goaways[0].payload, 4)[0] == \
            http2.FRAME_SIZE_ERROR
    finally:
        sock.close()


class RawServer:
    """A listening socket that plays an HTTP/2 server by hand, a connection
    at a time, in a thread."""

    def __init__(self, handle):
        self.listener = socket.create_server(("127.0.0.1", 0))
        self.listener.settimeout(0.05)
        self.port = self.listener.getsockname()[1]
        self.handle, self.errors, self.accepted = handle, [], 0
        self.stopped = threading.Event()
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        while not self.stopped.is_set():
            try:
                conn, _ = self.listener.accept()
            except socket.timeout:
                continue
            conn.settimeout(None)
            self.accepted += 1
            with conn:
                try:
                    self.handle(conn, self.accepted)
                except Exception as e:  # noqa: BLE001 -- reported by the test
                    self.errors.append(repr(e))

    def close(self):
        self.stopped.set()
        self.thread.join(WAIT_S)
        assert not self.thread.is_alive()
        self.listener.close()


def _read_request(conn, reader, frames):
    """Frames up to the client's first complete request; the preface checked."""
    preface = b""
    while len(preface) < len(http2.PREFACE):
        preface += conn.recv(len(http2.PREFACE) - len(preface))
    assert preface == http2.PREFACE
    return _read_until(conn, reader, frames, lambda fs: any(
        f.type == http2.DATA and f.flags & http2.END_STREAM for f in fs))


def test_port_client_acks_ping_and_fails_streams_above_goaway():
    """A hand-played server PINGs the port's client (ACKed with the same
    payload), then sends GOAWAY with last stream 0: the call in flight fails
    as UNAVAILABLE at once, and the next call dials a new connection."""
    pings = []

    def handle(conn, n):
        reader, frames = http2.FrameReader(), []
        _read_request(conn, reader, frames)
        conn.sendall(http2.settings_frame(()) + http2.ping(b"%08d" % n))
        _read_until(conn, reader, frames, lambda fs: any(f.type == http2.PING for f in fs))
        pings.append([f for f in frames if f.type == http2.PING])
        if n == 1:
            conn.sendall(http2.goaway(0, http2.NO_ERROR))
        else:
            reply = port_gt.to_wire_response(ptypes.ProbeResponse(ptypes.NodeStatus.OK))
            block = http2.encode_headers(http2.RESPONSE_HEADERS)
            conn.sendall(http2.header_frames(1, block, 1 << 14, False)
                         + http2.frame(http2.DATA, 0, 1, http2.grpc_frame(reply))
                         + http2.header_frames(1, http2.encode_headers(
                             http2.trailers(StatusCode.OK)), 1 << 14, True))
        _drain(conn, reader, frames)

    raw = RawServer(handle)
    me = ptypes.Endpoint.from_parts("127.0.0.1", 1)
    remote = ptypes.Endpoint.from_parts("127.0.0.1", raw.port)
    client = port_gt.GrpcClient(me)
    try:
        with pytest.raises(GrpcError) as info:
            client.send_message_best_effort(remote, ptypes.ProbeMessage(sender=me)).result(WAIT_S)
        assert info.value.code() is StatusCode.UNAVAILABLE and "GOAWAY" in info.value.details()
        got = client.send_message_best_effort(remote, ptypes.ProbeMessage(sender=me)).result(WAIT_S)
        assert got == ptypes.ProbeResponse(ptypes.NodeStatus.OK)
        assert raw.accepted == 2 and not raw.errors
        assert [[(f.flags, f.payload) for f in p] for p in pings] == [
            [(http2.ACK, b"00000001")], [(http2.ACK, b"00000002")]]
        assert client.stats["PING out"] == 2 and client.stats["GOAWAY in"] == 1
    finally:
        client.shutdown()
        raw.close()


def test_grpcio_client_header_blocks_decode():
    """grpcio's client against a hand-played server that does not offer
    binary metadata: the port decodes its header block, ASCII metadata raw
    and a ``-bin`` value base64-coded under Huffman, to exactly what the
    caller sent."""
    ascii_value = "".join(chr(c) for c in range(0x20, 0x7F)).strip()
    binary = bytes(range(256))
    seen = []

    def handle(conn, n):
        reader, frames = http2.FrameReader(), []
        conn.sendall(http2.settings_frame(()))
        _read_request(conn, reader, frames)
        block = b"".join(http2.frame_body(f) for f in frames
                         if f.type in (http2.HEADERS, http2.CONTINUATION))
        seen.append((http2.Decoder().decode(block), block))
        reply = port_gt.to_wire_response(ptypes.Response())
        conn.sendall(http2.header_frames(1, http2.encode_headers(http2.RESPONSE_HEADERS),
                                         1 << 14, False)
                     + http2.frame(http2.DATA, 0, 1, http2.grpc_frame(reply))
                     + http2.header_frames(1, http2.encode_headers(
                         http2.trailers(StatusCode.OK)), 1 << 14, True))
        _drain(conn, reader, frames)

    raw = RawServer(handle)
    channel = grpc.insecure_channel(f"127.0.0.1:{raw.port}")
    try:
        stub = channel.unary_unary(GRPC_METHOD_PATH)
        stub(b"", timeout=WAIT_S, metadata=(("x-ascii", ascii_value), ("x-blob-bin", binary)))
    finally:
        channel.close()
        raw.close()
    headers, block = seen[0]
    fields = dict(headers)
    assert fields[":path"] == GRPC_METHOD_PATH and fields[":method"] == "POST"
    assert fields["content-type"] == "application/grpc" and fields["te"] == "trailers"
    assert fields["x-ascii"] == ascii_value
    coded = base64.b64encode(binary).rstrip(b"=")
    assert fields["x-blob-bin"] == coded.decode()
    assert http2.huffman_encode(coded) in block
    assert [n for n, _ in headers][:4] == [":path", ":authority", ":method", ":scheme"]


def test_grpcio_server_header_blocks_decode():
    """A hand-played client against JAX's grpcio server, several calls on
    one connection: the port's decoder follows grpcio's dynamic table from
    block to block and reads each reply's status."""
    server = jax_gt.GrpcServer(rtypes.Endpoint.from_parts("127.0.0.1", free_port_base(1)))
    server.start()
    sock = socket.create_connection(("127.0.0.1", server.address.port))
    try:
        sock.sendall(http2.PREFACE + http2.settings_frame(()))
        probe = port_gt.to_wire_request(ptypes.ProbeMessage(sender=ptypes.Endpoint(b"h", 1)))
        leave = port_gt.to_wire_request(ptypes.LeaveMessage(sender=ptypes.Endpoint(b"h", 1)))
        reader, frames, decoder = http2.FrameReader(), [], http2.Decoder()
        for stream_id, body in ((1, probe), (3, leave), (5, probe), (7, leave)):
            block = http2.encode_headers(http2.request_headers(GRPC_METHOD_PATH, "h:1", 5.0))
            sock.sendall(http2.header_frames(stream_id, block, 1 << 14, False)
                         + http2.frame(http2.DATA, http2.END_STREAM, stream_id,
                                       http2.grpc_frame(body)))
            _read_until(sock, reader, frames, lambda fs: any(
                f.type == http2.HEADERS and f.flags & http2.END_STREAM and f.stream_id == stream_id
                for f in fs))
        blocks = {}
        for f in frames:
            if f.type == http2.PING and not f.flags & http2.ACK:
                sock.sendall(http2.ping(f.payload, ack=True))
            if f.type == http2.HEADERS:
                blocks.setdefault(f.stream_id, []).append(decoder.decode(http2.frame_body(f)))
        for stream_id in (1, 5):
            head, trail = blocks[stream_id]
            assert http2.response_status(head, trail) == (StatusCode.OK, "")
            body = b"".join(f.payload for f in _data_of(frames, stream_id))
            assert port_gt.from_wire_response(http2.parse_message(body)) == \
                ptypes.ProbeResponse(ptypes.NodeStatus.BOOTSTRAPPING)
        for stream_id in (3, 7):
            (only,) = blocks[stream_id]
            assert http2.response_status(only, None) == (
                StatusCode.UNAVAILABLE, "membership service not ready")
        assert decoder.size > 0  # grpcio indexed its fields, and the port followed
    finally:
        sock.close()
        server.shutdown()
