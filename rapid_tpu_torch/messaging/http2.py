"""HTTP/2 (RFC 7540) and HPACK (RFC 7541), only as much as one unary gRPC
call over cleartext needs, and gRPC's framing over them (the gRPC over
HTTP/2 protocol).

The JAX package leaves all of this to grpcio. The port keeps its own copy in
pure Python on the standard library, as it does with MessagePack
(``msgpack_wire.py``) and proto3 (``proto_wire.py``), so that
``grpc_transport.GrpcServer`` and ``GrpcClient`` speak to each other and to
grpcio peers on a machine without grpcio.

- Frames: ``FrameReader`` parses a byte stream into ``Frame``s and
  ``frame_body`` strips the PADDED and PRIORITY fields of DATA and HEADERS;
  ``frame`` and its helpers write them, and ``header_frames`` splits a
  header block into HEADERS and CONTINUATION at the peer's MAX_FRAME_SIZE.
  Unknown frame types and unknown settings ids are ignored.
- HPACK: prefix integers, string literals (raw and Huffman; the code of RFC
  7541 Appendix B is built from its 257 code lengths), the 61-entry static
  table and a ``Decoder`` that keeps the dynamic table (size accounting,
  eviction, size updates). ``encode_headers`` emits indexed static entries
  and raw literals only, so the encoding side keeps no table.
- ``Connection``: one connection's state on either side, run by one asyncio
  loop: the SETTINGS exchange and its ACK, PING ACK, GOAWAY, RST_STREAM,
  the peer's MAX_FRAME_SIZE and MAX_HEADER_LIST_SIZE, and flow control both
  ways (a sender waits when a window is spent and resumes on WINDOW_UPDATE;
  a receiver grants window as it consumes). Both sides advertise grpcio's
  settings (but its private id 0xfe03) and open the connection window to
  4 MiB. Every frame of a connection is read and written on its loop's
  thread, so its HPACK decoder sees header blocks strictly in the order they
  arrived, across concurrent streams too.
- gRPC: the 5-byte message prefix, the request headers grpcio's client
  sends, the response's headers, DATA and trailers (``grpc-status``, a
  percent-encoded ``grpc-message``) or a trailers-only reply,
  ``grpc-timeout``, messages compressed under ``grpc-encoding`` gzip or
  deflate (the port itself sends identity), grpcio's default 4 MiB receive
  limit, and ``GrpcError``, which names grpcio's status codes.
"""

from __future__ import annotations

import asyncio
import collections
import enum
import math
import struct
import zlib
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional, Tuple

# ---------------------------------------------------------------------------
# frames (RFC 7540 section 4, 6)
# ---------------------------------------------------------------------------

PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

DATA, HEADERS, PRIORITY, RST_STREAM, SETTINGS, PUSH_PROMISE, PING, GOAWAY, \
    WINDOW_UPDATE, CONTINUATION = range(10)
FRAME_NAMES = ("DATA", "HEADERS", "PRIORITY", "RST_STREAM", "SETTINGS", "PUSH_PROMISE",
               "PING", "GOAWAY", "WINDOW_UPDATE", "CONTINUATION")

END_STREAM = 0x1  # DATA, HEADERS
ACK = 0x1  # SETTINGS, PING
END_HEADERS = 0x4  # HEADERS, CONTINUATION
PADDED = 0x8  # DATA, HEADERS
PRIORITY_FLAG = 0x20  # HEADERS

HEADER_TABLE_SIZE, ENABLE_PUSH, MAX_CONCURRENT_STREAMS, INITIAL_WINDOW_SIZE, \
    MAX_FRAME_SIZE, MAX_HEADER_LIST_SIZE = range(1, 7)

NO_ERROR, PROTOCOL_ERROR, INTERNAL_ERROR, FLOW_CONTROL_ERROR, SETTINGS_TIMEOUT, \
    STREAM_CLOSED, FRAME_SIZE_ERROR, REFUSED_STREAM, CANCEL, COMPRESSION_ERROR, \
    CONNECT_ERROR, ENHANCE_YOUR_CALM, INADEQUATE_SECURITY, HTTP_1_1_REQUIRED = range(14)

DEFAULT_WINDOW = 65_535
DEFAULT_MAX_FRAME = 16_384
MAX_WINDOW = 2**31 - 1
MAX_STREAM_ID = 2**31 - 1
# grpcio's: both sides advertise a 4 MiB stream window and frame size and a
# 16 KiB header list, and open the connection window to 4 MiB
WINDOW = 4 * 1024 * 1024
HEADER_LIST_LIMIT = 16_384
CLIENT_SETTINGS = ((ENABLE_PUSH, 0), (MAX_CONCURRENT_STREAMS, 0), (INITIAL_WINDOW_SIZE, WINDOW),
                   (MAX_FRAME_SIZE, WINDOW), (MAX_HEADER_LIST_SIZE, HEADER_LIST_LIMIT))
SERVER_SETTINGS = ((INITIAL_WINDOW_SIZE, WINDOW), (MAX_FRAME_SIZE, WINDOW),
                   (MAX_HEADER_LIST_SIZE, HEADER_LIST_LIMIT))
# a peer's settings until its SETTINGS frame arrives (RFC 7540 section 6.5.2)
DEFAULT_SETTINGS = {HEADER_TABLE_SIZE: 4096, ENABLE_PUSH: 1, MAX_CONCURRENT_STREAMS: None,
                    INITIAL_WINDOW_SIZE: DEFAULT_WINDOW, MAX_FRAME_SIZE: DEFAULT_MAX_FRAME,
                    MAX_HEADER_LIST_SIZE: None}

_HEAD = struct.Struct(">HBBBI")  # length (24 bits, as 16 + 8), type, flags, stream id


class ProtocolError(Exception):
    """A connection error (RFC 7540 section 5.4.1) with its error code."""

    def __init__(self, code: int, message: str) -> None:
        super().__init__(message)
        self.code = code


class Frame(NamedTuple):
    type: int
    flags: int
    stream_id: int
    payload: bytes


class FrameReader:
    """Parses a byte stream into frames as it arrives; a frame longer than
    ``max_frame_size`` is a FRAME_SIZE_ERROR."""

    def __init__(self, max_frame_size: int = WINDOW) -> None:
        self.max_frame_size = max_frame_size
        self._buf = bytearray()

    def feed(self, data: bytes) -> List[Frame]:
        buf = self._buf
        buf += data
        frames, pos, end = [], 0, len(buf)
        while end - pos >= 9:
            high, low, ftype, flags, sid = _HEAD.unpack_from(buf, pos)
            length = high << 8 | low
            if length > self.max_frame_size:
                raise ProtocolError(FRAME_SIZE_ERROR, f"a frame of {length} B, above "
                                    f"{self.max_frame_size}")
            if end - pos - 9 < length:
                break
            frames.append(Frame(ftype, flags, sid & MAX_STREAM_ID,
                                bytes(buf[pos + 9:pos + 9 + length])))
            pos += 9 + length
        del buf[:pos]
        return frames


def frame_body(f: Frame) -> bytes:
    """A DATA or HEADERS frame's content, its padding and priority fields
    stripped."""
    payload, start, end = f.payload, 0, len(f.payload)
    if f.flags & PADDED:
        if not payload:
            raise ProtocolError(PROTOCOL_ERROR, "a padded frame without its pad length")
        start, end = 1, end - payload[0]
    if f.type == HEADERS and f.flags & PRIORITY_FLAG:
        start += 5
    if start > end:
        raise ProtocolError(PROTOCOL_ERROR, "padding longer than the frame")
    return payload[start:end]


def frame_head(ftype: int, flags: int, stream_id: int, length: int) -> bytes:
    return _HEAD.pack(length >> 8, length & 0xFF, ftype, flags, stream_id)


def frame(ftype: int, flags: int, stream_id: int, payload: bytes = b"") -> bytes:
    return frame_head(ftype, flags, stream_id, len(payload)) + payload


def settings_frame(pairs: Iterable[Tuple[int, int]]) -> bytes:
    return frame(SETTINGS, 0, 0, b"".join(struct.pack(">HI", k, v) for k, v in pairs))


def window_update(stream_id: int, increment: int) -> bytes:
    return frame(WINDOW_UPDATE, 0, stream_id, struct.pack(">I", increment))


def ping(payload: bytes, ack: bool = False) -> bytes:
    return frame(PING, ACK if ack else 0, 0, payload)


def goaway(last_stream_id: int, code: int, debug: bytes = b"") -> bytes:
    return frame(GOAWAY, 0, 0, struct.pack(">II", last_stream_id, code) + debug)


def rst_stream(stream_id: int, code: int) -> bytes:
    return frame(RST_STREAM, 0, stream_id, struct.pack(">I", code))


def header_frames(stream_id: int, block: bytes, max_frame: int, end_stream: bool) -> bytes:
    """A header block as one HEADERS frame and as many CONTINUATION frames as
    ``max_frame`` requires."""
    chunks = [block[i:i + max_frame] for i in range(0, len(block), max_frame)] or [b""]
    out = []
    for i, chunk in enumerate(chunks):
        flags = END_HEADERS if i == len(chunks) - 1 else 0
        if i == 0:
            out.append(frame(HEADERS, flags | (END_STREAM if end_stream else 0), stream_id, chunk))
        else:
            out.append(frame(CONTINUATION, flags, stream_id, chunk))
    return b"".join(out)


# ---------------------------------------------------------------------------
# HPACK (RFC 7541)
# ---------------------------------------------------------------------------


class HpackError(ProtocolError):
    def __init__(self, message: str) -> None:
        super().__init__(COMPRESSION_ERROR, message)


def encode_int(value: int, prefix: int, flags: int = 0) -> bytes:
    """An integer on an N-bit prefix (section 5.1), ``flags`` in the first
    byte's high bits."""
    limit = (1 << prefix) - 1
    if value < limit:
        return bytes((flags | value,))
    out = bytearray((flags | limit,))
    value -= limit
    while value >= 128:
        out.append(value & 0x7F | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def decode_int(data: bytes, pos: int, prefix: int) -> Tuple[int, int]:
    """The integer at ``data[pos]`` on an N-bit prefix, and the position after it."""
    limit = (1 << prefix) - 1
    value = data[pos] & limit
    pos += 1
    if value < limit:
        return value, pos
    shift = 0
    while True:
        if pos >= len(data):
            raise HpackError("a truncated integer")
        byte = data[pos]
        pos += 1
        value += (byte & 0x7F) << shift
        shift += 7
        if not byte & 0x80:
            return value, pos
        if shift > 63:
            raise HpackError("an integer above 2^63")


# RFC 7541 Appendix B, the code length of each symbol 0-255 and EOS (256); the
# code is canonical: codes of one length are consecutive in symbol order, and
# each length's first code follows the last of the shorter ones
HUFFMAN_LENGTHS = (
    13, 23, 28, 28, 28, 28, 28, 28, 28, 24, 30, 28, 28, 30, 28, 28,
    28, 28, 28, 28, 28, 28, 30, 28, 28, 28, 28, 28, 28, 28, 28, 28,
    6, 10, 10, 12, 13, 6, 8, 11, 10, 10, 8, 11, 8, 6, 6, 6,
    5, 5, 5, 6, 6, 6, 6, 6, 6, 6, 7, 8, 15, 6, 12, 10,
    13, 6, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7,
    7, 7, 7, 7, 7, 7, 7, 7, 8, 7, 8, 13, 19, 13, 14, 6,
    15, 5, 6, 5, 6, 5, 6, 6, 6, 5, 7, 7, 6, 6, 6, 5,
    6, 7, 6, 5, 5, 6, 7, 7, 7, 7, 7, 15, 11, 14, 13, 28,
    20, 22, 20, 20, 22, 22, 22, 23, 22, 23, 23, 23, 23, 23, 24, 23,
    24, 24, 22, 23, 24, 23, 23, 23, 23, 21, 22, 23, 22, 23, 23, 24,
    22, 21, 20, 22, 22, 23, 23, 21, 23, 22, 22, 24, 21, 22, 23, 23,
    21, 21, 22, 21, 23, 22, 23, 23, 20, 22, 22, 22, 23, 22, 22, 23,
    26, 26, 20, 19, 22, 23, 22, 25, 26, 26, 26, 27, 27, 26, 24, 25,
    19, 21, 26, 27, 27, 26, 27, 24, 21, 21, 26, 26, 28, 27, 27, 27,
    20, 24, 20, 21, 22, 21, 21, 23, 22, 22, 25, 25, 24, 24, 26, 23,
    26, 27, 26, 26, 27, 27, 27, 27, 27, 28, 27, 27, 27, 27, 27, 26,
    30,
)
EOS = 256


def _canonical_codes(lengths) -> Tuple[int, ...]:
    codes = [0] * len(lengths)
    code, prev = -1, 0
    for sym in sorted(range(len(lengths)), key=lambda s: (lengths[s], s)):
        code = (code + 1) << (lengths[sym] - prev)
        prev = lengths[sym]
        codes[sym] = code
    return tuple(codes)


HUFFMAN_CODES = _canonical_codes(HUFFMAN_LENGTHS)
_HUFFMAN_SYMBOLS = {(HUFFMAN_LENGTHS[s], c): s for s, c in enumerate(HUFFMAN_CODES)}


def huffman_encode(data: bytes) -> bytes:
    """``data`` under the Huffman code, padded with the EOS code's high bits."""
    acc = nbits = 0
    for byte in data:
        acc = acc << HUFFMAN_LENGTHS[byte] | HUFFMAN_CODES[byte]
        nbits += HUFFMAN_LENGTHS[byte]
    pad = -nbits % 8
    return (acc << pad | (1 << pad) - 1).to_bytes((nbits + pad) // 8, "big")


def huffman_decode(data: bytes) -> bytes:
    out = bytearray()
    code = length = 0
    for byte in data:
        for shift in range(7, -1, -1):
            code = code << 1 | byte >> shift & 1
            length += 1
            sym = _HUFFMAN_SYMBOLS.get((length, code))
            if sym is not None:
                if sym == EOS:
                    raise HpackError("EOS inside a Huffman string")
                out.append(sym)
                code = length = 0
    # the padding: fewer than 8 bits, all of them ones (EOS's first bits)
    if length > 7 or code != (1 << length) - 1:
        raise HpackError("bad Huffman padding")
    return bytes(out)


def encode_string(raw: bytes, huffman: bool = False) -> bytes:
    if huffman:
        raw = huffman_encode(raw)
    return encode_int(len(raw), 7, 0x80 if huffman else 0) + raw


def decode_string(data: bytes, pos: int) -> Tuple[bytes, int]:
    huffman = data[pos] & 0x80
    length, pos = decode_int(data, pos, 7)
    if pos + length > len(data):
        raise HpackError("a truncated string literal")
    raw = data[pos:pos + length]
    return (huffman_decode(raw) if huffman else bytes(raw)), pos + length


STATIC_TABLE = (
    (":authority", ""), (":method", "GET"), (":method", "POST"), (":path", "/"),
    (":path", "/index.html"), (":scheme", "http"), (":scheme", "https"), (":status", "200"),
    (":status", "204"), (":status", "206"), (":status", "304"), (":status", "400"),
    (":status", "404"), (":status", "500"), ("accept-charset", ""),
    ("accept-encoding", "gzip, deflate"), ("accept-language", ""), ("accept-ranges", ""),
    ("accept", ""), ("access-control-allow-origin", ""), ("age", ""), ("allow", ""),
    ("authorization", ""), ("cache-control", ""), ("content-disposition", ""),
    ("content-encoding", ""), ("content-language", ""), ("content-length", ""),
    ("content-location", ""), ("content-range", ""), ("content-type", ""), ("cookie", ""),
    ("date", ""), ("etag", ""), ("expect", ""), ("expires", ""), ("from", ""), ("host", ""),
    ("if-match", ""), ("if-modified-since", ""), ("if-none-match", ""), ("if-range", ""),
    ("if-unmodified-since", ""), ("last-modified", ""), ("link", ""), ("location", ""),
    ("max-forwards", ""), ("proxy-authenticate", ""), ("proxy-authorization", ""),
    ("range", ""), ("referer", ""), ("refresh", ""), ("retry-after", ""), ("server", ""),
    ("set-cookie", ""), ("strict-transport-security", ""), ("transfer-encoding", ""),
    ("user-agent", ""), ("vary", ""), ("via", ""), ("www-authenticate", ""),
)
_STATIC_FIELD = {field: i + 1 for i, field in reversed(list(enumerate(STATIC_TABLE)))}
_STATIC_NAME = {name: i + 1 for i, (name, _) in reversed(list(enumerate(STATIC_TABLE)))}

Header = Tuple[str, str]  # names and values as latin-1 text: one character a byte


def entry_size(name: str, value: str) -> int:
    return len(name) + len(value) + 32


def header_list_size(headers: Iterable[Header]) -> int:
    return sum(entry_size(n, v) for n, v in headers)


class Decoder:
    """One connection's HPACK decoding state: the dynamic table, newest entry
    first, held to ``max_size`` octets (section 4); size updates may lower it
    to at most ``limit``, the HEADER_TABLE_SIZE this side advertised."""

    def __init__(self, limit: int = 4096) -> None:
        self.limit = self.max_size = limit
        self.size = 0
        self.table: collections.deque = collections.deque()

    def _field(self, index: int) -> Header:
        if index == 0:
            raise HpackError("index 0")
        if index <= len(STATIC_TABLE):
            return STATIC_TABLE[index - 1]
        if index - len(STATIC_TABLE) > len(self.table):
            raise HpackError(f"index {index} beyond the dynamic table")
        return self.table[index - len(STATIC_TABLE) - 1]

    def _evict(self, room: int) -> None:
        while self.table and self.size > room:
            name, value = self.table.pop()
            self.size -= entry_size(name, value)

    def _add(self, name: str, value: str) -> None:
        size = entry_size(name, value)
        self._evict(self.max_size - size)
        if size <= self.max_size:  # a larger entry empties the table and is not added
            self.table.appendleft((name, value))
            self.size += size

    def decode(self, block: bytes) -> List[Header]:
        headers: List[Header] = []
        pos, end = 0, len(block)
        while pos < end:
            byte = block[pos]
            if byte & 0x80:  # indexed field
                index, pos = decode_int(block, pos, 7)
                headers.append(self._field(index))
                continue
            if byte & 0xE0 == 0x20:  # dynamic table size update
                if headers:
                    raise HpackError("a table size update after a field")
                size, pos = decode_int(block, pos, 5)
                if size > self.limit:
                    raise HpackError(f"a table size of {size}, above {self.limit}")
                self.max_size = size
                self._evict(size)
                continue
            indexing = byte & 0x40  # with incremental indexing; else without or never
            index, pos = decode_int(block, pos, 6 if indexing else 4)
            if index:
                name = self._field(index)[0]
            else:
                raw, pos = decode_string(block, pos)
                name = raw.decode("latin-1")
            raw, pos = decode_string(block, pos)
            value = raw.decode("latin-1")
            if indexing:
                self._add(name, value)
            headers.append((name, value))
        return headers


def encode_headers(headers: Iterable[Header]) -> bytes:
    """A header block of static-table indices and raw literals without
    indexing: it leaves the peer's dynamic table as it was."""
    out = bytearray()
    for name, value in headers:
        index = _STATIC_FIELD.get((name, value))
        if index:
            out += encode_int(index, 7, 0x80)
            continue
        index = _STATIC_NAME.get(name, 0)
        out += encode_int(index, 4)
        if not index:
            out += encode_string(name.encode("latin-1"))
        out += encode_string(value.encode("latin-1"))
    return bytes(out)


# ---------------------------------------------------------------------------
# gRPC over HTTP/2
# ---------------------------------------------------------------------------


class StatusCode(enum.IntEnum):
    """gRPC's status codes, under grpcio's ``StatusCode`` names."""

    OK = 0
    CANCELLED = 1
    UNKNOWN = 2
    INVALID_ARGUMENT = 3
    DEADLINE_EXCEEDED = 4
    NOT_FOUND = 5
    ALREADY_EXISTS = 6
    PERMISSION_DENIED = 7
    RESOURCE_EXHAUSTED = 8
    FAILED_PRECONDITION = 9
    ABORTED = 10
    OUT_OF_RANGE = 11
    UNIMPLEMENTED = 12
    INTERNAL = 13
    UNAVAILABLE = 14
    DATA_LOSS = 15
    UNAUTHENTICATED = 16


class GrpcError(Exception):
    """A failed call: ``code()`` is its status (``code().name`` is grpcio's
    name for it) and ``details()`` its message, as on grpcio's ``RpcError``."""

    def __init__(self, code: StatusCode, details: str = "") -> None:
        super().__init__(f"{code.name}: {details}")
        self._code = StatusCode(code)
        self._details = details

    def code(self) -> StatusCode:
        return self._code

    def details(self) -> str:
        return self._details


MAX_MESSAGE = 4 * 1024 * 1024  # grpcio's default receive limit, on both sides
USER_AGENT = "rapid-tpu-torch-grpc/1"
ACCEPT_ENCODING = "identity, deflate, gzip"
_PREFIX = struct.Struct(">BI")  # compressed flag, length

# an RST_STREAM's error code as a call's status (gRPC over HTTP/2, "Errors")
_RST_STATUS = {REFUSED_STREAM: StatusCode.UNAVAILABLE, CANCEL: StatusCode.CANCELLED,
               ENHANCE_YOUR_CALM: StatusCode.RESOURCE_EXHAUSTED,
               INADEQUATE_SECURITY: StatusCode.PERMISSION_DENIED}
# a response's HTTP status without grpc-status (gRPC's http-grpc-status-mapping)
_HTTP_STATUS = {"400": StatusCode.INTERNAL, "401": StatusCode.UNAUTHENTICATED,
                "403": StatusCode.PERMISSION_DENIED, "404": StatusCode.UNIMPLEMENTED,
                "429": StatusCode.UNAVAILABLE, "502": StatusCode.UNAVAILABLE,
                "503": StatusCode.UNAVAILABLE, "504": StatusCode.UNAVAILABLE}
_TIMEOUT_UNITS = {"H": 3600.0, "M": 60.0, "S": 1.0, "m": 1e-3, "u": 1e-6, "n": 1e-9}


def grpc_frame(message: bytes) -> bytes:
    """One uncompressed message behind its 5-byte prefix."""
    return _PREFIX.pack(0, len(message)) + message


def message_length(data: bytes) -> Optional[int]:
    """The length a message's prefix announces, once its 5 bytes are in."""
    return _PREFIX.unpack_from(data)[1] if len(data) >= 5 else None


def parse_message(data: bytes, encoding: str = "identity") -> bytes:
    """The one message of a unary call's DATA, decompressed under
    ``encoding`` where its flag says so."""
    if len(data) < 5 or len(data) != 5 + _PREFIX.unpack_from(data)[1]:
        raise GrpcError(StatusCode.INTERNAL, f"a unary call's DATA of {len(data)} B is not "
                        "one length-prefixed message")
    flag, length = _PREFIX.unpack_from(data)
    if length > MAX_MESSAGE:
        raise too_large(length)
    body = bytes(data[5:])
    if not flag:
        return body
    wbits = {"gzip": 31, "deflate": 15}.get(encoding)
    if wbits is None:
        raise GrpcError(StatusCode.INTERNAL, f"a compressed message under grpc-encoding "
                        f"{encoding!r}")
    try:
        return zlib.decompress(body, wbits)
    except zlib.error:
        if encoding != "deflate":
            raise GrpcError(StatusCode.INTERNAL, "a gzip message that does not inflate")
    try:  # deflate without its zlib wrapper
        return zlib.decompress(body, -15)
    except zlib.error:
        raise GrpcError(StatusCode.INTERNAL, "a deflate message that does not inflate")


def too_large(length: int) -> GrpcError:
    return GrpcError(StatusCode.RESOURCE_EXHAUSTED,
                     f"Received message larger than max ({length} vs. {MAX_MESSAGE})")


def encode_timeout(seconds: float) -> str:
    """A ``grpc-timeout`` value, as grpcio's client writes one: milliseconds,
    rounded up, or the first coarser unit that holds it in 8 digits."""
    for unit, scale in (("m", 1e-3), ("S", 1.0), ("M", 60.0)):
        value = max(0, math.ceil(round(seconds / scale, 6)))
        if value < 100_000_000:
            return f"{value}{unit}"
    return f"{min(math.ceil(seconds / 3600.0), 99_999_999)}H"


def decode_timeout(value: Optional[str]) -> Optional[float]:
    if not value:
        return None
    scale = _TIMEOUT_UNITS.get(value[-1])
    if scale is None or not value[:-1].isdigit() or len(value) > 9:
        raise GrpcError(StatusCode.INTERNAL, f"an invalid grpc-timeout {value!r}")
    return int(value[:-1]) * scale


def percent_encode(text: str) -> str:
    """``grpc-message``'s encoding: UTF-8, each byte outside 0x20-0x7E and
    '%' itself as %XX."""
    return "".join(chr(b) if 0x20 <= b <= 0x7E and b != 0x25 else f"%{b:02X}"
                   for b in text.encode("utf-8"))


def percent_decode(value: str) -> str:
    raw, out, i = value.encode("latin-1"), bytearray(), 0
    while i < len(raw):
        if raw[i] == 0x25 and _is_hex(raw[i + 1:i + 3]):
            out.append(int(raw[i + 1:i + 3], 16))
            i += 3
        else:
            out.append(raw[i])
            i += 1
    return out.decode("utf-8", "replace")


def _is_hex(pair: bytes) -> bool:
    return len(pair) == 2 and all(c in b"0123456789abcdefABCDEF" for c in pair)


def request_headers(path: str, authority: str, timeout_s: Optional[float]) -> List[Header]:
    """A unary call's request headers: the fields grpcio's client sends, in
    its order."""
    headers = [(":path", path), (":authority", authority), (":method", "POST"),
               (":scheme", "http"), ("content-type", "application/grpc"), ("te", "trailers"),
               ("grpc-accept-encoding", ACCEPT_ENCODING)]
    if timeout_s is not None:
        headers.append(("grpc-timeout", encode_timeout(timeout_s)))
    headers.append(("user-agent", USER_AGENT))
    return headers


# a response's headers, and a trailers-only reply's before its trailers, as
# grpcio's server sends them
RESPONSE_HEADERS: List[Header] = [(":status", "200"), ("content-type", "application/grpc"),
                                  ("grpc-accept-encoding", ACCEPT_ENCODING)]
TRAILERS_ONLY_HEADERS: List[Header] = RESPONSE_HEADERS[:2]


def trailers(code: StatusCode, details: str = "") -> List[Header]:
    return [("grpc-status", str(int(code))), ("grpc-message", percent_encode(details))]


def response_status(headers: List[Header],
                    trailer_fields: Optional[List[Header]]) -> Tuple[StatusCode, str]:
    """The status a response ends with, OK included, and its message: from
    its trailers or, trailers-only, from its headers."""
    fields = dict(trailer_fields if trailer_fields is not None else headers)
    status = dict(headers).get(":status")
    if status != "200" and "grpc-status" not in fields:
        return (_HTTP_STATUS.get(status, StatusCode.UNKNOWN),
                f"Received http2 header with status: {status}")
    code = fields.get("grpc-status", "")
    if not code.isdigit():
        return StatusCode.UNKNOWN, "a response without grpc-status"
    known = int(code) in StatusCode._value2member_map_
    return (StatusCode(int(code)) if known else StatusCode.UNKNOWN,
            percent_decode(fields.get("grpc-message", "")))


# ---------------------------------------------------------------------------
# a connection
# ---------------------------------------------------------------------------


class Stream:
    """One stream's state on its connection."""

    __slots__ = ("id", "headers", "trailers", "data", "send_window", "recv_window",
                 "ended", "reset", "too_large", "error", "done", "task")

    def __init__(self, stream_id: int, send_window: int, done: asyncio.Future) -> None:
        self.id = stream_id
        self.headers: Optional[List[Header]] = None
        self.trailers: Optional[List[Header]] = None
        self.data = bytearray()
        self.send_window = send_window
        self.recv_window = WINDOW
        self.ended = False  # the peer's END_STREAM arrived
        self.reset = False  # the peer's RST_STREAM arrived: send nothing more
        self.too_large = 0  # the length of a message above MAX_MESSAGE, once announced
        self.error: Optional[GrpcError] = None
        self.done = done  # resolved once the peer ended the stream, reset it or left
        self.task: Optional[asyncio.Task] = None  # the server's handler

    def finish(self, error: Optional[GrpcError] = None) -> None:
        if error is not None and self.error is None:
            self.error = error
        if not self.done.done():
            self.done.set_result(None)
        if error is not None and self.task is not None:
            self.task.cancel()


class Connection:
    """One HTTP/2 connection, client or server side, run by the asyncio loop
    that calls ``start``; every method runs on that loop's thread.

    ``stats`` counts frames by type and direction (``"DATA out"``), the
    times a sender found a window spent (``"stalls"``), and whatever its
    owner adds. On the server side, ``on_request(connection, stream)`` is
    called once a request stream has ended, or has announced a message above
    ``MAX_MESSAGE`` (its ``too_large`` then holds the announced length)."""

    READ_SIZE = 256 * 1024

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                 client: bool, on_request: Optional[Callable] = None,
                 stats: Optional[collections.Counter] = None) -> None:
        self._reader, self._writer = reader, writer
        self.client = client
        self._on_request = on_request
        self.stats = stats if stats is not None else collections.Counter()
        self._frames = FrameReader(WINDOW)
        self._decoder = Decoder()
        self.streams: Dict[int, Stream] = {}
        self._next_id = 1
        self._last_peer_id = 0
        self.peer: Dict[int, Optional[int]] = dict(DEFAULT_SETTINGS)
        self._send_window = DEFAULT_WINDOW
        self._recv_window = WINDOW
        self._window_open = asyncio.Event()
        self._block: Optional[Tuple[int, bool, bytearray]] = None  # awaiting CONTINUATION
        self.goaway_id: Optional[int] = None  # the last stream the peer will process
        self._goaway_sent = False
        self.closed = False
        self._task: Optional[asyncio.Task] = None
        self.on_close: Optional[Callable[["Connection"], None]] = None

    # -- life ---------------------------------------------------------------

    def start(self) -> None:
        settings = CLIENT_SETTINGS if self.client else SERVER_SETTINGS
        self._write((PREFACE if self.client else b"") + settings_frame(settings)
                    + window_update(0, WINDOW - DEFAULT_WINDOW), "SETTINGS", "WINDOW_UPDATE")
        self._task = asyncio.get_running_loop().create_task(self._run())

    def usable(self) -> bool:
        """Whether a new stream may open here (a client's question)."""
        return not self.closed and self.goaway_id is None and self._next_id <= MAX_STREAM_ID

    def idle(self) -> bool:
        return not self.streams

    async def _run(self) -> None:
        error: Optional[BaseException] = None
        try:
            if not self.client and await self._reader.readexactly(len(PREFACE)) != PREFACE:
                raise ProtocolError(PROTOCOL_ERROR, "no HTTP/2 connection preface")
            while True:
                data = await self._reader.read(self.READ_SIZE)
                if not data:
                    break
                for f in self._frames.feed(data):
                    self._on_frame(f)
        except ProtocolError as e:
            error = e
            self._write(goaway(self._last_peer_id, e.code, str(e).encode()), "GOAWAY")
            self._goaway_sent = True
        except (ConnectionError, OSError, asyncio.IncompleteReadError) as e:
            error = e
        finally:
            self._lost(error)

    def goaway(self) -> None:
        """Tell the peer no stream above those it opened will be processed;
        later ones are refused."""
        if not self.closed and not self._goaway_sent:
            self._goaway_sent = True
            self._write(goaway(self._last_peer_id, NO_ERROR), "GOAWAY")

    def close(self, status: StatusCode = StatusCode.UNAVAILABLE, why: str = "") -> None:
        """GOAWAY, then close; streams still open fail with ``status``."""
        if self.closed:
            return
        self.goaway()
        self._lost(None, GrpcError(status, why or "the connection was closed"))
        if self._task is not None:
            self._task.cancel()

    def _lost(self, error: Optional[BaseException], failure: Optional[GrpcError] = None) -> None:
        if self.closed:
            return
        self.closed = True
        if failure is None:
            failure = GrpcError(StatusCode.UNAVAILABLE, "the connection was lost" + (
                f": {error}" if error is not None else ""))
        streams, self.streams = list(self.streams.values()), {}
        for stream in streams:
            stream.finish(failure)
        self._window_open.set()
        self._writer.close()
        if self.on_close is not None:
            self.on_close(self)

    def _write(self, data: bytes, *names: str) -> None:
        if not self.closed:
            self._writer.write(data)
            for name in names:
                self.stats[f"{name} out"] += 1

    # -- frames in ------------------------------------------------------------

    def _on_frame(self, f: Frame) -> None:
        name = FRAME_NAMES[f.type] if f.type < len(FRAME_NAMES) else "unknown"
        self.stats[f"{name} in"] += 1
        if self._block is not None and (f.type != CONTINUATION or f.stream_id != self._block[0]):
            raise ProtocolError(PROTOCOL_ERROR, "a header block interrupted")
        handler = _HANDLERS.get(f.type)
        if handler is not None:  # unknown frame types are ignored (section 4.1)
            handler(self, f)

    def _on_data(self, f: Frame) -> None:
        if f.stream_id == 0:
            raise ProtocolError(PROTOCOL_ERROR, "DATA on stream 0")
        self._recv_window -= len(f.payload)
        if self._recv_window < 0:
            raise ProtocolError(FLOW_CONTROL_ERROR, "DATA past the connection window")
        if self._recv_window <= WINDOW // 2:  # grant what was consumed
            self._write(window_update(0, WINDOW - self._recv_window), "WINDOW_UPDATE")
            self._recv_window = WINDOW
        stream = self.streams.get(f.stream_id)
        if stream is None or stream.ended or stream.too_large:
            return  # a stream this side reset, finished or refused: counted, dropped
        body = frame_body(f)
        stream.recv_window -= len(f.payload)
        if stream.recv_window < 0:
            raise ProtocolError(FLOW_CONTROL_ERROR, "DATA past a stream's window")
        stream.data += body
        length = message_length(stream.data)
        if length is not None and length > MAX_MESSAGE:
            self._refuse_large(stream, length)
            return
        if f.flags & END_STREAM:
            self._remote_end(stream)
        elif stream.recv_window <= WINDOW // 2:
            self._write(window_update(stream.id, WINDOW - stream.recv_window), "WINDOW_UPDATE")
            stream.recv_window = WINDOW

    def _refuse_large(self, stream: Stream, length: int) -> None:
        """A message above MAX_MESSAGE: the client fails its call, the server
        answers it; either side stops the stream."""
        stream.data = bytearray()
        stream.too_large = length
        if self.client:
            self.reset(stream, CANCEL)
            stream.finish(too_large(length))
        else:
            self._on_request(self, stream)

    def _on_headers(self, f: Frame) -> None:
        if f.stream_id == 0:
            raise ProtocolError(PROTOCOL_ERROR, "HEADERS on stream 0")
        body = frame_body(f)
        if f.flags & END_HEADERS:
            self._on_header_block(f.stream_id, bool(f.flags & END_STREAM), body)
        else:
            self._block = (f.stream_id, bool(f.flags & END_STREAM), bytearray(body))

    def _on_continuation(self, f: Frame) -> None:
        if self._block is None:
            raise ProtocolError(PROTOCOL_ERROR, "CONTINUATION without HEADERS")
        self._block[2].extend(f.payload)
        if f.flags & END_HEADERS:
            stream_id, end_stream, block = self._block
            self._block = None
            self._on_header_block(stream_id, end_stream, bytes(block))

    def _on_header_block(self, stream_id: int, end_stream: bool, block: bytes) -> None:
        headers = self._decoder.decode(block)  # always, in arrival order: the table moves
        stream = self.streams.get(stream_id)
        if stream is None:
            if self.client or stream_id % 2 == 0 or stream_id <= self._last_peer_id:
                return  # a stream this side reset or finished
            if self._goaway_sent:
                self._write(rst_stream(stream_id, REFUSED_STREAM), "RST_STREAM")
                return
            self._last_peer_id = stream_id
            stream = self._new_stream(stream_id)
            stream.headers = headers
        elif stream.headers is None:
            stream.headers = headers
        else:
            stream.trailers = headers
        if end_stream:
            self._remote_end(stream)

    def _remote_end(self, stream: Stream) -> None:
        stream.ended = True
        if self.client:
            stream.finish()
            self._window_open.set()  # a request still sending stops: it is answered
        else:
            self._on_request(self, stream)

    def _on_rst_stream(self, f: Frame) -> None:
        if len(f.payload) != 4:
            raise ProtocolError(FRAME_SIZE_ERROR, "RST_STREAM of the wrong size")
        stream = self.streams.pop(f.stream_id, None)
        if stream is not None:
            (code,) = struct.unpack(">I", f.payload)
            stream.reset = True
            # a server's reset after its END_STREAM only stops the client
            # sending (it answered before the request's end, gRPC over
            # HTTP/2); a client's reset cancels the server's handler
            stream.finish(None if self.client and stream.ended else GrpcError(
                _RST_STATUS.get(code, StatusCode.INTERNAL),
                f"the peer reset the stream (HTTP/2 error {code})"))
            self._window_open.set()

    def _on_settings(self, f: Frame) -> None:
        if f.stream_id:
            raise ProtocolError(PROTOCOL_ERROR, "SETTINGS on a stream")
        if f.flags & ACK:
            return
        if len(f.payload) % 6:
            raise ProtocolError(FRAME_SIZE_ERROR, "SETTINGS of the wrong size")
        for i in range(0, len(f.payload), 6):
            ident, value = struct.unpack_from(">HI", f.payload, i)
            if ident == INITIAL_WINDOW_SIZE:
                if value > MAX_WINDOW:
                    raise ProtocolError(FLOW_CONTROL_ERROR, "INITIAL_WINDOW_SIZE above 2^31-1")
                delta = value - self.peer[INITIAL_WINDOW_SIZE]
                for stream in self.streams.values():
                    stream.send_window += delta
            elif ident == MAX_FRAME_SIZE and not DEFAULT_MAX_FRAME <= value < 1 << 24:
                raise ProtocolError(PROTOCOL_ERROR, f"MAX_FRAME_SIZE {value}")
            elif ident == ENABLE_PUSH and value > 1:
                raise ProtocolError(PROTOCOL_ERROR, f"ENABLE_PUSH {value}")
            if ident in self.peer:  # unknown ids (grpcio's 0xfe03) are ignored
                self.peer[ident] = value
        self._write(frame(SETTINGS, ACK, 0), "SETTINGS")
        self._window_open.set()

    def _on_ping(self, f: Frame) -> None:
        if f.stream_id or len(f.payload) != 8:
            raise ProtocolError(FRAME_SIZE_ERROR if f.stream_id == 0 else PROTOCOL_ERROR,
                                "a malformed PING")
        if not f.flags & ACK:
            self._write(ping(f.payload, ack=True), "PING")

    def _on_goaway(self, f: Frame) -> None:
        last, code = struct.unpack_from(">II", f.payload)
        self.goaway_id = last & MAX_STREAM_ID
        for stream_id in [s for s in self.streams if s > self.goaway_id and self.client]:
            self.streams.pop(stream_id).finish(GrpcError(
                StatusCode.UNAVAILABLE, f"the peer sent GOAWAY (HTTP/2 error {code}) before "
                "processing the stream"))
        self._window_open.set()
        self._close_if_drained()

    def _close_if_drained(self) -> None:
        """A client's connection that the peer sent GOAWAY closes once its
        last stream is over (new calls dial another)."""
        if self.client and self.goaway_id is not None and not self.streams:
            self.close(StatusCode.UNAVAILABLE, "the peer sent GOAWAY")

    def _on_window_update(self, f: Frame) -> None:
        if len(f.payload) != 4:
            raise ProtocolError(FRAME_SIZE_ERROR, "WINDOW_UPDATE of the wrong size")
        increment = struct.unpack(">I", f.payload)[0] & MAX_WINDOW
        if increment == 0:
            raise ProtocolError(PROTOCOL_ERROR, "a WINDOW_UPDATE of 0")
        if f.stream_id == 0:
            self._send_window += increment
            if self._send_window > MAX_WINDOW:
                raise ProtocolError(FLOW_CONTROL_ERROR, "the connection window above 2^31-1")
        else:
            stream = self.streams.get(f.stream_id)
            if stream is None:
                return
            stream.send_window += increment
        self._window_open.set()

    def _on_push_promise(self, f: Frame) -> None:
        raise ProtocolError(PROTOCOL_ERROR, "PUSH_PROMISE, with push disabled")

    # -- frames out -----------------------------------------------------------

    def _new_stream(self, stream_id: int) -> Stream:
        stream = Stream(stream_id, self.peer[INITIAL_WINDOW_SIZE],
                        asyncio.get_running_loop().create_future())
        self.streams[stream_id] = stream
        return stream

    def open_stream(self) -> Stream:
        if not self.usable():
            raise GrpcError(StatusCode.UNAVAILABLE, "the connection takes no new stream")
        stream_id, self._next_id = self._next_id, self._next_id + 2
        return self._new_stream(stream_id)

    def send_headers(self, stream: Stream, headers: List[Header], end_stream: bool = False) -> None:
        """A header block, its grpc-message cut to the peer's
        MAX_HEADER_LIST_SIZE where the list would exceed it."""
        if stream.error is not None:
            raise stream.error
        limit = self.peer[MAX_HEADER_LIST_SIZE]
        if limit is not None and header_list_size(headers) > limit:
            over = header_list_size(headers) - limit
            headers = [(n, v[:max(0, len(v) - over)] if n == "grpc-message" else v)
                       for n, v in headers]
        self._write(header_frames(stream.id, encode_headers(headers), self.peer[MAX_FRAME_SIZE],
                                  end_stream), "HEADERS")

    async def send_data(self, stream: Stream, data: bytes, end_stream: bool) -> None:
        """``data`` in DATA frames no larger than the peer's MAX_FRAME_SIZE,
        never past the stream's or the connection's window: where one is
        spent, wait for the peer's WINDOW_UPDATE. A client stops once the
        server has ended or reset the stream: the call is answered."""
        view, pos, total = memoryview(data), 0, len(data)
        while True:
            if stream.error is not None:
                raise stream.error
            if stream.reset or self.client and stream.ended:
                return
            if self.closed:
                raise GrpcError(StatusCode.UNAVAILABLE, "the connection was closed")
            n = min(total - pos, self._send_window, stream.send_window, self.peer[MAX_FRAME_SIZE])
            if n <= 0 and pos < total:
                self.stats["stalls"] += 1
                self._window_open.clear()
                await self._window_open.wait()
                continue
            last = pos + n == total
            self._write(frame_head(DATA, END_STREAM if last and end_stream else 0, stream.id, n),
                        "DATA")
            self._write(view[pos:pos + n])
            self._send_window -= n
            stream.send_window -= n
            pos += n
            try:
                await self._writer.drain()
            except (ConnectionError, OSError) as e:
                self._lost(e)
            if last:
                return

    def reset(self, stream: Stream, code: int) -> None:
        """RST_STREAM, where the stream is still open here."""
        if self.streams.pop(stream.id, None) is not None:
            self._write(rst_stream(stream.id, code), "RST_STREAM")

    def release(self, stream: Stream) -> None:
        """A client's stream once its call is over: reset if the peer has not
        ended it."""
        if stream.ended:
            self.streams.pop(stream.id, None)
        else:
            self.reset(stream, CANCEL)
        self._close_if_drained()

    def respond(self, stream: Stream, headers: List[Header]) -> None:
        """A server's last header block (trailers, or a trailers-only reply):
        the stream is over here, and reset with NO_ERROR if the client is
        still sending (gRPC over HTTP/2, "Responses")."""
        self.send_headers(stream, headers, end_stream=True)
        if self.streams.pop(stream.id, None) is not None and not stream.ended:
            self._write(rst_stream(stream.id, NO_ERROR), "RST_STREAM")


_HANDLERS = {DATA: Connection._on_data, HEADERS: Connection._on_headers,
             RST_STREAM: Connection._on_rst_stream, SETTINGS: Connection._on_settings,
             PUSH_PROMISE: Connection._on_push_promise, PING: Connection._on_ping,
             GOAWAY: Connection._on_goaway, WINDOW_UPDATE: Connection._on_window_update,
             CONTINUATION: Connection._on_continuation}
