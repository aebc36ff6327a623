"""The MessagePack subset the wire codec speaks, in pure Python.

``packb(obj)`` gives, byte for byte, what ``msgpack.packb(obj,
use_bin_type=True)`` gives (msgpack-python 1.1) for every value of the
subset ``messaging/codec.py`` builds, and ``unpackb(data)`` what
``msgpack.unpackb(data, raw=False)`` gives back:

- ``None``, ``bool`` (tested before ``int``: a bool is an int);
- ``int`` from -2**63 to 2**64 - 1, each in the smallest format (positive
  fixint, uint8/16/32/64; negative fixint, int8/16/32/64);
- ``float``, always float64 (``0xcb``);
- ``str`` as UTF-8 in fixstr/str8/str16/str32;
- ``bytes``, ``bytearray`` and ``memoryview`` as bin8/bin16/bin32;
- ``list`` and ``tuple`` as arrays (fixarray/array16/array32), read back
  as lists;
- ``dict`` as maps (fixmap/map16/map32) in insertion order; read back, a
  key must be ``str`` or ``bytes`` (``strict_map_key``).

Subclasses of those types pack as their base type, as the library's
non-strict packer does. Any other type raises ``TypeError``, an int out of
range ``OverflowError``, a string with lone surrogates
``UnicodeEncodeError``. Invalid, truncated or trailing input raises
``ValueError`` (bad UTF-8: ``UnicodeDecodeError``, a ``ValueError``); so do
the formats outside the subset (ext, timestamps, the reserved ``0xc1``).

Two paths are specialised because a swarm's frames are long lists of
endpoints and identifiers (a 100k-member ``JoinResponse``, a decision's
vote batch): an array element of one of the codec's pair forms
(``{"__ep": [host, port]}``, ``{"__id": [high, low]}``, ``{"__rk": [round,
index]}``) whose values are ints or short ``bytes`` packs and unpacks
through a precomputed prefix instead of the general walk. Each element is
checked for the exact form first, and what does not match takes the
general path, so the bytes and values are the same either way.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, Dict, List, Tuple

_B = struct.Struct(">B")
_H = struct.Struct(">H")
_I = struct.Struct(">I")
_Q = struct.Struct(">Q")
_b = struct.Struct(">b")
_h = struct.Struct(">h")
_i = struct.Struct(">i")
_q = struct.Struct(">q")
_d = struct.Struct(">d")
_f = struct.Struct(">f")

_NIL, _FALSE, _TRUE = b"\xc0", b"\xc2", b"\xc3"
_FIXINT = [bytes((i,)) for i in range(256)]  # positive and negative fixints
_FIXSTR = [bytes((0xA0 | n,)) for n in range(32)]
_CACHE_CAP = 4096
_STR_CACHE: Dict[str, bytes] = {}  # short str -> its packed bytes
_KEY_CACHE: Dict[bytes, str] = {}  # packed fixstr -> str
# The codec's pair forms {"__ep": [host, port]}, {"__id": [high, low]} and
# {"__rk": [round, index]}: fixmap(1), fixstr(4) key, fixarray(2)
_PAIR_KEYS = ("__ep", "__id", "__rk")
_PAIR_PREFIX = {key: b"\x81\xa4" + key.encode() + b"\x92" for key in _PAIR_KEYS}
_PAIR_OF_PREFIX = {prefix: key for key, prefix in _PAIR_PREFIX.items()}
_PAIR_LEN = len(_PAIR_PREFIX["__ep"])


def _int_bytes(x: int) -> bytes:
    """An int in the smallest of the formats the library picks."""
    if x >= 0:
        if x < 0x80:
            return _FIXINT[x]
        if x <= 0xFF:
            return b"\xcc" + _B.pack(x)
        if x <= 0xFFFF:
            return b"\xcd" + _H.pack(x)
        if x <= 0xFFFFFFFF:
            return b"\xce" + _I.pack(x)
        if x <= 0xFFFFFFFFFFFFFFFF:
            return b"\xcf" + _Q.pack(x)
        raise OverflowError("Integer value out of range")
    if x >= -32:
        return _FIXINT[x & 0xFF]
    if x >= -0x80:
        return b"\xd0" + _b.pack(x)
    if x >= -0x8000:
        return b"\xd1" + _h.pack(x)
    if x >= -0x80000000:
        return b"\xd2" + _i.pack(x)
    if x >= -0x8000000000000000:
        return b"\xd3" + _q.pack(x)
    raise OverflowError("Integer value out of range")


def _pack_bin(data, out: bytearray) -> None:
    n = len(data)
    if n <= 0xFF:
        out += b"\xc4" + _B.pack(n)
    elif n <= 0xFFFF:
        out += b"\xc5" + _H.pack(n)
    elif n <= 0xFFFFFFFF:
        out += b"\xc6" + _I.pack(n)
    else:
        raise ValueError("bin is too large")
    out += data


def _str_bytes(s: str) -> bytes:
    data = s.encode("utf-8")
    n = len(data)
    if n < 32:
        return _FIXSTR[n] + data
    if n <= 0xFF:
        return b"\xd9" + _B.pack(n) + data
    if n <= 0xFFFF:
        return b"\xda" + _H.pack(n) + data
    if n <= 0xFFFFFFFF:
        return b"\xdb" + _I.pack(n) + data
    raise ValueError("str is too large")


def _short_str_bytes(s: str) -> bytes:
    """``_str_bytes`` through a bounded cache: a frame repeats the same few
    field names (map keys) and enum names thousands of times."""
    got = _STR_CACHE.get(s)
    if got is None:
        got = _str_bytes(s)
        if len(s) <= 32:
            if len(_STR_CACHE) >= _CACHE_CAP:
                _STR_CACHE.clear()
            _STR_CACHE[s] = got
    return got


def _pack_header(n: int, small: int, small_max: int, code16: bytes, code32: bytes,
                 out: bytearray) -> None:
    if n < small_max:
        out.append(small | n)
    elif n <= 0xFFFF:
        out += code16 + _H.pack(n)
    elif n <= 0xFFFFFFFF:
        out += code32 + _I.pack(n)
    else:
        raise ValueError("container is too large")


def _pair_value(v) -> bytes:
    if type(v) is int:
        return _int_bytes(v)
    if type(v) is bytes and len(v) <= 0xFF:
        return b"\xc4" + _FIXINT[len(v)] + v
    return b""


def _packed_pair(item: dict) -> bytes:
    """The bytes of a pair form whose two values are ints or short
    ``bytes``, else ``b""`` (the general path packs it)."""
    if len(item) != 1:
        return b""
    ((key, value),) = item.items()
    prefix = _PAIR_PREFIX.get(key)
    if prefix is None or type(value) is not list or len(value) != 2:
        return b""
    first, second = _pair_value(value[0]), _pair_value(value[1])
    if not first or not second:
        return b""
    return prefix + first + second


def _pack(obj: Any, out: bytearray, depth: int) -> None:
    if depth > 511:
        raise ValueError("recursion limit exceeded")
    t = type(obj)
    # exact types first (the codec's values), subclasses after
    if t is int:
        if 0 <= obj < 0x80:
            out.append(obj)
        else:
            out += _int_bytes(obj)
    elif t is str:
        out += _short_str_bytes(obj)
    elif t is dict:
        _pack_header(len(obj), 0x80, 16, b"\xde", b"\xdf", out)
        for key, value in obj.items():
            if type(key) is str:
                out += _short_str_bytes(key)
            else:
                _pack(key, out, depth + 1)
            tv = type(value)
            if tv is int and 0 <= value < 0x80:
                out.append(value)
                continue
            if tv is dict:
                fast = _packed_pair(value)
                if fast:
                    out += fast
                    continue
            _pack(value, out, depth + 1)
    elif t is list or t is tuple:
        _pack_header(len(obj), 0x90, 16, b"\xdc", b"\xdd", out)
        for item in obj:
            ti = type(item)
            if ti is int and 0 <= item < 0x80:
                out.append(item)
                continue
            if ti is dict:
                fast = _packed_pair(item)
                if fast:
                    out += fast
                    continue
            _pack(item, out, depth + 1)
    elif obj is None:
        out += _NIL
    elif obj is True:
        out += _TRUE
    elif obj is False:
        out += _FALSE
    elif t is bytes:
        _pack_bin(obj, out)
    elif isinstance(obj, int):
        out += _int_bytes(int(obj))
    elif isinstance(obj, float):
        out += b"\xcb" + _d.pack(obj)
    elif isinstance(obj, (bytes, bytearray)):
        _pack_bin(obj, out)
    elif isinstance(obj, str):
        out += _str_bytes(str(obj))
    elif isinstance(obj, dict):
        _pack(dict(obj), out, depth)
    elif isinstance(obj, (list, tuple)):
        _pack(list(obj), out, depth)
    elif isinstance(obj, memoryview):
        _pack_bin(obj.tobytes(), out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)``, for the subset above."""
    out = bytearray()
    _pack(obj, out, 0)
    return bytes(out)


# --------------------------------------------------------------------------- #
# unpacking
# --------------------------------------------------------------------------- #


class _Reader:
    """A cursor over the input; every read checks that the input holds it."""

    __slots__ = ("data", "pos", "end")

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0
        self.end = len(data)

    def take(self, n: int) -> int:
        """The start of the next ``n`` bytes, which it skips."""
        start = self.pos
        stop = start + n
        if stop > self.end:
            raise ValueError("Unpack failed: incomplete input")
        self.pos = stop
        return start


def _read_str(r: _Reader, n: int) -> str:
    start = r.take(n)
    return r.data[start:start + n].decode("utf-8")


def _read_bin(r: _Reader, n: int) -> bytes:
    start = r.take(n)
    return r.data[start:start + n]


def _scalar_at(data: bytes, pos: int, end: int):
    """(value, next position) of an int or bin8 at ``pos``, or None for any
    other format or a truncated one (the general path then reads it)."""
    if pos >= end:
        return None
    code = data[pos]
    if code < 0x80:
        return code, pos + 1
    if code >= 0xE0:
        return code - 0x100, pos + 1
    fmt = _SCALAR.get(code)
    if fmt is None:
        if code == 0xC4 and pos + 1 < end:
            stop = pos + 2 + data[pos + 1]
            if stop <= end:
                return data[pos + 2:stop], stop
        return None
    stop = pos + 1 + fmt.size
    if stop > end:
        return None
    return fmt.unpack_from(data, pos + 1)[0], stop


def _pair_at(data: bytes, pos: int, end: int):
    """(pair form, next position) of a pair form at ``pos`` whose values
    are ints or bin8, or None (the general path then reads it)."""
    key = _PAIR_OF_PREFIX.get(data[pos:pos + _PAIR_LEN])
    if key is None:
        return None
    first = _scalar_at(data, pos + _PAIR_LEN, end)
    if first is None:
        return None
    second = _scalar_at(data, first[1], end)
    if second is None:
        return None
    return {key: [first[0], second[0]]}, second[1]


def _read_array(r: _Reader, n: int, depth: int) -> list:
    out: List[Any] = []
    append = out.append
    data, end = r.data, r.end
    for _ in range(n):
        pos = r.pos
        if pos < end:
            code = data[pos]
            if code < 0x80:  # positive fixint, inline
                r.pos = pos + 1
                append(code)
                continue
            if code == 0x81:
                pair = _pair_at(data, pos, end)
                if pair is not None:
                    append(pair[0])
                    r.pos = pair[1]
                    continue
        append(_unpack(r, depth + 1))
    return out


def _read_map(r: _Reader, n: int, depth: int) -> dict:
    out: Dict[Any, Any] = {}
    data, end = r.data, r.end
    for _ in range(n):
        pos = r.pos
        code = data[pos] if pos < end else -1
        if 0xA0 <= code < 0xC0 and pos + 1 + (code & 0x1F) <= end:
            # a fixstr key, through the cache: field names repeat
            stop = pos + 1 + (code & 0x1F)
            raw = data[pos:stop]
            key = _KEY_CACHE.get(raw)
            if key is None:
                key = raw[1:].decode("utf-8")
                if len(_KEY_CACHE) >= _CACHE_CAP:
                    _KEY_CACHE.clear()
                _KEY_CACHE[raw] = key
            r.pos = pos = stop
        else:
            key = _unpack(r, depth + 1)
            if type(key) is not str and type(key) is not bytes:
                raise ValueError(
                    f"{type(key).__name__} is not allowed for map key when strict_map_key=True")
            pos = r.pos
        code = data[pos] if pos < end else -1
        if 0 <= code < 0x80:
            r.pos = pos + 1
            out[key] = code
            continue
        if code == 0x81:
            pair = _pair_at(data, pos, end)
            if pair is not None:
                out[key] = pair[0]
                r.pos = pair[1]
                continue
        out[key] = _unpack(r, depth + 1)
    return out


def _fixed(fmt: struct.Struct) -> Callable[[_Reader, int], Any]:
    def read(r: _Reader, depth: int) -> Any:
        return fmt.unpack_from(r.data, r.take(fmt.size))[0]
    return read


def _sized(size: struct.Struct, body: Callable[..., Any], nested: bool = False):
    def read(r: _Reader, depth: int) -> Any:
        n = size.unpack_from(r.data, r.take(size.size))[0]
        return body(r, n, depth) if nested else body(r, n)
    return read


def _unsupported(r: _Reader, depth: int) -> Any:
    raise ValueError(f"Unpack failed: format 0x{r.data[r.pos - 1]:02x} is outside the subset")


_SCALAR = {0xCC: _B, 0xCD: _H, 0xCE: _I, 0xCF: _Q, 0xD0: _b, 0xD1: _h, 0xD2: _i, 0xD3: _q}

_READ: Dict[int, Callable[[_Reader, int], Any]] = {
    0xC0: lambda r, d: None,
    0xC2: lambda r, d: False,
    0xC3: lambda r, d: True,
    0xC4: _sized(_B, _read_bin), 0xC5: _sized(_H, _read_bin), 0xC6: _sized(_I, _read_bin),
    0xCA: _fixed(_f), 0xCB: _fixed(_d),
    0xCC: _fixed(_B), 0xCD: _fixed(_H), 0xCE: _fixed(_I), 0xCF: _fixed(_Q),
    0xD0: _fixed(_b), 0xD1: _fixed(_h), 0xD2: _fixed(_i), 0xD3: _fixed(_q),
    0xD9: _sized(_B, _read_str), 0xDA: _sized(_H, _read_str), 0xDB: _sized(_I, _read_str),
    0xDC: _sized(_H, _read_array, True), 0xDD: _sized(_I, _read_array, True),
    0xDE: _sized(_H, _read_map, True), 0xDF: _sized(_I, _read_map, True),
}


def _unpack(r: _Reader, depth: int) -> Any:
    if depth > 511:
        raise ValueError("Unpack failed: nesting too deep")
    code = r.data[r.take(1)]
    if code < 0x80:
        return code
    if code >= 0xE0:
        return code - 0x100
    if code < 0x90:
        return _read_map(r, code & 0x0F, depth)
    if code < 0xA0:
        return _read_array(r, code & 0x0F, depth)
    if code < 0xC0:
        return _read_str(r, code & 0x1F)
    return _READ.get(code, _unsupported)(r, depth)


def unpackb(data) -> Any:
    """``msgpack.unpackb(data, raw=False)``, for the subset above. ``data``
    is any bytes-like object (the transport hands frames over as
    ``memoryview`` slices)."""
    r = _Reader(bytes(data))
    out = _unpack(r, 0)
    if r.pos != r.end:
        raise ValueError("unpack(b) received extra data.")
    return out


__all__: Tuple[str, ...] = ("packb", "unpackb")
