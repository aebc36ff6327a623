"""A pure-Python proto3 encoder and decoder over the port's wire schema.

The port's counterpart of the protobuf message classes the JAX package
compiles from ``wire_schema.py``, as ``msgpack_wire.py`` is for msgpack: no
``google.protobuf`` import. A message is a dict keyed by the schema's field
names; a key that is present is a field that is set.

- Scalars (``int32``, ``int64``, enums, ``string``, ``bytes``) at their
  default (0, empty) are left out, as proto3 does. A sub-message that is
  present is written even when it is empty, as protobuf writes one that a
  conversion set (``CopyFrom``, ``SetInParent`` or a field assignment).
- Known fields go out in field-number order, so fields outside the oneof
  (``traceCtx`` 15, ``hlc`` 18) interleave with the oneof member by number.
- Repeated ``int32``, ``int64`` and enum fields are packed; repeated strings,
  bytes and messages take one record each.
- A negative ``int32``, ``int64`` or enum is a 10-byte varint (its 64-bit
  two's complement); an ``int32`` or ``int64`` out of its range raises
  ``ValueError``, as protobuf's field assignment does.
- A map entry (``Metadata.MetadataEntry``) writes its key and value even at
  their defaults; ``map_entries`` orders a map's entries as protobuf's
  deterministic serializer does.

The decoder accepts repeated scalars packed and unpacked, keeps the last
value of a repeated singular scalar, merges repeated singular messages,
clears the other members of a oneof when one arrives, and skips unknown
fields of every wire type (groups included). A truncated or malformed frame
raises ``ValueError``.

    data = encode("RapidRequest", {"probeMessage": {"sender": {"port": 1}}})
    decode("RapidRequest", data)
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Iterable, List, NamedTuple, Optional, Tuple

from .wire_schema import (
    _MAPS,
    _MESSAGES,
    _REQUEST_ONEOF,
    _RESPONSE_ONEOF,
    HLC_FIELD_NUMBER,
    METADATA_ENTRY,
    TRACE_CTX_FIELD_NUMBER,
)

VARINT, FIXED64, LENGTH, START_GROUP, END_GROUP, FIXED32 = 0, 1, 2, 3, 4, 5
_VARINT_KINDS = ("int32", "int64", "enum")
_BOUNDS = {"int32": (-(1 << 31), 1 << 31), "int64": (-(1 << 63), 1 << 63),
           "enum": (-(1 << 31), 1 << 31)}


class Field(NamedTuple):
    name: str
    number: int
    kind: str  # "int32", "int64", "enum", "string", "bytes" or "message"
    repeated: bool
    message: Optional[str]  # the message type of a "message" field
    oneof: bool
    tag: bytes  # the field's key as written: packed (length) for repeated varints


def _varint(value: int) -> bytes:
    if 0 <= value < 0x80:
        return _SMALL[value]
    value &= 0xFFFF_FFFF_FFFF_FFFF
    out = bytearray()
    while value > 0x7F:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


_SMALL = [bytes([i]) for i in range(0x80)]


def _field(name: str, spec: str, number: int, repeated: bool, oneof: bool = False) -> Field:
    if spec.startswith("M:"):
        kind, message = "message", spec[2:]
    elif spec.startswith("E:"):
        kind, message = "enum", None
    else:
        kind, message = spec, None
    wire = VARINT if kind in _VARINT_KINDS and not repeated else LENGTH
    return Field(name, number, kind, repeated, message, oneof, _varint(number << 3 | wire))


def _schema() -> Dict[str, Tuple[Field, ...]]:
    tables = dict(_MESSAGES, **_MAPS)
    schema = {name: [_field(*spec) for spec in fields] for name, fields in tables.items()}
    for envelope, members in (("RapidRequest", _REQUEST_ONEOF),
                              ("RapidResponse", _RESPONSE_ONEOF)):
        schema[envelope] = [_field(name, f"M:{type_name}", number, False, oneof=True)
                            for name, type_name, number in members]
    schema["RapidRequest"] += [_field("traceCtx", "M:TraceContext", TRACE_CTX_FIELD_NUMBER, False),
                               _field("hlc", "M:HlcStamp", HLC_FIELD_NUMBER, False)]
    return {name: tuple(sorted(fields, key=lambda f: f.number))
            for name, fields in schema.items()}


SCHEMA = _schema()
BY_NUMBER = {name: {f.number: f for f in fields} for name, fields in SCHEMA.items()}
ONEOF = {name: tuple(f.name for f in fields if f.oneof) for name, fields in SCHEMA.items()}
_KEEP_DEFAULTS = frozenset([METADATA_ENTRY])


# --------------------------------------------------------------------------- #
# encoding
# --------------------------------------------------------------------------- #


def _int(value: int, kind: str) -> int:
    low, high = _BOUNDS[kind]
    value = int(value)
    if not low <= value < high:
        raise ValueError(f"Value out of range: {value} ({kind})")
    return value


def _encode_into(out: List[bytes], type_name: str, message: Dict[str, Any]) -> None:
    keep = type_name in _KEEP_DEFAULTS
    for f in SCHEMA[type_name]:
        if f.name not in message:
            continue
        value = message[f.name]
        kind = f.kind
        if f.repeated:
            if kind in _VARINT_KINDS:
                if value:
                    packed = b"".join([_varint(_int(v, kind)) for v in value])
                    out += (f.tag, _varint(len(packed)), packed)
            elif kind == "message":
                for v in value:
                    body = encode(f.message, v)
                    out += (f.tag, _varint(len(body)), body)
            else:
                for v in value:
                    body = v.encode("utf-8") if kind == "string" else bytes(v)
                    out += (f.tag, _varint(len(body)), body)
        elif kind == "message":
            body = encode(f.message, value)
            out += (f.tag, _varint(len(body)), body)
        elif kind in _VARINT_KINDS:
            value = _int(value, kind)
            if value or keep:
                out += (f.tag, _varint(value))
        else:
            body = value.encode("utf-8") if kind == "string" else bytes(value)
            if body or keep:
                out += (f.tag, _varint(len(body)), body)


def encode(type_name: str, message: Dict[str, Any]) -> bytes:
    """The proto3 bytes of ``message`` (a dict of field name -> value) as a
    ``type_name`` of the schema."""
    out: List[bytes] = []
    _encode_into(out, type_name, message)
    return b"".join(out)


def _upb_order(a: str, b: str) -> int:
    x, y = a.encode("utf-8"), b.encode("utf-8")
    n = min(len(x), len(y))
    if x[:n] != y[:n]:
        return -1 if x[:n] < y[:n] else 1
    return len(y) - len(x)


def map_entries(items: Iterable[Tuple[str, bytes]]) -> List[Dict[str, Any]]:
    """A ``map<string, bytes>``'s entries as the wire carries them: a later
    duplicate key replaces an earlier one, and the entries go out in the
    order of protobuf's deterministic serializer (``SerializeToString(
    deterministic=True)``), which compares keys bytewise and puts a key
    before its own prefixes."""
    table = dict(items)
    return [{"key": k, "value": table[k]}
            for k in sorted(table, key=functools.cmp_to_key(_upb_order))]


# --------------------------------------------------------------------------- #
# decoding
# --------------------------------------------------------------------------- #


def _read_varint(data, pos: int, end: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        if pos >= end:
            raise ValueError("truncated varint")
        byte = data[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if byte < 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise ValueError("varint longer than 10 bytes")


def _signed(raw: int, kind: str) -> int:
    if kind == "int64":
        raw &= 0xFFFF_FFFF_FFFF_FFFF
        return raw - (1 << 64) if raw >> 63 else raw
    raw &= 0xFFFF_FFFF
    return raw - (1 << 32) if raw >> 31 else raw


def _length(data, pos: int, end: int) -> Tuple[int, int]:
    size, pos = _read_varint(data, pos, end)
    if size > end - pos:
        raise ValueError("truncated length-delimited field")
    return pos, pos + size


def _skip(data, pos: int, end: int, number: int, wire: int) -> int:
    """Past one field of an unknown number (or of a wire type its number
    does not take)."""
    if wire == VARINT:
        return _read_varint(data, pos, end)[1]
    if wire in (FIXED64, FIXED32):
        pos += 8 if wire == FIXED64 else 4
        if pos > end:
            raise ValueError("truncated fixed-width field")
        return pos
    if wire == LENGTH:
        return _length(data, pos, end)[1]
    if wire == START_GROUP:
        while True:
            key, pos = _read_varint(data, pos, end)
            if key & 7 == END_GROUP:
                if key >> 3 != number:
                    raise ValueError("mismatched end of group")
                return pos
            pos = _skip(data, pos, end, key >> 3, key & 7)
    raise ValueError(f"invalid wire type {wire}")


def _merge(old: Dict[str, Any], new: Dict[str, Any], type_name: str) -> Dict[str, Any]:
    """Protobuf's merge of a second occurrence of a singular message."""
    fields = {f.name: f for f in SCHEMA[type_name]}
    out = dict(old)
    for name, value in new.items():
        f = fields[name]
        if f.repeated:
            out[name] = out.get(name, []) + value
        elif f.kind == "message" and name in out:
            out[name] = _merge(out[name], value, f.message)
        else:
            out[name] = value
        if f.oneof:
            for other in ONEOF[type_name]:
                if other != name:
                    out.pop(other, None)
    return out


def _decode(data, pos: int, end: int, type_name: str) -> Dict[str, Any]:
    fields = BY_NUMBER[type_name]
    message: Dict[str, Any] = {}
    while pos < end:
        key, pos = _read_varint(data, pos, end)
        number, wire = key >> 3, key & 7
        if number == 0:
            raise ValueError("field number 0")
        f = fields.get(number)
        kind = f.kind if f is not None else None
        if kind in _VARINT_KINDS and wire == VARINT:
            raw, pos = _read_varint(data, pos, end)
            value = _signed(raw, kind)
            if f.repeated:
                message.setdefault(f.name, []).append(value)
            else:
                message[f.name] = value
            continue
        if f is None or wire != LENGTH or (kind in _VARINT_KINDS and not f.repeated):
            pos = _skip(data, pos, end, number, wire)
            continue
        start, pos = _length(data, pos, end)
        if kind in _VARINT_KINDS:  # packed
            values = message.setdefault(f.name, [])
            while start < pos:
                raw, start = _read_varint(data, start, pos)
                values.append(_signed(raw, kind))
            continue
        if kind == "message":
            value = _decode(data, start, pos, f.message)
        elif kind == "string":
            value = bytes(data[start:pos]).decode("utf-8")
        else:
            value = bytes(data[start:pos])
        if f.repeated:
            message.setdefault(f.name, []).append(value)
            continue
        if kind == "message" and f.name in message:
            value = _merge(message[f.name], value, f.message)
        message[f.name] = value
        if f.oneof:
            for other in ONEOF[type_name]:
                if other != f.name:
                    message.pop(other, None)
    return message


def decode(type_name: str, data) -> Dict[str, Any]:
    """The dict of a ``type_name``'s proto3 bytes (fields that are absent on
    the wire are absent from it)."""
    return _decode(memoryview(data), 0, len(data), type_name)


def which_oneof(type_name: str, message: Dict[str, Any]) -> Optional[str]:
    """The member of ``type_name``'s oneof that ``message`` holds, if any."""
    return next((name for name in ONEOF[type_name] if name in message), None)
