"""Bit-exact xxHash64 and the Rapid hash derivations built on it.

The port's own copy of the numpy xxHash64 (the reference orders its K rings
and derives configuration identities with
`net.openhft.hashing.LongHashFunction.xx(seed)`, Utils.java:211-230,
MembershipView.java:47,535-547: the original 64-bit xxHash with primitive
inputs read little-endian). Two implementations cross-validate in tests:

- ``xxh64``: a scalar implementation in pure Python ints (the spec, readably).
- ``xxh64_batch``: a vectorized numpy/uint64 implementation hashing N padded
  byte rows at once -- the host-side path that builds the rings.

All arithmetic is modulo 2**64. Java compares the hashes as *signed* longs
(Utils.java:216-221), so ring order uses the int64 view of these values.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

import numpy as np

_MASK = (1 << 64) - 1

_P1 = 0x9E3779B185EBCA87
_P2 = 0xC2B2AE3D27D4EB4F
_P3 = 0x165667B19E3779F9
_P4 = 0x85EBCA77C2B2AE63
_P5 = 0x27D4EB2F165667C5


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _MASK


def _round(acc: int, lane: int) -> int:
    return (_rotl((acc + lane * _P2) & _MASK, 31) * _P1) & _MASK


def _merge_round(acc: int, val: int) -> int:
    return ((acc ^ _round(0, val)) * _P1 + _P4) & _MASK


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of ``data`` with ``seed``; returns an unsigned 64-bit int."""
    seed &= _MASK
    n = len(data)
    pos = 0

    if n >= 32:
        v1 = (seed + _P1 + _P2) & _MASK
        v2 = (seed + _P2) & _MASK
        v3 = seed
        v4 = (seed - _P1) & _MASK
        while pos + 32 <= n:
            v1 = _round(v1, int.from_bytes(data[pos : pos + 8], "little"))
            v2 = _round(v2, int.from_bytes(data[pos + 8 : pos + 16], "little"))
            v3 = _round(v3, int.from_bytes(data[pos + 16 : pos + 24], "little"))
            v4 = _round(v4, int.from_bytes(data[pos + 24 : pos + 32], "little"))
            pos += 32
        acc = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _MASK
        acc = _merge_round(acc, v1)
        acc = _merge_round(acc, v2)
        acc = _merge_round(acc, v3)
        acc = _merge_round(acc, v4)
    else:
        acc = (seed + _P5) & _MASK

    acc = (acc + n) & _MASK

    while pos + 8 <= n:
        lane = int.from_bytes(data[pos : pos + 8], "little")
        acc = (_rotl(acc ^ _round(0, lane), 27) * _P1 + _P4) & _MASK
        pos += 8
    if pos + 4 <= n:
        lane = int.from_bytes(data[pos : pos + 4], "little")
        acc = (_rotl(acc ^ ((lane * _P1) & _MASK), 23) * _P2 + _P3) & _MASK
        pos += 4
    while pos < n:
        acc = (_rotl(acc ^ ((data[pos] * _P5) & _MASK), 11) * _P1) & _MASK
        pos += 1

    acc ^= acc >> 33
    acc = (acc * _P2) & _MASK
    acc ^= acc >> 29
    acc = (acc * _P3) & _MASK
    acc ^= acc >> 32
    return acc


def xxh64_int(value: int, seed: int = 0) -> int:
    """LongHashFunction.xx(seed).hashInt: XXH64 of the 4 LE bytes of an int32."""
    return xxh64((value & 0xFFFFFFFF).to_bytes(4, "little"), seed)


def xxh64_long(value: int, seed: int = 0) -> int:
    """LongHashFunction.xx(seed).hashLong: XXH64 of the 8 LE bytes of an int64."""
    return xxh64((value & _MASK).to_bytes(8, "little"), seed)


def endpoint_hash(hostname: bytes, port: int, seed: int) -> int:
    """Ring key for an endpoint under ring seed ``seed``.

    Utils.AddressComparator.computeHash (Utils.java:227-230):
    ``xx(seed).hashBytes(hostname) * 31 + xx(seed).hashInt(port)`` with Java
    long wraparound; returned unsigned (view as int64 for ordering).
    """
    return (xxh64(hostname, seed) * 31 + xxh64_int(port, seed)) & _MASK


def to_signed(h: int) -> int:
    """uint64 -> Java signed long, the comparison domain for ring order."""
    return h - (1 << 64) if h >= (1 << 63) else h


def address_comparator_key(endpoint) -> int:
    """Seed-0 ring order of an endpoint (anything with ``hostname`` bytes and
    ``port``), the order proposals are canonicalized in before consensus
    (MembershipService.java:340-342)."""
    return to_signed(endpoint_hash(endpoint.hostname, endpoint.port, 0))


def configuration_id(
    identifiers: Iterable[Tuple[int, int]], endpoints: Iterable[Tuple[bytes, int]]
) -> int:
    """Chained configuration identity hash.

    MembershipView.Configuration.getConfigurationId (MembershipView.java:535-547):
    ``h = 1``, then ``h = h*37 + xx(0).hashLong(id.high/low)`` over identifiers in
    NodeId order, then ``h = h*37 + xx(0).hashBytes(hostname)`` and
    ``h = h*37 + xx(0).hashInt(port)`` over the ring-0 endpoint order.
    Returns a Java signed long.
    """
    h = 1
    for high, low in identifiers:
        h = (h * 37 + xxh64_long(high)) & _MASK
        h = (h * 37 + xxh64_long(low)) & _MASK
    for hostname, port in endpoints:
        h = (h * 37 + xxh64(hostname)) & _MASK
        h = (h * 37 + xxh64_int(port)) & _MASK
    return to_signed(h)


# ---------------------------------------------------------------------------
# Vectorized batch implementation (numpy, uint64 lanes)
# ---------------------------------------------------------------------------

_U64 = np.uint64


def _np_rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U64(r)) | (x >> _U64(64 - r))


def _np_round(acc: np.ndarray, lane: np.ndarray) -> np.ndarray:
    return _np_rotl(acc + lane * _U64(_P2), 31) * _U64(_P1)


def _np_merge_round(acc: np.ndarray, val: np.ndarray) -> np.ndarray:
    return (acc ^ _np_round(np.zeros_like(acc), val)) * _U64(_P1) + _U64(_P4)


def xxh64_batch(data: np.ndarray, lengths: np.ndarray, seed: int = 0) -> np.ndarray:
    """XXH64 of ``N`` byte rows at once.

    ``data`` is ``[N, max_len] uint8`` (rows zero-padded past their length) and
    ``lengths[N]`` gives each row's true byte length. Returns ``uint64[N]``.
    """
    if data.ndim != 2 or data.dtype != np.uint8:
        raise ValueError("data must be [N, max_len] uint8")
    n_rows, max_len = data.shape
    lengths = lengths.astype(np.int64)
    if np.any(lengths > max_len) or np.any(lengths < 0):
        raise ValueError("lengths out of range")
    seed_u = _U64(seed & _MASK)

    # Zero out padding beyond each row's length so lane reads are deterministic,
    # then widen to uint64 once.
    col = np.arange(max_len, dtype=np.int64)[None, :]
    bytes64 = np.where(col < lengths[:, None], data, 0).astype(_U64)

    def lane8(base: np.ndarray) -> np.ndarray:
        """u64 little-endian lane at per-row byte offset ``base`` (may be ragged)."""
        idx = base[:, None] + np.arange(8, dtype=np.int64)[None, :]
        safe = np.clip(idx, 0, max_len - 1)
        b = np.take_along_axis(bytes64, safe, axis=1)
        b = np.where(idx < max_len, b, _U64(0))
        shifts = (np.arange(8, dtype=np.uint64) * _U64(8))[None, :]
        return (b << shifts).sum(axis=1, dtype=_U64)

    def lane4(base: np.ndarray) -> np.ndarray:
        idx = base[:, None] + np.arange(4, dtype=np.int64)[None, :]
        safe = np.clip(idx, 0, max_len - 1)
        b = np.take_along_axis(bytes64, safe, axis=1)
        b = np.where(idx < max_len, b, _U64(0))
        shifts = (np.arange(4, dtype=np.uint64) * _U64(8))[None, :]
        return (b << shifts).sum(axis=1, dtype=_U64)

    with np.errstate(over="ignore"):
        acc = np.full(n_rows, 0, dtype=_U64)
        long_rows = lengths >= 32
        # --- long-input accumulator phase (rows with >= 32 bytes) ---
        if np.any(long_rows):
            v1 = np.full(n_rows, (seed_u + _U64(_P1 & _MASK) + _U64(_P2)) & _U64(_MASK), dtype=_U64)
            v2 = np.full(n_rows, seed_u + _U64(_P2), dtype=_U64)
            v3 = np.full(n_rows, seed_u, dtype=_U64)
            v4 = np.full(n_rows, seed_u - _U64(_P1), dtype=_U64)
            n_stripes = lengths // 32
            max_stripes = int(n_stripes.max())
            for s in range(max_stripes):
                take = n_stripes > s
                base = np.where(take, s * 32, 0).astype(np.int64)
                nv1 = _np_round(v1, lane8(base))
                nv2 = _np_round(v2, lane8(base + 8))
                nv3 = _np_round(v3, lane8(base + 16))
                nv4 = _np_round(v4, lane8(base + 24))
                v1 = np.where(take, nv1, v1)
                v2 = np.where(take, nv2, v2)
                v3 = np.where(take, nv3, v3)
                v4 = np.where(take, nv4, v4)
            conv = _np_rotl(v1, 1) + _np_rotl(v2, 7) + _np_rotl(v3, 12) + _np_rotl(v4, 18)
            conv = _np_merge_round(conv, v1)
            conv = _np_merge_round(conv, v2)
            conv = _np_merge_round(conv, v3)
            conv = _np_merge_round(conv, v4)
            acc = np.where(long_rows, conv, acc)
        acc = np.where(long_rows, acc, seed_u + _U64(_P5))
        acc = acc + lengths.astype(_U64)

        # --- tail phase: consumed = stripes*32, then 8-byte, 4-byte, 1-byte ---
        consumed = (lengths // 32) * 32
        remaining = lengths - consumed
        # at most 3 u64 lanes remain (< 32 bytes)
        for _ in range(3):
            take = remaining >= 8
            if not np.any(take):
                break
            lane = lane8(consumed)
            new = _np_rotl(acc ^ _np_round(np.zeros_like(acc), lane), 27) * _U64(_P1) + _U64(_P4)
            acc = np.where(take, new, acc)
            consumed = np.where(take, consumed + 8, consumed)
            remaining = np.where(take, remaining - 8, remaining)
        take = remaining >= 4
        if np.any(take):
            lane = lane4(consumed)
            new = _np_rotl(acc ^ (lane * _U64(_P1)), 23) * _U64(_P2) + _U64(_P3)
            acc = np.where(take, new, acc)
            consumed = np.where(take, consumed + 4, consumed)
            remaining = np.where(take, remaining - 4, remaining)
        for _ in range(3):
            take = remaining >= 1
            if not np.any(take):
                break
            idx = np.clip(consumed, 0, max_len - 1)
            byte = np.take_along_axis(bytes64, idx[:, None], axis=1)[:, 0]
            new = _np_rotl(acc ^ (byte * _U64(_P5)), 11) * _U64(_P1)
            acc = np.where(take, new, acc)
            consumed = np.where(take, consumed + 1, consumed)
            remaining = np.where(take, remaining - 1, remaining)

        acc = acc ^ (acc >> _U64(33))
        acc = acc * _U64(_P2)
        acc = acc ^ (acc >> _U64(29))
        acc = acc * _U64(_P3)
        acc = acc ^ (acc >> _U64(32))
    return acc


def endpoint_hash_batch(
    hostnames: np.ndarray, lengths: np.ndarray, ports: np.ndarray, seed: int
) -> np.ndarray:
    """Vectorized ``endpoint_hash`` over N endpoints; returns uint64[N]."""
    host_h = xxh64_batch(hostnames, lengths, seed)
    port_bytes = np.zeros((len(ports), 4), dtype=np.uint8)
    p = ports.astype(np.uint32)
    for i in range(4):
        port_bytes[:, i] = ((p >> np.uint32(8 * i)) & np.uint32(0xFF)).astype(np.uint8)
    port_h = xxh64_batch(port_bytes, np.full(len(ports), 4, dtype=np.int64), seed)
    with np.errstate(over="ignore"):
        return host_h * _U64(31) + port_h


def xxh64_batch_auto(
    data: np.ndarray, lengths: np.ndarray, seed: int = 0
) -> np.ndarray:
    """``xxh64_batch`` through the port's native library (``native.py``)
    when it builds and loads, the vectorized-numpy implementation otherwise
    (identical outputs; tests/test_torch_native.py holds them equal). Use
    this on hot construction paths, which hand it views and int arrays of
    any width -- the native lane loop is several times faster at
    million-row batches."""
    from . import native

    data = np.ascontiguousarray(data, dtype=np.uint8)
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    out = native.xxh64_batch(data, lengths, seed)
    return out if out is not None else xxh64_batch(data, lengths, seed)


def pack_hostnames(hostnames: Sequence[bytes]) -> Tuple[np.ndarray, np.ndarray]:
    """Pack variable-length hostname byte strings into a padded uint8 matrix."""
    max_len = max((len(h) for h in hostnames), default=1)
    max_len = max(max_len, 1)
    data = np.zeros((len(hostnames), max_len), dtype=np.uint8)
    lengths = np.zeros(len(hostnames), dtype=np.int64)
    for i, h in enumerate(hostnames):
        data[i, : len(h)] = np.frombuffer(h, dtype=np.uint8)
        lengths[i] = len(h)
    return data, lengths
