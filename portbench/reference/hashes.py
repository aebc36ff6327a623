"""xxHash64 and threefry-2x32 in plain NumPy, frozen with the benchmark.

Written from the two specifications (Yann Collet's XXH64; Random123's
threefry-2x32 with 20 rounds, as ``jax.random`` keys and splits it), not
from the program, so that the yardstick does not move when the program
does. Only what the reference needs is here: XXH64 of rows shorter than 32
bytes (hostnames, 8-byte longs, 4-byte ints) and the threefry words of a
key at given counters.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_U64 = np.uint64
P1 = 0x9E3779B185EBCA87
P2 = 0xC2B2AE3D27D4EB4F
P3 = 0x165667B19E3779F9
P4 = 0x85EBCA77C2B2AE63
P5 = 0x27D4EB2F165667C5


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U64(r)) | (x >> _U64(64 - r))


def _lanes(data: np.ndarray, start: int, width: int) -> np.ndarray:
    """The little-endian word of ``width`` bytes at byte ``start`` of each
    row (bytes past the row's end read as 0)."""
    out = np.zeros(data.shape[0], dtype=_U64)
    for i in range(width):
        col = start + i
        if col < data.shape[1]:
            out |= data[:, col].astype(_U64) << _U64(8 * i)
    return out


def xxh64_rows(data: np.ndarray, lengths: np.ndarray, seed: int = 0) -> np.ndarray:
    """XXH64 of each row of ``data`` ([N, W] uint8, zero past each row's
    length) under ``seed``; every length below 32. Returns uint64 [N]."""
    data = np.asarray(data, dtype=np.uint8)
    lengths = np.asarray(lengths, dtype=np.int64)
    if data.ndim != 2 or (lengths >= 32).any():
        raise ValueError("xxh64_rows takes [N, W] rows shorter than 32 bytes")
    # zero the bytes past each row's length, so a lane never reads them
    data = np.where(np.arange(data.shape[1])[None, :] < lengths[:, None], data, 0).astype(np.uint8)
    n = data.shape[0]
    with np.errstate(over="ignore"):
        acc = np.full(n, (seed + P5) & 0xFFFFFFFFFFFFFFFF, dtype=_U64) + lengths.astype(_U64)
        pos = np.zeros(n, dtype=np.int64)
        for start in (0, 8, 16, 24):
            take = lengths - start >= 8
            if not take.any():
                break
            lane = _lanes(data, start, 8)
            k1 = _rotl(lane * _U64(P2), 31) * _U64(P1)
            new = _rotl(acc ^ k1, 27) * _U64(P1) + _U64(P4)
            acc = np.where(take, new, acc)
            pos = np.where(take, start + 8, pos)
        take = lengths - pos >= 4
        if take.any():
            lane = np.zeros(n, dtype=_U64)
            for p in np.unique(pos[take]):
                rows = take & (pos == p)
                lane[rows] = _lanes(data[rows], int(p), 4)
            new = _rotl(acc ^ (lane * _U64(P1)), 23) * _U64(P2) + _U64(P3)
            acc = np.where(take, new, acc)
            pos = np.where(take, pos + 4, pos)
        for _ in range(3):
            take = pos < lengths
            if not take.any():
                break
            byte = data[np.arange(n), np.minimum(pos, data.shape[1] - 1)].astype(_U64)
            new = _rotl(acc ^ (byte * _U64(P5)), 11) * _U64(P1)
            acc = np.where(take, new, acc)
            pos = np.where(take, pos + 1, pos)
        acc = acc ^ (acc >> _U64(33))
        acc = acc * _U64(P2)
        acc = acc ^ (acc >> _U64(29))
        acc = acc * _U64(P3)
        acc = acc ^ (acc >> _U64(32))
    return acc


def le_bytes(values: np.ndarray, width: int) -> np.ndarray:
    """[N] integers as [N, width] little-endian bytes (two's complement)."""
    v = np.asarray(values, dtype=np.int64).view(np.uint64)
    return np.stack([((v >> np.uint64(8 * i)) & np.uint64(0xFF)).astype(np.uint8)
                     for i in range(width)], axis=1)


def hash_longs(values: np.ndarray) -> np.ndarray:
    """LongHashFunction.xx(0).hashLong of each value."""
    return xxh64_rows(le_bytes(values, 8), np.full(len(values), 8))


def hash_ints(values: np.ndarray, seed: int = 0) -> np.ndarray:
    """LongHashFunction.xx(seed).hashInt of each value."""
    return xxh64_rows(le_bytes(values, 4), np.full(len(values), 4), seed)


def endpoint_hashes(hostnames: np.ndarray, lengths: np.ndarray, ports: np.ndarray,
                    seed: int) -> np.ndarray:
    """Rapid's ring key of each endpoint under ring seed ``seed``
    (Utils.AddressComparator): ``hashBytes(host) * 31 + hashInt(port)``."""
    distinct, where = np.unique(ports, return_inverse=True)
    with np.errstate(over="ignore"):
        return (xxh64_rows(hostnames, lengths, seed) * _U64(31)
                + hash_ints(distinct, seed)[where])


# --------------------------------------------------------------------------- #
# threefry-2x32, 20 rounds, on uint32 words
# --------------------------------------------------------------------------- #

_PARITY = 0x1BD11BDA
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_U32 = np.uint32


def threefry(k0: int, k1: int, x0: np.ndarray, x1: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """threefry-2x32-20 of the counter pairs ``(x0, x1)`` under ``(k0, k1)``."""
    ks = (_U32(k0), _U32(k1), _U32(k0 ^ k1 ^ _PARITY))
    x0 = np.asarray(x0, dtype=_U32).copy()
    x1 = np.asarray(x1, dtype=_U32).copy()
    with np.errstate(over="ignore"):
        x0 += ks[0]
        x1 += ks[1]
        for group in range(5):
            for r in _ROT[group % 2]:
                x0 += x1
                x1 = (x1 << _U32(r)) | (x1 >> _U32(32 - r))
                x1 ^= x0
            x0 += ks[(group + 1) % 3]
            x1 += ks[(group + 2) % 3] + _U32(group + 1)
    return x0, x1


def split(key: Tuple[int, int]) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """``jax.random.split(key)`` into (next key, probe key): the words of
    counters (0, 0) and (0, 1)."""
    a, b = threefry(key[0], key[1], np.zeros(2), np.arange(2))
    return (int(a[0]), int(b[0])), (int(a[1]), int(b[1]))


def uniform_at(key: Tuple[int, int], counters: np.ndarray) -> np.ndarray:
    """``jax.random.uniform(key, shape)`` read at flat positions
    ``counters``: float32 in [0, 1) from the top 23 bits of each word."""
    counters = np.asarray(counters, dtype=np.int64)
    a, b = threefry(key[0], key[1], (counters >> 32).astype(_U32),
                    (counters & 0xFFFFFFFF).astype(_U32))
    bits = (a ^ b) >> _U32(9) | _U32(0x3F800000)
    return bits.view(np.float32) - np.float32(1.0)
