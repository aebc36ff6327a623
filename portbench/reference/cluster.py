"""The cluster's identities, its K rings and its configuration id, in NumPy.

A cluster of ``capacity`` slots is made from a seed by the rule the
simulator states for its synthesized members: host ``10.a.b.c`` from the
slot's index, port ``5000 + index % 1000``, and the NodeId's two signed
longs from ``numpy.random.default_rng(seed)``. Ring ``k`` orders slots by
their endpoint's signed ring key under seed ``k`` (ties by slot), the
membership's rings are that order filtered to the members, and a member's
observer on ring ``k`` is its successor there (MembershipView.java:235-323).
The configuration id is the chained fold ``h = h * 37 + x`` from 1 over the
identifier history in NodeId order, then the members' endpoints in ring-0
order (MembershipView.java:535-547).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from . import hashes

_U64 = np.uint64


def _hostnames(idx: np.ndarray):
    """``10.a.b.c`` of each index's three low bytes, as zero-padded byte
    rows and their lengths."""
    digits = [str(v).encode() for v in range(256)]
    table = np.zeros((256, 3), dtype=np.uint8)
    for v, d in enumerate(digits):
        table[v, : len(d)] = np.frombuffer(d, np.uint8)
    widths = np.array([len(d) for d in digits], dtype=np.int64)
    n = len(idx)
    out = np.zeros((n, 15), dtype=np.uint8)
    rows = np.arange(n)
    cursor = np.zeros(n, dtype=np.int64)

    def put(piece: np.ndarray, width: np.ndarray) -> None:
        nonlocal cursor
        for j in range(piece.shape[1]):
            take = j < width
            out[rows[take], cursor[take] + j] = piece[take, j]
        cursor = cursor + width

    dot = np.full((n, 1), ord("."), dtype=np.uint8)
    one = np.ones(n, dtype=np.int64)
    put(np.tile(np.frombuffer(b"10", np.uint8), (n, 1)), 2 * one)
    for shift in (16, 8, 0):
        octet = (idx >> shift) & 0xFF
        put(dot, one)
        put(table[octet], widths[octet])
    width = int(cursor.max())
    return np.ascontiguousarray(out[:, :width]), cursor


class Cluster:
    """Identities, ring orders and the id fold of one run's cluster."""

    def __init__(self, capacity: int, k: int, seed: int) -> None:
        self.capacity, self.k = capacity, k
        idx = np.arange(capacity, dtype=np.int64)
        self.hostnames, self.host_lengths = _hostnames(idx)
        self.ports = 5000 + idx % 1000
        rng = np.random.default_rng(seed)
        self.id_high = rng.integers(-(2**63), 2**63, size=capacity, dtype=np.int64)
        self.id_low = rng.integers(-(2**63), 2**63, size=capacity, dtype=np.int64)
        # ring order of every slot, and each slot's place in it
        self.order = np.empty((k, capacity), dtype=np.int64)
        self.rank = np.empty((k, capacity), dtype=np.int64)
        for ring in range(k):
            key = hashes.endpoint_hashes(self.hostnames, self.host_lengths, self.ports,
                                         ring).view(np.int64)
            self.order[ring] = np.argsort(key, kind="stable")
            self.rank[ring, self.order[ring]] = idx
        host_h = hashes.xxh64_rows(self.hostnames, self.host_lengths)
        port_h = hashes.hash_ints(self.ports)
        # every slot's endpoint hashes, interleaved, in ring-0 order
        self._eps0 = np.stack([host_h[self.order[0]], port_h[self.order[0]]],
                              axis=1).reshape(-1)
        # the identifier history in admission order, and its element hashes
        self.seen = np.stack([self.id_high, self.id_low], axis=1)
        self.seen_h = np.stack([hashes.hash_longs(self.id_high),
                                hashes.hash_longs(self.id_low)], axis=1)
        self._seen_sorted = None

    # ---- identities ---------------------------------------------------------

    def reseat(self, slot: int, id_high: int, id_low: int) -> None:
        """A restarted process in ``slot``: same endpoint, a new NodeId."""
        self.id_high[slot], self.id_low[slot] = id_high, id_low

    def admit(self, slots: np.ndarray) -> None:
        """Append the slots' identifiers to the history (a join's view)."""
        if len(slots) == 0:
            return
        new = np.stack([self.id_high[slots], self.id_low[slots]], axis=1)
        self.seen = np.concatenate([self.seen, new])
        self.seen_h = np.concatenate([self.seen_h, np.stack(
            [hashes.hash_longs(new[:, 0]), hashes.hash_longs(new[:, 1])], axis=1)])
        self._seen_sorted = None

    # ---- rings --------------------------------------------------------------

    def neighbour(self, node: int, ring: int, active: np.ndarray, step: int) -> int:
        """The first member after (``step`` 1) or before (-1) ``node``'s
        place on ring ``ring``; ``node`` itself need not be a member."""
        order, c = self.order[ring], self.capacity
        pos = self.rank[ring, node]
        for i in range(1, c + 1):
            other = order[(pos + step * i) % c]
            if active[other] and other != node:
                return int(other)
        raise ValueError("no other member")

    def observers(self, node: int, active: np.ndarray) -> List[int]:
        """A member's observer on each ring: its successor."""
        return [self.neighbour(node, r, active, 1) for r in range(self.k)]

    def join_observers(self, node: int, active: np.ndarray) -> List[int]:
        """A joiner's expected observers: its predecessor among the members
        on each ring (MembershipView.java:293-304)."""
        return [self.neighbour(node, r, active, -1) for r in range(self.k)]

    # ---- configuration id ---------------------------------------------------

    def configuration_id(self, active: np.ndarray, seen_all: bool = True) -> int:
        """The configuration id of the membership ``active``. With
        ``seen_all`` false the fold takes the members' own identifiers in
        place of the whole history: a broken guarantee, for the control.

        Over the history's elements a then the endpoints' b, the fold is
        ``37**(len(a) + len(b)) + 37**len(b) * S(a) + S(b)``, with ``S`` the
        weighted sum of ``_weighted``; ``S(a)`` is kept until the next
        admission."""
        if seen_all:
            if self._seen_sorted is None:
                order = np.lexsort((self.seen[:, 1], self.seen[:, 0]))
                self._seen_sorted = _weighted(self.seen_h[order].reshape(-1))
            ids_sum, m_ids = self._seen_sorted
        else:
            members = np.flatnonzero(active)
            srt = members[np.lexsort((self.id_low[members], self.id_high[members]))]
            ids_sum, m_ids = _weighted(np.stack([hashes.hash_longs(self.id_high[srt]),
                                                 hashes.hash_longs(self.id_low[srt])],
                                                axis=1).reshape(-1))
        eps_sum, m_eps = _weighted(self._eps0[np.repeat(active[self.order[0]], 2)])
        powers = _powers(m_ids + m_eps)
        with np.errstate(over="ignore"):
            total = powers[m_ids + m_eps] + ids_sum * powers[m_eps] + eps_sum
        return int(np.array(total, dtype=_U64).view(np.int64))


_POWERS = np.ones(1, dtype=_U64)


def _powers(m: int) -> np.ndarray:
    """[37**0, ..., 37**m] mod 2**64."""
    global _POWERS
    if len(_POWERS) <= m:
        grown = np.empty(m + 1, dtype=_U64)
        grown[0] = 1
        with np.errstate(over="ignore"):
            grown[1:] = np.cumprod(np.full(m, 37, dtype=_U64))
        _POWERS = grown
    return _POWERS[: m + 1]


def _weighted(xs: np.ndarray) -> Tuple[np.uint64, int]:
    """(sum(x_i * 37**(m-1-i)) mod 2**64, m) of ``xs``."""
    m = len(xs)
    with np.errstate(over="ignore"):
        return (xs.astype(_U64) * _powers(m)[:m][::-1]).sum(dtype=_U64), m


def fold(xs: np.ndarray) -> int:
    """``h = 1; h = h * 37 + x`` over ``xs`` (mod 2**64), as a signed long:
    ``37**m + sum(x_i * 37**(m-1-i))``."""
    total, m = _weighted(xs)
    with np.errstate(over="ignore"):
        total = _powers(m)[m] + total
    return int(np.array(total, dtype=_U64).view(np.int64))
