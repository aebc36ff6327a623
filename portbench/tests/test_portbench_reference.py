"""The reference's pieces against their specifications' known answers, and
the whole reference against the port on a tiny cluster of each mix."""

import numpy as np
import pytest

from portbench import harness
from portbench.reference import hashes
from portbench.reference.cluster import Cluster, fold
from portbench.tests.conftest import tiny_cell


def test_xxh64_known_answers():
    # XXH64 of the empty input and of "a" under seed 0 (the specification's)
    rows = np.zeros((2, 4), dtype=np.uint8)
    rows[1, 0] = ord("a")
    got = hashes.xxh64_rows(rows, np.array([0, 1]))
    assert int(got[0]) == 0xEF46DB3751D8E999
    assert int(got[1]) == 0xD24EC4F1A98C6E5B


def test_xxh64_against_a_scalar_loop():
    # lengths 0..31 at several seeds, against an independent scalar XXH64
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, size=(32, 31), dtype=np.uint8)
    lengths = np.arange(32) % 32
    for seed in (0, 1, 9):
        got = hashes.xxh64_rows(data, lengths, seed)
        for row, n in enumerate(lengths):
            assert int(got[row]) == _xxh64(bytes(data[row, :n]), seed)


def _xxh64(data: bytes, seed: int) -> int:
    m = (1 << 64) - 1
    p1, p2, p3, p4, p5 = hashes.P1, hashes.P2, hashes.P3, hashes.P4, hashes.P5

    def rotl(x, r):
        return ((x << r) | (x >> (64 - r))) & m

    acc = (seed + p5 + len(data)) & m
    pos = 0
    while pos + 8 <= len(data):
        k = rotl(int.from_bytes(data[pos:pos + 8], "little") * p2 & m, 31) * p1 & m
        acc = (rotl(acc ^ k, 27) * p1 + p4) & m
        pos += 8
    if pos + 4 <= len(data):
        acc = (rotl(acc ^ (int.from_bytes(data[pos:pos + 4], "little") * p1 & m), 23) * p2 + p3) & m
        pos += 4
    for b in data[pos:]:
        acc = rotl(acc ^ (b * p5 & m), 11) * p1 & m
    acc ^= acc >> 33
    acc = acc * p2 & m
    acc ^= acc >> 29
    acc = acc * p3 & m
    return acc ^ (acc >> 32)


@pytest.mark.parametrize("key,counter,want", [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF), (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0)),
])
def test_threefry_known_answers(key, counter, want):
    # Random123's threefry2x32_20 known-answer vectors
    a, b = hashes.threefry(key[0], key[1], np.array([counter[0]]), np.array([counter[1]]))
    assert (int(a[0]), int(b[0])) == want


def fold_loop(xs) -> int:
    """The configuration id's fold, one element at a time in Python ints."""
    h = 1
    for x in xs:
        h = (h * 37 + int(x)) & 0xFFFFFFFFFFFFFFFF
    return h - (1 << 64) if h >= (1 << 63) else h


def test_fold_matches_the_loop():
    xs = np.random.default_rng(1).integers(0, 2**63, size=50, dtype=np.int64).astype(np.uint64)
    assert fold(xs) == fold_loop(xs)


def test_rings_are_permutations():
    cluster = Cluster(500, 10, 4)
    active = np.ones(500, dtype=bool)
    active[::7] = False
    for node in range(0, 500, 50):
        if not active[node]:
            continue
        obs = cluster.observers(node, active)
        for ring, o in enumerate(obs):
            assert cluster.neighbour(o, ring, active, -1) == node


def test_reference_agrees_with_the_port(mix):
    """The harness's whole path on the CPU: the port's view changes equal
    the reference's, every one."""
    out = harness.run_cell(tiny_cell(mix), 2**31 + 99, 2.0, False, lambda: 0.0, device="cpu")
    assert out["failed"] == 0
    assert out["attempted"] > 0
    assert all(c["value"] == 0 for c in out["checks"].values()), out["checks"]
    assert out["correct"] is True
