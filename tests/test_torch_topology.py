"""The PyTorch port's copies of hashing and topology against rapid_tpu's:
the same inputs, made with numpy from a seed, must give identical arrays
(ring order and configuration ids stay bit-exact with the JVM)."""

import numpy as np
import pytest

from rapid_tpu import hashing as jax_hashing
from rapid_tpu.sim import topology as jax_topology
from rapid_tpu_torch import hashing
from rapid_tpu_torch.sim import topology

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py


def _clusters(capacity, k, seed):
    return (
        jax_topology.VirtualCluster.synthesize(capacity, k, seed=seed),
        topology.VirtualCluster.synthesize(capacity, k, seed=seed),
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_xxh64_batch_matches_reference(seed):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, size=(300, 70), dtype=np.uint8)
    lengths = rng.integers(0, 71, size=300)
    for s in (0, 5, 2**63 + 7):
        np.testing.assert_array_equal(
            hashing.xxh64_batch(data, lengths, s),
            jax_hashing.xxh64_batch(data, lengths, s),
        )
        np.testing.assert_array_equal(
            hashing.xxh64_batch_auto(data, lengths, s),
            jax_hashing.xxh64_batch(data, lengths, s),
        )
    # the scalar spec agrees with the batch path, row by row
    for i in range(0, 300, 37):
        row = data[i, : lengths[i]].tobytes()
        assert hashing.xxh64(row, 3) == jax_hashing.xxh64(row, 3)
        assert hashing.xxh64(row, 3) == int(hashing.xxh64_batch(data[i : i + 1], lengths[i : i + 1], 3)[0])


def test_endpoint_hash_matches_reference():
    rng = np.random.default_rng(2)
    hosts, lengths = jax_hashing.pack_hostnames([b"10.0.0.1", b"node-a.example", b"h"])
    ports = rng.integers(1, 65536, size=3)
    for ring in range(4):
        np.testing.assert_array_equal(
            hashing.endpoint_hash_batch(hosts, lengths, ports, ring),
            jax_hashing.endpoint_hash_batch(hosts, lengths, ports, ring),
        )
        assert hashing.endpoint_hash(b"10.0.0.1", int(ports[0]), ring) == (
            jax_hashing.endpoint_hash(b"10.0.0.1", int(ports[0]), ring)
        )


def test_synthesize_matches_reference():
    ref, got = _clusters(1000, 10, seed=3)
    for field in ("hostnames", "host_lengths", "ports", "id_high", "id_low", "ring_hashes"):
        np.testing.assert_array_equal(getattr(got, field), getattr(ref, field), err_msg=field)
    for a, b in zip(got.node_hashes(), ref.node_hashes()):
        np.testing.assert_array_equal(a, b)


def test_ring_rank_adjacency_and_order_match_reference():
    ref, got = _clusters(1000, 10, seed=4)
    np.testing.assert_array_equal(got.full_ring_order(), ref.full_ring_order())
    np.testing.assert_array_equal(got.ring_rank(), ref.ring_rank())
    rng = np.random.default_rng(4)
    for active in (np.ones(1000, bool), rng.random(1000) < 0.6, np.eye(1, 1000, 5, dtype=bool)[0]):
        for a, b in zip(topology.build_adjacency(got, active),
                        jax_topology.build_adjacency(ref, active)):
            np.testing.assert_array_equal(a, b)
        for ring in (0, 9):
            np.testing.assert_array_equal(
                topology.ring_order(got, active, ring),
                jax_topology.ring_order(ref, active, ring),
            )


def test_config_fold_matches_reference():
    rng = np.random.default_rng(5)
    for m in (0, 1, 7, 500):
        parts = [rng.integers(0, 2**64, size=m, dtype=np.uint64) for _ in range(4)]
        assert topology.config_fold(*parts) == jax_topology.config_fold(*parts)


def test_assign_identity_matches_reference():
    ref, got = _clusters(64, 4, seed=6)
    ref.node_hashes(), got.node_hashes()
    for cluster in (ref, got):
        cluster.assign_identity(3, b"real-host.example.org", 7000, -5, 99)
    np.testing.assert_array_equal(got.ring_hashes, ref.ring_hashes)
    np.testing.assert_array_equal(got.hostnames, ref.hostnames)
    np.testing.assert_array_equal(got.ring_rank(), ref.ring_rank())
    for a, b in zip(got.node_hashes(), ref.node_hashes()):
        np.testing.assert_array_equal(a, b)


# each case: waves of re-seats (slot, endpoint: None for a fresh one, "own"
# for the one the slot has, "of_500" for slot 500's), the order read after
# each wave; ``cached``: whether the order is read before the first wave
ORDER_CACHE_CASES = {
    "burst_of_1pct": ([[(s, None) for s in range(3, 1000, 100)]], True),
    "burst_of_1pct_own_endpoints": ([[(s, "own") for s in range(3, 1000, 100)]], True),
    "own_and_fresh_endpoints": ([[(3, "own"), (103, None), (203, "own")]], True),
    "every_slot": ([[(s, None) for s in range(1000)]], True),
    "one_slot": ([[(517, None)]], True),
    "same_slot_twice": ([[(42, None), (42, (b"again.example", 7100))]], True),
    "two_waves": ([[(s, None) for s in range(0, 1000, 97)],
                   [(s, "own") for s in range(5, 1000, 89)]], True),
    "reseated_pair_tie": ([[(10, (b"shared.example", 7000)),
                            (20, (b"shared.example", 7000))]], True),
    # half the slots on three endpoints: runs of ties long enough that an
    # unstable sort would show
    "reseated_groups_tie": ([[(s, (b"shared-%d.example" % (s % 3), 7000))
                              for s in range(998, 0, -2)]], True),
    "tie_with_kept_slot": ([[(100, "of_500"), (900, "of_500")]], True),
    "not_cached": ([[(s, None) for s in range(3, 1000, 100)]], False),
}


def _endpoint(cluster, slot):
    return (bytes(cluster.hostnames[slot, : cluster.host_lengths[slot]]),
            int(cluster.ports[slot]))


@pytest.mark.parametrize("case", sorted(ORDER_CACHE_CASES))
def test_reseats_keep_the_order_cache_exact(case):
    """After re-seats the ring order, the ranks, the adjacency and each
    ring's active order equal the JAX package's (which always sorts anew) and
    a fresh stable argsort, ties by slot id included. A wave whose slots all
    keep their endpoints keeps the cached order and ranks as they were."""
    waves, cached = ORDER_CACHE_CASES[case]
    ref, got = _clusters(1000, 10, seed=7)
    rng = np.random.default_rng(7)
    for wave in waves:
        order, rank = (got.full_ring_order(), got.ring_rank()) if cached else (None, None)
        moved = []
        for slot, endpoint in wave:
            if endpoint is None:
                endpoint = (b"restarted-%d.example" % slot, 9000 + slot)
            elif endpoint == "own":
                endpoint = _endpoint(got, slot)
            elif endpoint == "of_500":
                endpoint = _endpoint(got, 500)
            ids = [int(x) for x in rng.integers(-(2**63), 2**63, size=2, dtype=np.int64)]
            ref.assign_identity(slot, *endpoint, *ids)
            moved.append(got.assign_identity(slot, *endpoint, *ids))
        assert moved == [endpoint != "own" for _, endpoint in wave]
        if cached:
            kept = got._full_order is order and got._ring_rank is rank
            assert kept == (not any(moved))
        np.testing.assert_array_equal(got.full_ring_order(), ref.full_ring_order())
        np.testing.assert_array_equal(
            got.full_ring_order(),
            np.argsort(got.ring_hashes.view(np.int64), axis=1, kind="stable"))
        np.testing.assert_array_equal(got.ring_rank(), ref.ring_rank())
        np.testing.assert_array_equal(got.ring_hashes, ref.ring_hashes)
        for a, b in zip(got.node_hashes(), ref.node_hashes()):
            np.testing.assert_array_equal(a, b)
        cached = True
    if case == "tie_with_kept_slot":
        hashes = got.ring_hashes.view(np.int64)[0]
        order = list(got.full_ring_order()[0])
        assert hashes[100] == hashes[500] == hashes[900]
        assert order.index(100) + 1 == order.index(500) == order.index(900) - 1
    active = rng.random(1000) < 0.6
    for a, b in zip(topology.build_adjacency(got, active),
                    jax_topology.build_adjacency(ref, active)):
        np.testing.assert_array_equal(a, b)
    for ring in range(10):
        np.testing.assert_array_equal(topology.ring_order(got, active, ring),
                                      jax_topology.ring_order(ref, active, ring))
