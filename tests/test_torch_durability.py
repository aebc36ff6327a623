"""The port's durability plane (``rapid_tpu_torch.durability``) against the JAX
package's, on the CPU.

Every case of ``tests/test_durability.py``'s ``TestWalFraming``,
``TestDurableStore`` and ``TestClusterRecovery`` runs once on each package
with the same inputs, holds its own checks on both, and the outcomes are
equal exactly: decoded records, recovered content, the ``durability_stats``
counters (all but ``recovery_ms``, a wall-clock reading) and every byte of
every segment and snapshot file the operations leave behind. Then the
on-disk format across packages: a directory either package writes opens in
the other to the same content and the same ``replayed_records``.
``TestSearchDurability`` waits for the port of ``search/``.
"""

import os
import random
import shutil

import pytest

from test_torch_cluster import PACKAGES, package, twin

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py


def files(directory):
    """Every file under ``directory``: name -> bytes."""
    out = {}
    for name in sorted(os.listdir(directory)):
        with open(os.path.join(directory, name), "rb") as fh:
            out[name] = fh.read()
    return out


def stats(store):
    """``durability_stats`` without the wall-clock ``recovery_ms``."""
    out = dict(store.durability_stats())
    assert out.pop("recovery_ms") >= 0
    return out


def content(store):
    return {p: store.get(p) for p in store.partitions()}


def unit_twin(scenario, tmp_path):
    """``scenario(P, directory)`` on each package, in a directory of its own;
    the outcomes must be equal."""
    outs = []
    for name in PACKAGES:
        directory = tmp_path / name
        directory.mkdir()
        outs.append(scenario(package(name), str(directory)))
    assert outs[1] == outs[0]
    return outs[1]


# --------------------------------------------------------------------- #
# TestWalFraming
# --------------------------------------------------------------------- #


def frame_roundtrip_and_record_codecs(P, d):
    W = P.durability_wal
    payloads = [W.put_record(7, b"content"), W.delete_record(7), W.snapshot_record(42),
                W.meta_record("node_id", b"\x01\x02")]
    blob = b"".join(W.frame(p) for p in payloads)
    assert [p for p, _end in W.iter_frames(blob)] == payloads
    parsed = [W.parse_record(p) for p in payloads]
    assert parsed == [(W.KIND_PUT, (7, b"content")), (W.KIND_DELETE, (7,)),
                      (W.KIND_SNAPSHOT, (42,)), (W.KIND_META, ("node_id", b"\x01\x02"))]
    return blob, parsed


def unknown_kind_is_skipped_not_fatal(P, d):
    W = P.durability_wal
    assert W.parse_record(bytes([99]) + b"future bytes") is None
    assert W.parse_record(b"") is None
    return (W.FSYNC_NEVER, W.FSYNC_BATCH, W.FSYNC_ALWAYS,
            W.KIND_PUT, W.KIND_DELETE, W.KIND_SNAPSHOT, W.KIND_META)


def iter_frames_stops_at_short_and_corrupt_tails(P, d):
    W = P.durability_wal
    good = W.frame(W.put_record(1, b"a"))
    torn_short = good + W.frame(W.put_record(2, b"bb"))[:-3]
    short = list(W.iter_frames(torn_short))
    assert [p for p, _ in short] == [W.put_record(1, b"a")]
    second = W.frame(W.put_record(2, b"bb"))
    corrupt = good + second[:-1] + bytes([second[-1] ^ 0xFF])
    bad = list(W.iter_frames(corrupt))
    assert [p for p, _ in bad] == [W.put_record(1, b"a")]
    return short, bad


def log_truncates_at_first_bad_record_on_reopen(P, d):
    W = P.durability_wal
    log = W.WriteAheadLog(d, fsync_policy=W.FSYNC_NEVER)
    for i in range(5):
        log.append(W.put_record(i, b"rec-%d" % i))
    log.crash()
    written = files(d)
    assert P.durability.tear_wal_tail(d, drop_bytes=3) is not None
    reopened = W.WriteAheadLog(d, fsync_policy=W.FSYNC_NEVER)
    records = reopened.recovered_records()
    assert [p for _seq, p in records] == [W.put_record(i, b"rec-%d" % i) for i in range(4)]
    assert reopened.torn_truncations == 1
    reopened.close()
    clean = W.WriteAheadLog(d, fsync_policy=W.FSYNC_NEVER)
    assert clean.torn_truncations == 0 and len(clean.recovered_records()) == 4
    clean.close()
    return written, records, files(d)


def corrupt_tail_truncates_via_crc_not_length(P, d):
    W = P.durability_wal
    log = W.WriteAheadLog(d, fsync_policy=W.FSYNC_NEVER)
    for i in range(3):
        log.append(W.put_record(i, b"x" * 32))
    log.crash()
    assert P.durability.tear_wal_tail(d, corrupt=True) is not None
    torn = files(d)
    reopened = W.WriteAheadLog(d, fsync_policy=W.FSYNC_NEVER)
    assert reopened.torn_truncations == 1 and len(reopened.recovered_records()) == 2
    reopened.close()
    return torn, files(d)


def rotation_and_snapshot_marker_retention(P, d):
    W = P.durability_wal
    log = W.WriteAheadLog(d, segment_bytes=64, fsync_policy=W.FSYNC_BATCH)
    for i in range(10):
        log.append(W.put_record(i, b"y" * 16))
    rotated = log.segment_seqs()
    assert len(rotated) > 1
    before = files(d)
    marker_seq = log.mark_snapshot(3)
    assert log.segment_seqs() == [marker_seq]
    log.append(W.put_record(99, b"after"))
    log.close()
    reopened = W.WriteAheadLog(d, fsync_policy=W.FSYNC_BATCH)
    records = [p for _seq, p in reopened.recovered_records()]
    assert records[:2] == [W.snapshot_record(3), W.put_record(99, b"after")]
    reopened.close()
    return rotated, marker_seq, before, records, files(d)


def snapshot_file_without_witness_reads_as_absent(P, d):
    W = P.durability_wal
    path = os.path.join(d, "snap.bin")
    W.write_snapshot(path, {1: b"a"}, {"k": b"v"})
    written = files(d)
    assert W.load_snapshot(path) == ({1: b"a"}, {"k": b"v"})
    with open(path, "r+b") as fh:
        fh.truncate(os.path.getsize(path) - 4)
    assert W.load_snapshot(path) is None
    return written


WAL_CASES = [frame_roundtrip_and_record_codecs, unknown_kind_is_skipped_not_fatal,
             iter_frames_stops_at_short_and_corrupt_tails,
             log_truncates_at_first_bad_record_on_reopen,
             corrupt_tail_truncates_via_crc_not_length, rotation_and_snapshot_marker_retention,
             snapshot_file_without_witness_reads_as_absent]


@pytest.mark.parametrize("scenario", WAL_CASES, ids=[f.__name__ for f in WAL_CASES])
def test_wal_framing_twin(scenario, tmp_path):
    unit_twin(scenario, tmp_path)


# --------------------------------------------------------------------- #
# TestDurableStore
# --------------------------------------------------------------------- #


def seeded_workload(store, seed, ops=60, partitions=8):
    rnd = random.Random(seed)
    for i in range(ops):
        p = rnd.randrange(partitions)
        if rnd.random() < 0.85 or store.get(p) is None:
            store.put(p, b"w-%d-%d" % (seed, i))
        else:
            store.delete(p)


def parity_with_in_memory_reference_store(P, d):
    durable = P.durability.DurablePartitionStore(d, fsync_policy=P.durability.FSYNC_NEVER)
    memory = P.handoff_store.InMemoryPartitionStore()
    seeded_workload(durable, seed=11)
    seeded_workload(memory, seed=11)
    assert durable.partitions() == memory.partitions()
    assert durable.sizes() == memory.sizes()
    for p in memory.partitions():
        assert durable.get(p) == memory.get(p)
        assert durable.fingerprint(p) == memory.fingerprint(p)
    out = content(durable), durable.digest(), stats(durable)
    durable.close()
    return out, files(d)


def recovery_replays_log_over_snapshot_with_exact_counts(P, d):
    D = P.durability
    store = D.DurablePartitionStore(d, fsync_policy=D.FSYNC_NEVER, snapshot_every_records=0)
    store.set_identity(P.types.NodeId(123, 456))
    store.set_config_id(-77)
    for i in range(10):
        store.put(i, b"pre-%d" % i)
    store.checkpoint()
    for i in range(4):
        store.put(10 + i, b"post-%d" % i)
    expected = content(store)
    store.crash()
    written = files(d)
    reopened = D.DurablePartitionStore(d, fsync_policy=D.FSYNC_NEVER, snapshot_every_records=0)
    got = stats(reopened)
    assert got["replayed_records"] == 4 and got["snapshot_version"] == 1
    assert content(reopened) == expected
    assert reopened.node_id == P.types.NodeId(123, 456)
    assert reopened.config_id == -77
    reopened.close()
    return written, got, expected


def auto_checkpoint_every_n_records(P, d):
    D = P.durability
    store = D.DurablePartitionStore(d, fsync_policy=D.FSYNC_NEVER, snapshot_every_records=8)
    for i in range(17):
        store.put(i % 4, b"v-%d" % i)
    before = stats(store)
    assert before["snapshot_version"] == 2
    store.crash()
    written = files(d)
    reopened = D.DurablePartitionStore(d, fsync_policy=D.FSYNC_NEVER, snapshot_every_records=8)
    after = stats(reopened)
    assert after["replayed_records"] == 1
    reopened.close()
    return before, written, after


def fsync_policy_accounting_and_stall_hook_seam(P, d):
    D = P.durability
    stalls = []
    store = D.DurablePartitionStore(os.path.join(d, "always"), fsync_policy=D.FSYNC_ALWAYS,
                                    snapshot_every_records=0, fsync_hook=lambda: stalls.append(1))
    for i in range(5):
        store.put(i, b"z")
    always = stats(store)
    assert always["fsyncs"] == 5 and len(stalls) == 5
    store.close()
    lazy = D.DurablePartitionStore(os.path.join(d, "never"), fsync_policy=D.FSYNC_NEVER,
                                   snapshot_every_records=0)
    for i in range(5):
        lazy.put(i, b"z")
    lazy.sync()
    never = stats(lazy)
    assert never["fsyncs"] == 0
    lazy.close()
    return always, never, files(os.path.join(d, "always")), files(os.path.join(d, "never"))


def crash_strands_all_further_mutation(P, d):
    D = P.durability
    store = D.DurablePartitionStore(d, fsync_policy=D.FSYNC_NEVER, snapshot_every_records=0)
    store.put(1, b"kept")
    store.crash()
    store.put(2, b"lost")
    store.delete(1)
    store.checkpoint()
    store.sync()
    reopened = D.DurablePartitionStore(d, fsync_policy=D.FSYNC_NEVER, snapshot_every_records=0)
    assert reopened.partitions() == (1,) and reopened.get(1) == b"kept"
    reopened.close()
    return files(d)


def torn_write_recovery_is_deterministic_per_seed(P, d):
    D = P.durability
    digests = []
    for attempt in ("a", "b"):
        directory = os.path.join(d, attempt)
        store = D.DurablePartitionStore(directory, fsync_policy=D.FSYNC_NEVER,
                                        snapshot_every_records=0)
        seeded_workload(store, seed=23)
        appended = store.durability_stats()["appends"]
        store.crash()
        assert D.tear_wal_tail(directory, corrupt=True) is not None
        recovered = D.DurablePartitionStore(directory, fsync_policy=D.FSYNC_NEVER,
                                            snapshot_every_records=0)
        got = stats(recovered)
        assert got["torn_truncations"] == 1 and got["replayed_records"] == appended - 1
        digests.append((recovered.digest(), got, files(directory)))
        recovered.close()
    assert digests[0] == digests[1]
    return digests[0]


STORE_CASES = [parity_with_in_memory_reference_store,
               recovery_replays_log_over_snapshot_with_exact_counts,
               auto_checkpoint_every_n_records, fsync_policy_accounting_and_stall_hook_seam,
               crash_strands_all_further_mutation, torn_write_recovery_is_deterministic_per_seed]


@pytest.mark.parametrize("scenario", STORE_CASES, ids=[f.__name__ for f in STORE_CASES])
def test_durable_store_twin(scenario, tmp_path):
    unit_twin(scenario, tmp_path)


# --------------------------------------------------------------------- #
# The on-disk format across packages
# --------------------------------------------------------------------- #


def write_directory(P, d, snapshot_every, tear):
    """A seeded workload with identity and config id on ``P``'s store, left
    as a crash leaves it (and torn, when ``tear``)."""
    D = P.durability
    store = D.DurablePartitionStore(d, fsync_policy=D.FSYNC_BATCH, segment_bytes=256,
                                    snapshot_every_records=snapshot_every)
    store.set_identity(P.types.NodeId(-5, 9))
    seeded_workload(store, seed=31, ops=90, partitions=12)
    store.set_config_id(4651904502688146028)
    seeded_workload(store, seed=37, ops=25, partitions=12)
    store.crash()
    if tear:
        assert D.tear_wal_tail(d, drop_bytes=5) is not None


def recover(P, d):
    D = P.durability
    store = D.DurablePartitionStore(d, fsync_policy=D.FSYNC_BATCH, segment_bytes=256,
                                    snapshot_every_records=0)
    out = {"content": content(store), "digest": store.digest(), "stats": stats(store),
           "node_id": (store.node_id.high, store.node_id.low), "config_id": store.config_id,
           "incarnation": store.incarnation}
    store.close()
    return out


@pytest.mark.parametrize("snapshot_every,tear", [(0, False), (16, False), (16, True), (7, True)],
                         ids=["log_only", "snapshots", "snapshots_torn", "odd_cadence_torn"])
@pytest.mark.parametrize("writer", PACKAGES)
def test_directory_written_by_one_package_recovers_in_the_other(writer, snapshot_every, tear,
                                                               tmp_path):
    """The same operations leave byte-identical files in both packages, and
    each package's directory recovers in the other to the same content,
    identity, configuration id and ``replayed_records`` as in its writer."""
    made = {}
    for name in PACKAGES:
        d = str(tmp_path / name)
        write_directory(package(name), d, snapshot_every, tear)
        made[name] = files(d)
    assert made["rapid_tpu_torch"] == made["rapid_tpu"]
    reader = [name for name in PACKAGES if name != writer][0]
    src = str(tmp_path / writer)
    shutil.copytree(src, str(tmp_path / "copy"))
    by_writer = recover(package(writer), src)
    by_reader = recover(package(reader), str(tmp_path / "copy"))
    assert by_reader == by_writer
    assert by_writer["stats"]["replayed_records"] > 0
    assert by_writer["stats"]["torn_truncations"] == int(tear)
    # recovery truncated the torn tail alike on both sides
    assert files(str(tmp_path / "copy")) == files(src)


# --------------------------------------------------------------------- #
# TestClusterRecovery
# --------------------------------------------------------------------- #


def durable_settings(P):
    return P.settings.Settings(durability=P.settings.DurabilitySettings(
        enabled=True, fsync_policy=P.durability.FSYNC_NEVER))


PLACEMENT = {"partitions": 16, "replicas": 3, "seed": 7}


def durable_cluster(h, root, n):
    dirs = {i: str(root / h.P.name / f"node{i}") for i in range(n)}
    h.start_seed(0, placement=PLACEMENT, serving=True, durability=dirs[0])
    for i in range(1, n):
        h.join(i, placement=PLACEMENT, serving=True, durability=dirs[i])
    h.wait_and_verify_agreement(n)
    return dirs


def drive(h, cluster, acked, count, tag):
    for j in range(count):
        key, value = b"%s-%02d" % (tag, j), b"v-%s-%d" % (tag, j)
        promise = cluster.serving_put(key, value)
        if h.scheduler.run_until(promise.done, timeout_ms=60_000) and promise.peek().status == 0:
            acked[key] = value


def read_back(h, cluster, acked):
    lost, versions = [], {}
    for key in sorted(acked):
        promise = cluster.serving_get(key)
        h.scheduler.run_until(promise.done, timeout_ms=60_000)
        ack = promise.peek()
        versions[key] = (ack.status, ack.version, ack.value)
        if ack.status != 0 or ack.version == 0:
            lost.append(key)
    return lost, versions


def fingerprints(h):
    return sorted((str(e), i.get_partition_store().digest()) for e, i in h.instances.items())


def crashed_node_rejoins_with_old_identity_and_replays(h, root):
    n = 3
    dirs = durable_cluster(h, root, n)
    victim = h.instances[h.addr(2)]
    identity = victim.get_partition_store().node_id
    assert identity is not None
    acked = {}
    drive(h, h.instances[h.addr(0)], acked, 20, b"pre")
    assert len(acked) == 20
    h.scheduler.run_for(2_000)
    victim.get_partition_store().crash()
    h.fail_nodes([h.addr(2)])
    h.blacklist.discard(h.addr(2))
    revived = h.join(2, seed_index=0, placement=PLACEMENT, serving=True, durability=dirs[2])
    h.wait_and_verify_agreement(n)
    store = revived.get_partition_store()
    assert store.node_id == identity
    recovered = stats(store)
    assert recovered["replayed_records"] > 0
    others = [h.instances[h.addr(i)].get_partition_store() for i in (0, 1)]
    for p in store.partitions():
        for other in others:
            if other.fingerprint(p) is not None:
                assert other.fingerprint(p) == store.fingerprint(p), p
    drive(h, h.instances[h.addr(1)], acked, 10, b"post")
    lost, versions = read_back(h, h.instances[h.addr(0)], acked)
    assert lost == []
    return {"identity": (identity.high, identity.low), "recovered": recovered,
            "acked": sorted(acked.items()), "versions": sorted(versions.items()),
            "fingerprints": fingerprints(h),
            "durability_replayed": revived.get_cluster_status().durability_replayed}


def torn_wal_tail_truncates_and_cluster_converges(h, root):
    n = 3
    dirs = durable_cluster(h, root, n)
    victim = h.instances[h.addr(1)]
    identity = victim.get_partition_store().node_id
    acked = {}
    drive(h, h.instances[h.addr(0)], acked, 16, b"torn")
    h.scheduler.run_for(2_000)
    victim.get_partition_store().crash()
    assert h.P.durability.tear_wal_tail(dirs[1], corrupt=True) is not None
    h.fail_nodes([h.addr(1)])
    h.blacklist.discard(h.addr(1))
    revived = h.join(1, seed_index=0, placement=PLACEMENT, serving=True, durability=dirs[1])
    h.wait_and_verify_agreement(n)
    store = revived.get_partition_store()
    assert store.node_id == identity
    recovered = stats(store)
    assert recovered["torn_truncations"] == 1
    drive(h, h.instances[h.addr(0)], acked, 16, b"torn")
    h.scheduler.run_for(2_000)
    others = [h.instances[h.addr(i)].get_partition_store() for i in (0, 2)]
    for p in store.partitions():
        for other in others:
            if other.fingerprint(p) is not None:
                assert other.fingerprint(p) == store.fingerprint(p)
    lost, versions = read_back(h, h.instances[h.addr(2)], acked)
    assert lost == []
    return {"identity": (identity.high, identity.low), "recovered": recovered,
            "versions": sorted(versions.items()), "fingerprints": fingerprints(h)}


@pytest.mark.parametrize("scenario,seed", [
    (crashed_node_rejoins_with_old_identity_and_replays, 19),
    (torn_wal_tail_truncates_and_cluster_converges, 29)],
    ids=["old_identity_rejoin", "torn_tail_rejoin"])
def test_cluster_recovery_twin(scenario, seed, tmp_path):
    twin(lambda h: scenario(h, tmp_path), seed=seed, settings=durable_settings)


def test_durability_kill_switch_off_ignores_the_directory(tmp_path):
    """With ``settings.durability`` off (the default) ``use_durability``
    mounts nothing: the member runs on no store and writes no file, as
    JAX's does."""
    def scenario(h):
        d = str(tmp_path / h.P.name)
        h.start_seed(0, placement=PLACEMENT, durability=d)
        cluster = h.instances[h.addr(0)]
        assert cluster.get_partition_store() is None and not os.path.exists(d)
        return cluster.get_handoff_status()

    twin(scenario, seed=2)


def test_cluster_status_carries_the_durability_digest(tmp_path):
    """A durable member's status RPC reports its segments, snapshot version
    and replayed records; a graceful shutdown checkpoints, so the next boot
    replays nothing."""
    def scenario(h):
        d = str(tmp_path / h.P.name)
        cluster = h.start_seed(0, placement=PLACEMENT, serving=True, durability=d)
        acked = {}
        drive(h, cluster, acked, 6, b"s")
        status = cluster.get_cluster_status()
        row = (status.durability_segments, status.durability_snapshot_version,
               status.durability_replayed)
        h.shutdown()
        D = h.P.durability
        again = D.DurablePartitionStore(d, fsync_policy=D.FSYNC_NEVER)
        out = row, stats(again), sorted(acked.items()), files(d)
        again.close()
        assert out[1]["replayed_records"] == 0 and out[1]["snapshot_version"] >= 1
        return out

    twin(scenario, seed=4, settings=durable_settings)
