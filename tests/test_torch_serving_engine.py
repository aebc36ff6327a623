"""The port's live serving engine (``rapid_tpu_torch.serving.engine``) against
the JAX package's, on the CPU.

Two levels, as in ``tests/test_serving.py``:

- whole clusters through ``TwinHarness``: ``use_serving`` without placement
  or handoff raising JAX's ``ValueError``, quorum writes read back across a
  view change whose handoff sessions a ``FaultPlan`` delay keeps in flight
  (the promote-time sync races them), and a hot key's leader crashing under
  drops, duplicates and reorders on the replication wire. Each runs once on
  each package with the same seeds and plans; every view change, acked
  version, read, serving counter and store digest is equal;
- the engine alone on a stub client (the unit cases of
  ``tests/test_serving.py``): the same calls on each package send the same
  messages to the same members and answer the same acks, with the
  ``RAPID_BUG_NEWROW_SYNC`` seam read at call time on both.
"""

import dataclasses

import pytest

from test_torch_cluster import PACKAGES, package, twin

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py

PLACEMENT = {"partitions": 16, "replicas": 3, "seed": 5}
SERVING_COUNTERS = ("serving.gets", "serving.puts", "serving.put_acks", "serving.put_retries",
                    "serving.replication_writes", "serving.leader_reads",
                    "serving.quorum_reads", "serving.not_leader_redirects",
                    "serving.leader_changes")


def plain(value):
    """A message, ack or endpoint as plain values (class name, fields)."""
    if hasattr(value, "hostname") and hasattr(value, "port"):
        return str(value)
    if dataclasses.is_dataclass(value):
        return (type(value).__name__,
                tuple((f.name, plain(getattr(value, f.name))) for f in dataclasses.fields(value)))
    if isinstance(value, (list, tuple)):
        return tuple(plain(v) for v in value)
    return value


# --------------------------------------------------------------------- #
# Whole clusters
# --------------------------------------------------------------------- #


def await_(h, promise, timeout_ms=600_000):
    assert h.scheduler.run_until(promise.done, timeout_ms=timeout_ms)
    assert promise.exception() is None, promise.exception()
    return promise.peek()


def put_until_acked(h, cluster, key, value, attempts=300):
    OK = h.P.types.PutAck.STATUS_OK
    for _ in range(attempts):
        ack = await_(h, cluster.serving_put(key, value))
        if ack.status == OK:
            return ack
    raise AssertionError(f"put {key!r} never acked in {attempts} attempts")


def get_until_found(h, cluster, key, attempts=300):
    OK = h.P.types.PutAck.STATUS_OK
    for _ in range(attempts):
        ack = await_(h, cluster.serving_get(key))
        if ack.status == OK:
            return ack
    raise AssertionError(f"get {key!r} never resolved in {attempts} attempts")


def serving_state(h):
    """Each member's serving status, leaders, counters and store digest."""
    out = []
    for ep, inst in sorted(h.instances.items(), key=lambda kv: str(kv[0])):
        service = inst._membership_service  # noqa: SLF001
        out.append((str(ep), inst.get_serving_status(), service.serving_engine().leader_digest(),
                    [service.metrics.get(name) for name in SERVING_COUNTERS],
                    inst.get_partition_store().digest(), inst.get_handoff_status()))
    return out


def serving_cluster(h, n):
    P = h.P
    h.start_seed(0, placement=PLACEMENT, handoff=P.handoff_store.InMemoryPartitionStore(),
                 serving=True)
    for i in range(1, n):
        h.join(i, placement=PLACEMENT, handoff=P.handoff_store.InMemoryPartitionStore,
               serving=True)
    h.wait_and_verify_agreement(n)


def test_use_serving_requires_placement_and_handoff_twin():
    """``use_serving`` without placement, and with placement but no handoff
    store, raises JAX's ``ValueError`` on both packages."""
    def scenario(h):
        out = []
        for kw in ({}, {"placement": PLACEMENT}):
            with pytest.raises(ValueError) as err:
                h.start_seed(0, serving=True, **kw)
            out.append(str(err.value))
        return out, len(h.instances)

    out = twin(scenario, seed=1)["extra"]
    assert out == (["serving requires placement and handoff to be configured"] * 2, 0)


def quorum_write_read_your_writes_across_view_change(h):
    P = h.P
    h.with_faults(P.faults.FaultPlan(seed=4).delay(base_ms=300,
                                                   msg_types=(P.types.HandoffRequest,)))
    h.nemesis.arm(epoch_ms=1 << 40)
    serving_cluster(h, 4)
    writer = h.instances[h.addr(0)]
    keys = [b"rw-%02d" % i for i in range(24)]
    acked = {}
    for i, key in enumerate(keys):
        acked[key] = (put_until_acked(h, writer, key, b"v-%d" % i).version, b"v-%d" % i)
    reader = h.instances[h.addr(1)]
    reads = []
    for key, (version, value) in acked.items():
        ack = get_until_found(h, reader, key)
        assert ack.value == value and ack.version >= version
        reads.append(plain(ack))
    h.nemesis.arm()
    h.fail_nodes([h.addr(3)])
    for key, (version, value) in acked.items():
        ack = get_until_found(h, reader, key)
        assert ack.value == value and ack.version >= version, key
        reads.append(plain(ack))
    churn_ms = h.scheduler.now_ms()
    h.wait_and_verify_agreement(3)
    third = h.instances[h.addr(2)]
    for key in keys[:8]:
        ack = put_until_acked(h, writer, key, b"post-" + key)
        got = get_until_found(h, third, key)
        assert got.value == b"post-" + key and got.version >= ack.version
        reads.append((plain(ack), plain(got)))
    gets, puts, put_acks = writer.get_serving_status()
    assert puts >= len(keys) and put_acks > 0
    return {"acked": sorted(acked.items()), "reads": reads, "churn_ms": churn_ms,
            "state": serving_state(h),
            "nemesis": sorted(h.nemesis.metrics.snapshot().items())}


def test_quorum_write_read_your_writes_across_view_change_twin():
    twin(quorum_write_read_your_writes_across_view_change, seed=3)


def leader_of(cluster, key, kv):
    pmap = cluster.get_placement_map()
    return pmap.assignments[kv.partition_of(key, len(pmap.assignments))][0]


def leader_failover_mid_write_under_nemesis(h):
    P = h.P
    kinds = (P.types.Put,)
    h.with_faults(P.faults.FaultPlan(seed=13).drop(0.2, msg_types=kinds)
                  .duplicate(0.2, msg_types=kinds).reorder(0.3, max_extra_ms=25, msg_types=kinds))
    h.nemesis.arm(epoch_ms=1 << 40)
    serving_cluster(h, 4)
    writer = h.instances[h.addr(0)]
    key = next(k for k in (b"hot-%02d" % i for i in range(64))
               if leader_of(writer, k, P.serving_kv) != h.addr(0))
    victim = leader_of(writer, key, P.serving_kv)
    h.nemesis.arm()
    versions = [put_until_acked(h, writer, key, b"pre-%d" % i).version for i in range(6)]
    assert versions == sorted(versions)
    h.fail_nodes([victim])
    versions += [put_until_acked(h, writer, key, b"mid-%d" % i).version for i in range(6)]
    h.wait_and_verify_agreement(3)
    final = put_until_acked(h, writer, key, b"final")
    versions.append(final.version)
    assert versions == sorted(versions) and len(set(versions)) == len(versions)
    reads = []
    for inst in h.instances.values():
        got = get_until_found(h, inst, key)
        assert got.value == b"final" and got.version >= final.version
        reads.append(plain(got))
    return {"key": key, "victim": str(victim), "versions": versions, "reads": reads,
            "state": serving_state(h),
            "nemesis": sorted(h.nemesis.metrics.snapshot().items())}


def test_leader_failover_mid_write_under_nemesis_twin():
    twin(leader_failover_mid_write_under_nemesis, seed=6)


# --------------------------------------------------------------------- #
# The engine alone, on a stub client
# --------------------------------------------------------------------- #


class StubClient:
    """Records every send; the scenario completes the promises by hand."""

    def __init__(self, P):
        self.P = P
        self.sent = []  # (destination, message, promise)

    def send_message(self, node, msg):
        promise = self.P.runtime_futures.Promise()
        self.sent.append((node, msg, promise))
        return promise

    def probes(self, quorum):
        return [(node, msg, pr) for node, msg, pr in self.sent
                if isinstance(msg, self.P.types.Get) and msg.quorum == quorum]

    def log(self):
        return [(str(node), plain(msg)) for node, msg, _ in self.sent]


class Unit:
    """One package's names for an engine scenario."""

    def __init__(self, P):
        self.P = P
        self.T = P.types
        self.OK = P.types.PutAck.STATUS_OK
        self.RETRY = P.types.PutAck.STATUS_RETRY
        self.client = StubClient(P)

    def eps(self, n):
        return tuple(self.T.Endpoint.from_parts("node", 7000 + i) for i in range(n))

    def store(self):
        return self.P.handoff_store.InMemoryPartitionStore()

    def engine(self, store, me):
        return self.P.serving_engine.ServingEngine(store, me, self.client, None)

    def pmap(self, version, *rows):
        rows = tuple(tuple(r) for r in rows)
        members = []
        for row in rows:
            for node in row:
                if node not in members:
                    members.append(node)
        pl = self.P.placement
        return pl.PlacementMap(
            config=pl.PlacementConfig(partitions=len(rows),
                                      replicas=max((len(r) for r in rows), default=1)),
            configuration_id=1, version=version, members=tuple(members), assignments=rows)

    def snap_probe(self, sender, p, map_version):
        return self.T.Get(sender=sender, key=p.to_bytes(8, "little"), quorum=2,
                          map_version=map_version)

    def put(self, sender, key, value, request_id, version, map_version):
        return self.T.Put(sender=sender, key=key, value=value, request_id=request_id,
                          replicate=1, version=version, map_version=map_version)


def promote_sync_pulls_from_old_row_only(u):
    A, B, C, D = u.eps(4)
    encode_kv = u.P.serving_kv.encode_kv
    eng = u.engine(u.store(), B)
    eng.update_map(u.pmap(101, (A, B, C)))
    out = [plain(eng.handle_put(u.put(A, b"k", b"local", 1, 7, 101)).peek())]
    eng.update_map(u.pmap(202, (B, C, D)))
    assert eng.churned_partitions() == (0,)
    assert {node for node, _, _ in u.client.probes(quorum=2)} == {A, C}
    assert eng._churned[0] == ((A, C), 1)  # noqa: SLF001
    read = eng.handle_get(u.T.Get(sender=B, key=b"k", quorum=0))
    assert not read.done()
    assert {node for node, _, _ in u.client.probes(quorum=1)} == {A, C}
    for node, msg, pr in u.client.probes(quorum=1):
        if node == C:
            pr.set_result(u.T.PutAck(sender=C, status=u.OK, key=msg.key, value=b"acked",
                                     version=9, map_version=202))
    assert read.peek().version == 9 and read.peek().value == b"acked"
    out.append(plain(read.peek()))
    for node, msg, pr in u.client.probes(quorum=2):
        if node == C:
            pr.set_result(u.T.PutAck(sender=C, status=u.OK, key=msg.key,
                                     value=encode_kv({b"k": (9, b"acked")}), map_version=202))
    assert eng.churned_partitions() == ()
    got = eng.handle_get(u.T.Get(sender=B, key=b"k", quorum=0)).peek()
    assert got.status == u.OK and got.version == 9 and got.value == b"acked"
    return out + [plain(got), eng.status(), eng.leader_digest()]


def promote_sync_first_map_falls_back_to_new_row(u):
    B, C, D = u.eps(3)
    eng = u.engine(u.store(), B)
    eng.update_map(u.pmap(101, (B, C, D)))
    assert eng.churned_partitions() == (0,)
    assert {node for node, _, _ in u.client.probes(quorum=2)} == {C, D}


def snapshot_probe_abstains_until_acquisition_lands(u):
    B, C, D = u.eps(3)
    store = u.store()
    eng = u.engine(store, D)
    eng.update_map(u.pmap(202, (B, C, D)))
    probe = u.snap_probe(B, 0, 202)
    out = [plain(eng.handle_get(probe).peek()),
           plain(eng.handle_get(u.T.Get(sender=B, key=b"k", quorum=1)).peek())]
    assert [o[1][1][1] for o in out] == [u.RETRY, u.RETRY]
    store.put(0, u.P.serving_kv.encode_kv({b"k": (3, b"v")}))
    ans = eng.handle_get(probe).peek()
    assert ans.status == u.OK and u.P.serving_kv.decode_kv(ans.value) == {b"k": (3, b"v")}
    q1 = eng.handle_get(u.T.Get(sender=B, key=b"k", quorum=1)).peek()
    assert q1.status == u.OK and q1.version == 3
    return out + [plain(ans), plain(q1)]


def snapshot_probe_validates_partition_id(u):
    A, B, C = u.eps(3)
    eng = u.engine(u.store(), B)
    eng.update_map(u.pmap(101, (A, B), (A, C)))
    answers = [eng.handle_get(m).peek() for m in (
        u.snap_probe(A, 1, 101), u.snap_probe(A, 999, 101),
        u.T.Get(sender=A, key=b"\x01", quorum=2, map_version=101))]
    assert [a.status for a in answers] == [u.RETRY] * 3
    assert set(eng._kv) <= {0}  # noqa: SLF001
    return [plain(a) for a in answers]


def retired_replica_answers_sync_probes_for_one_view(u):
    A, B, C = u.eps(3)
    store = u.store()
    eng = u.engine(store, C)
    eng.update_map(u.pmap(101, (A, C)))
    eng.handle_put(u.put(A, b"k", b"v", 1, 5, 101)).peek()
    eng.update_map(u.pmap(202, (A, B)))
    store.delete(0)
    ans = eng.handle_get(u.snap_probe(B, 0, 202)).peek()
    assert ans.status == u.OK and u.P.serving_kv.decode_kv(ans.value)[b"k"] == (5, b"v")
    q1 = eng.handle_get(u.T.Get(sender=B, key=b"k", quorum=1)).peek()
    assert q1.status == u.OK and q1.version == 5
    eng.update_map(u.pmap(303, (A, B)))
    later = eng.handle_get(u.snap_probe(B, 0, 303)).peek()
    assert later.status == u.OK
    eng.update_map(u.pmap(404, (A, B)))
    gone = eng.handle_get(u.snap_probe(B, 0, 404)).peek()
    assert gone.status == u.RETRY
    return [plain(a) for a in (ans, q1, later, gone)]


def replica_rejects_skewed_map_and_foreign_partition(u):
    A, B, C = u.eps(3)
    partition_of = u.P.serving_kv.partition_of
    store = u.store()
    eng = u.engine(store, B)
    eng.update_map(u.pmap(202, (A, B), (A, C)))
    k0 = next(k for k in (b"pk-%d" % i for i in range(64)) if partition_of(k, 2) == 0)
    k1 = next(k for k in (b"pk-%d" % i for i in range(64)) if partition_of(k, 2) == 1)
    stale = eng.handle_put(u.put(A, k0, b"v", 1, 3, 101)).peek()
    assert stale.status == u.RETRY and store.partitions() == ()
    foreign = eng.handle_put(u.put(A, k1, b"v", 2, 3, 202)).peek()
    assert foreign.status == u.RETRY and store.partitions() == ()
    good = eng.handle_put(u.put(A, k0, b"v", 3, 3, 202)).peek()
    assert good.status == u.OK and store.partitions() == (0,)
    return [plain(a) for a in (stale, foreign, good)], store.digest()


def promote_sync_retries_inline_without_scheduler(u):
    A, B = u.eps(2)
    eng = u.engine(u.store(), B)
    eng.update_map(u.pmap(101, (A, B)))
    eng.update_map(u.pmap(202, (B, A)))
    probes = u.client.probes(quorum=2)
    assert len(probes) == 1 and probes[0][0] == A
    probes[0][2].set_exception(RuntimeError("peer down"))
    probes = u.client.probes(quorum=2)
    assert len(probes) == 2, "failed round must re-pull inline"
    _node, msg, pr = probes[1]
    pr.set_result(u.T.PutAck(sender=A, status=u.OK, key=msg.key,
                             value=u.P.serving_kv.encode_kv({}), map_version=202))
    assert eng.churned_partitions() == ()


def leader_write_replicates_and_acks_on_a_majority(u):
    """The leader half: a client Put is versioned, applied, fanned to the
    other replicas and acked once a majority applied."""
    A, B, C = u.eps(3)
    store = u.store()
    eng = u.engine(store, A)
    eng.update_map(u.pmap(101, (A, B, C)))
    for node, msg, pr in u.client.probes(quorum=2):
        pr.set_result(u.T.PutAck(sender=node, status=u.OK, key=msg.key,
                                 value=u.P.serving_kv.encode_kv({}), map_version=101))
    assert eng.churned_partitions() == ()
    promise = eng.handle_put(u.T.Put(sender=C, key=b"k", value=b"v1", request_id=4))
    assert not promise.done()
    fanned = [(node, msg, pr) for node, msg, pr in u.client.sent
              if isinstance(msg, u.T.Put)]
    assert {node for node, _, _ in fanned} == {B, C}
    node, msg, pr = fanned[0]
    pr.set_result(u.T.PutAck(sender=node, status=u.OK, key=msg.key, version=msg.version,
                             map_version=101))
    ack = promise.peek()
    assert ack.status == u.OK and ack.version == 1
    read = eng.handle_get(u.T.Get(sender=C, key=b"k")).peek()
    assert read.value == b"v1"
    return plain(ack), plain(read), eng.status(), eng.leader_digest(), store.digest()


def bug_newrow_sync_seam_pulls_from_the_new_row(u):
    """``RAPID_BUG_NEWROW_SYNC=1`` (set by the test) reintroduces the old
    sync-target bug: the promote-time sync pulls from the NEW row."""
    A, B, C, D = u.eps(4)
    eng = u.engine(u.store(), B)
    eng.update_map(u.pmap(101, (A, B, C)))
    eng.update_map(u.pmap(202, (B, C, D)))
    assert {node for node, _, _ in u.client.probes(quorum=2)} == {C, D}


UNIT_CASES = [promote_sync_pulls_from_old_row_only, promote_sync_first_map_falls_back_to_new_row,
              snapshot_probe_abstains_until_acquisition_lands,
              snapshot_probe_validates_partition_id,
              retired_replica_answers_sync_probes_for_one_view,
              replica_rejects_skewed_map_and_foreign_partition,
              promote_sync_retries_inline_without_scheduler,
              leader_write_replicates_and_acks_on_a_majority]


def unit_twin(scenario):
    outs = []
    for name in PACKAGES:
        u = Unit(package(name))
        outs.append((scenario(u), u.client.log()))
    assert outs[1] == outs[0]
    return outs[1]


@pytest.mark.parametrize("scenario", UNIT_CASES, ids=[f.__name__ for f in UNIT_CASES])
def test_engine_unit_twin(scenario):
    unit_twin(scenario)


def test_bug_newrow_sync_seam_is_read_at_call_time(monkeypatch):
    monkeypatch.setenv("RAPID_BUG_NEWROW_SYNC", "1")
    unit_twin(bug_newrow_sync_seam_pulls_from_the_new_row)
    monkeypatch.setenv("RAPID_BUG_NEWROW_SYNC", "0")
    unit_twin(promote_sync_pulls_from_old_row_only)


def parallel_bootstrap_rows_of_joiners(h):
    """A seed and 7 joiners racing in through one view change, placement
    256 x 3: a partition whose whole row joined at once has no copy to
    sync from, and its leader answers RETRY (a liveness fault of the JAX
    engine, reproduced). Returns each key's status."""
    P = h.P
    placement = {"partitions": 256, "replicas": 3, "seed": 5}
    h.start_seed(0, placement=placement, handoff=P.handoff_store.InMemoryPartitionStore(),
                 serving=True)
    promises = [h.join_async(i, placement=placement,
                             handoff=P.handoff_store.InMemoryPartitionStore, serving=True)
                for i in range(1, 8)]
    assert h.scheduler.run_until(lambda: all(p.done() for p in promises))
    h.wait_and_verify_agreement(8)
    writer = h.instances[h.addr(0)]
    statuses = [await_(h, writer.serving_put(b"bench-key-%04d" % k, b"v")).status
                 for k in range(8)]
    retry = P.types.PutAck.STATUS_RETRY
    assert statuses.count(retry) == 5 and set(statuses) == {P.types.PutAck.STATUS_OK, retry}
    return statuses


def test_parallel_bootstrap_leaves_rows_of_joiners_answering_retry_as_jax():
    twin(parallel_bootstrap_rows_of_joiners, seed=5)
