"""The port's live handoff engine (``rapid_tpu_torch.handoff.engine``) against
the JAX package's, whole clusters at a time on the CPU.

The live-engine cases of ``tests/test_handoff.py`` (join bootstrap and
removal convergence, placement required, the nemesis battery on the pull
RPCs under every plan, a source crash mid-session) run once on each package
through ``TwinHarness`` with the same seeds and plans. Each scenario's own
checks hold on both, and the outcomes are equal exactly: every view change,
every member's session counts, its store's partitions and fingerprints, the
handoff counters of its registry, and the fault plane's counters.
"""

import pytest

from test_torch_cluster import twin

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py

PLACEMENT = {"partitions": 16, "replicas": 2, "seed": 5}
HANDOFF_COUNTERS = ("handoff.sessions_started", "handoff.sessions_completed",
                    "handoff.sessions_failed", "handoff.chunks_sent", "handoff.chunks_received",
                    "handoff.chunks_duplicate", "handoff.bytes_moved", "handoff.retries",
                    "handoff.failovers", "handoff.releases", "handoff.fingerprint_mismatches")


def payload(p):
    """Deterministic per-partition content; partitions 1 and 7 exceed the
    engine's 64 KiB default chunk, so the windowed multi-chunk pull runs."""
    size = (p * 977) % 3000 + (70_000 if p in (1, 7) else 0)
    return bytes((p * 7 + i) % 251 for i in range(size))


def seeded_store(P):
    store = P.handoff_store.InMemoryPartitionStore()
    for p in range(PLACEMENT["partitions"]):
        store.put(p, payload(p))
    return store


def drain(h, timeout_ms=600_000):
    assert h.scheduler.run_until(
        lambda: all(inst.get_handoff_status()[0] == 0 for inst in h.instances.values()),
        timeout_ms=timeout_ms), "handoff sessions failed to drain in bounded virtual time"


def verify_replicas(h):
    """Every replica the agreed map names holds byte-correct content."""
    maps = [inst.get_placement_map() for inst in h.instances.values()]
    assert len({m.version for m in maps}) == 1
    fingerprint = h.P.handoff_plan.content_fingerprint
    for p, row in enumerate(maps[0].assignments):
        for ep in row:
            data = h.instances[ep].get_partition_store().get(p)
            assert data is not None, (p, str(ep))
            assert fingerprint(p, data) == fingerprint(p, payload(p)), (p, str(ep))
    return maps[0].version, [[str(ep) for ep in row] for row in maps[0].assignments]


def handoff_state(h):
    """Each member's sessions, store digest and handoff counters."""
    out = []
    for ep, inst in sorted(h.instances.items(), key=lambda kv: str(kv[0])):
        metrics = inst._membership_service.metrics  # noqa: SLF001
        out.append((str(ep), inst.get_handoff_status(), inst.get_partition_store().digest(),
                    [metrics.get(name) for name in HANDOFF_COUNTERS]))
    return out


def join_and_removal_convergence(h):
    P = h.P
    h.start_seed(0, placement=PLACEMENT, handoff=seeded_store(P))
    for i in (1, 2):
        h.join(i, placement=PLACEMENT, handoff=P.handoff_store.InMemoryPartitionStore)
    h.wait_and_verify_agreement(3)
    drain(h)
    first = verify_replicas(h)
    for i in (1, 2):
        inst = h.instances[h.addr(i)]
        in_flight, completed, failed = inst.get_handoff_status()
        assert (in_flight, failed) == (0, 0) and completed > 0
        assert inst.get_partition_store().partitions()
    joined = handoff_state(h)
    h.fail_nodes([h.addr(2)])
    h.wait_and_verify_agreement(2)
    drain(h)
    second = verify_replicas(h)
    assert sum(inst.get_handoff_status()[1] for inst in h.instances.values()) > 0
    assert all(inst.get_handoff_status()[2] == 0 for inst in h.instances.values())
    status = h.instances[h.addr(0)].get_cluster_status()
    return {"first": first, "joined": joined, "second": second, "after": handoff_state(h),
            "status": (status.handoff_in_flight, status.handoff_completed,
                       status.handoff_failed, status.handoff_partitions,
                       status.handoff_fingerprints)}


def test_cluster_handoff_join_and_removal_convergence_twin():
    twin(join_and_removal_convergence, seed=3)


def test_use_handoff_requires_placement_twin():
    """``use_handoff`` without ``use_placement`` raises JAX's ``ValueError``
    and leaves no member behind."""
    def scenario(h):
        with pytest.raises(ValueError) as err:
            h.start_seed(0, handoff=h.P.handoff_store.InMemoryPartitionStore())
        return str(err.value), len(h.instances)

    assert twin(scenario, seed=1)["extra"] == ("handoff requires placement to be configured", 0)


def drop_plan(P):
    return P.faults.FaultPlan(seed=13).drop(0.3, msg_types=(P.types.HandoffRequest,))


def duplicate_plan(P):
    return P.faults.FaultPlan(seed=13).duplicate(0.4, msg_types=(P.types.HandoffRequest,))


def reorder_plan(P):
    return P.faults.FaultPlan(seed=13).reorder(0.5, max_extra_ms=40,
                                               msg_types=(P.types.HandoffRequest,))


def combo_plan(P):
    kinds = (P.types.HandoffRequest,)
    return (P.faults.FaultPlan(seed=13).drop(0.2, msg_types=kinds)
            .duplicate(0.2, msg_types=kinds).reorder(0.3, max_extra_ms=25, msg_types=kinds))


def nemesis_counters(h):
    return sorted((k, v) for k, v in h.nemesis.metrics.snapshot().items()
                  if k.startswith("nemesis"))


@pytest.mark.parametrize("plan_fn", [drop_plan, duplicate_plan, reorder_plan, combo_plan],
                         ids=["drop", "duplicate", "reorder", "drop+dup+reorder"])
def test_handoff_converges_under_nemesis_twin(plan_fn):
    """Drops, duplicates and reorders on the pull RPCs from time zero: both
    packages converge to verified ownership through the same retries,
    duplicates and failovers."""
    def scenario(h):
        P = h.P
        h.with_faults(plan_fn(P))
        h.nemesis.arm()
        h.start_seed(0, placement=PLACEMENT, handoff=seeded_store(P))
        for i in (1, 2):
            h.join(i, placement=PLACEMENT, handoff=P.handoff_store.InMemoryPartitionStore)
        h.wait_and_verify_agreement(3)
        drain(h)
        first = verify_replicas(h), handoff_state(h)
        h.fail_nodes([h.addr(2)])
        h.wait_and_verify_agreement(2)
        drain(h)
        return first, verify_replicas(h), handoff_state(h), nemesis_counters(h)

    twin(scenario, seed=3)


def source_crash_mid_session(h):
    P = h.P
    placement = {"partitions": 16, "replicas": 3, "seed": 5}
    h.with_faults(P.faults.FaultPlan(seed=4).delay(base_ms=400,
                                                   msg_types=(P.types.HandoffRequest,)))
    h.nemesis.arm(epoch_ms=1 << 40)  # dormant while the cluster forms
    h.start_seed(0, placement=placement, handoff=seeded_store(P))
    for i in (1, 2, 3):
        h.join(i, placement=placement, handoff=P.handoff_store.InMemoryPartitionStore)
    h.wait_and_verify_agreement(4)
    drain(h)
    h.nemesis.arm()
    h.fail_nodes([h.addr(3)])
    assert h.scheduler.run_until(
        lambda: any(inst.get_handoff_status()[0] > 0 for inst in h.instances.values()),
        timeout_ms=300_000), "no handoff session observed in flight"
    in_flight = [inst.get_handoff_status() for inst in h.instances.values()]
    h.fail_nodes([h.addr(2)])
    h.wait_and_verify_agreement(2)
    drain(h)
    out = verify_replicas(h)
    assert all(inst.get_handoff_status()[2] == 0 for inst in h.instances.values())
    return in_flight, out, handoff_state(h), nemesis_counters(h)


def test_handoff_source_crash_mid_session_twin():
    twin(source_crash_mid_session, seed=6)
