"""The port's protocol-plane building blocks against the JAX package's.

``MembershipView``, ``MultiNodeCutDetector``, ``Paxos`` / ``FastPaxos``, the
failure detectors (static, ping-pong, windowed ping-pong, adaptive) and
``Settings`` of ``rapid_tpu_torch`` run through the scenarios of
``tests/test_membership_view.py``, ``tests/test_cut_detection.py`` and
``tests/test_paxos.py``, and through seeded streams, on both packages with
the same seeds. Each scenario's own checks hold on both, and the two
outcomes (endpoints as strings, every other value as it is) are equal
exactly: no tolerance.
"""

import dataclasses
import importlib
import random
import types
import uuid

import pytest

PACKAGES = ("rapid_tpu", "rapid_tpu_torch")
MODULES = ("cut_detector", "fast_paxos", "membership", "messaging.base", "monitoring.adaptive",
           "monitoring.pingpong", "monitoring.static_fd", "paxos", "runtime.futures",
           "runtime.scheduler", "settings", "types")


def package(name):
    """The modules a scenario uses, of package ``name``, as attributes
    (dots become underscores)."""
    ns = types.SimpleNamespace(name=name)
    for module in MODULES:
        setattr(ns, module.replace(".", "_"), importlib.import_module(f"{name}.{module}"))
    return ns


def twin(scenario, *args):
    """``scenario(P, *args)`` on each package; the outcomes must be equal."""
    jax_out, port_out = (scenario(package(name), *args) for name in PACKAGES)
    assert port_out == jax_out
    return port_out


def s(value):
    """Endpoints (and containers of them) as strings, for comparing across
    packages."""
    if isinstance(value, (list, tuple)):
        return [s(v) for v in value]
    if isinstance(value, (set, frozenset)):
        return sorted(s(v) for v in value)
    if hasattr(value, "hostname") and hasattr(value, "port"):
        return str(value)
    if hasattr(value, "high") and hasattr(value, "low"):
        return (value.high, value.low)
    if hasattr(value, "round") and hasattr(value, "node_index"):
        return (value.round, value.node_index)
    return value


def ep(P, i, host="127.0.0.1"):
    return P.types.Endpoint.from_parts(host, i)


def nid(P, rng):
    return P.types.NodeId.from_uuid(uuid.UUID(int=rng.getrandbits(128)))


def raises(fn):
    """The class name of what ``fn()`` raises, or None."""
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 -- compared by name across packages
        return type(exc).__name__
    return None


# --------------------------------------------------------------------- #
# MembershipView (tests/test_membership_view.py)
# --------------------------------------------------------------------- #

K = 10


def view_ring_operations(P):
    m = P.membership
    rng = random.Random(0)
    view = m.MembershipView(K)
    out = {"ids": []}
    for i in range(30):
        view.ring_add(ep(P, i), nid(P, rng))
        out["ids"].append(view.get_current_configuration_id())
    out["rings"] = [s(view.get_ring(k)) for k in range(K)]
    for i in (0, 7, 29):
        node = ep(P, i)
        observers, subjects = view.get_observers_of(node), view.get_subjects_of(node)
        assert len(observers) == len(subjects) == K
        for k in range(K):
            ring = view.get_ring(k)
            idx = ring.index(node)
            assert observers[k] == ring[(idx + 1) % 30] and subjects[k] == ring[(idx - 1) % 30]
        out[f"observers {i}"], out[f"subjects {i}"] = s(observers), s(subjects)
        out[f"ring numbers {i}"] = view.get_ring_numbers(node, subjects[0])
    joiner = ep(P, 2000)
    expected = view.get_expected_observers_of(joiner)
    out["expected observers"] = s(expected)
    identifier = nid(P, rng)
    out["safe"] = [view.is_safe_to_join(ep(P, 1), nid(P, rng)).name,
                   view.is_safe_to_join(joiner, identifier).name]
    view.ring_add(joiner, identifier)
    assert view.get_subjects_of(joiner) == expected
    out["safe again"] = view.is_safe_to_join(ep(P, 3000), identifier).name
    out["errors"] = [raises(lambda: view.ring_add(ep(P, 1), nid(P, rng))),
                     raises(lambda: view.ring_delete(ep(P, 9999))),
                     raises(lambda: view.ring_add(ep(P, 4000), identifier)),
                     raises(lambda: m.MembershipView(0))]
    for i in (5, 17, 2000):
        view.ring_delete(ep(P, i))
        out["ids"].append(view.get_current_configuration_id())
    assert not view.is_host_present(ep(P, 5)) and view.membership_size == 28
    config = view.get_configuration()
    out["configuration"] = (s(config.node_ids), s(config.endpoints), config.configuration_id)
    rebuilt = m.MembershipView(K, node_ids=config.node_ids, endpoints=config.endpoints)
    assert rebuilt.get_current_configuration_id() == view.get_current_configuration_id()
    single = m.MembershipView(K)
    single.ring_add(ep(P, 1), nid(P, rng))
    assert single.get_observers_of(ep(P, 1)) == [] == single.get_subjects_of(ep(P, 1))
    return out


def view_configuration_ids_are_unique(P, n=400):
    rng = random.Random(5)
    view = P.membership.MembershipView(K)
    ids = []
    for i in range(n):
        view.ring_add(ep(P, i), nid(P, rng))
        ids.append(view.get_current_configuration_id())
    assert len(set(ids)) == n
    return ids


def view_order_independence(P):
    rng = random.Random(6)
    nodes = [(ep(P, i), nid(P, rng)) for i in range(50)]
    v1, v2 = P.membership.MembershipView(K), P.membership.MembershipView(K)
    for node, identifier in nodes:
        v1.ring_add(node, identifier)
    shuffled = nodes[:]
    random.Random(7).shuffle(shuffled)
    for node, identifier in shuffled:
        v2.ring_add(node, identifier)
    assert v1.get_current_configuration_id() == v2.get_current_configuration_id()
    assert v1.get_ring(0) == v2.get_ring(0)
    assert len({tuple(v1.get_ring(k)) for k in range(K)}) == K
    return v1.get_current_configuration_id(), s(v1.get_ring(3))


def view_bulk_path_equals_incremental(P, n=700):
    """The bulk bootstrap (more than 256 endpoints, the port's numpy
    ``endpoint_hash_batch``) builds what ``ring_add`` one at a time builds."""
    rng = random.Random(11)
    endpoints = [ep(P, 1000 + i, host=f"10.1.{i // 256}.{i % 256}") for i in range(n)]
    ids = [nid(P, rng) for _ in range(n)]
    bulk = P.membership.MembershipView(K, node_ids=ids, endpoints=endpoints)
    one_by_one = P.membership.MembershipView(K)
    for e, i in zip(endpoints, ids):
        one_by_one.ring_add(e, i)
    for k in range(K):
        assert bulk.get_ring(k) == one_by_one.get_ring(k)
    assert bulk._hash_cache == one_by_one._hash_cache  # noqa: SLF001
    assert bulk.get_current_configuration_id() == one_by_one.get_current_configuration_id()
    return bulk.get_current_configuration_id(), [s(bulk.get_ring(k)[:20]) for k in range(K)]


@pytest.mark.parametrize("scenario", [view_ring_operations, view_configuration_ids_are_unique,
                                      view_order_independence, view_bulk_path_equals_incremental],
                         ids=lambda f: f.__name__)
def test_membership_view_twin(scenario):
    twin(scenario)


# --------------------------------------------------------------------- #
# MultiNodeCutDetector (tests/test_cut_detection.py)
# --------------------------------------------------------------------- #

CD_K, CD_H, CD_L = 10, 8, 2


def alert(P, src, dst, status, ring, config_id=-1):
    return P.types.AlertMessage(edge_src=src, edge_dst=dst, edge_status=status,
                                configuration_id=config_id, ring_numbers=(ring,))


def cut_detector_watermarks(P):
    """The reference's scenarios: proposal at the H-th report, duplicates,
    one and three blockers, blockers past H, below L, a batch, clear."""
    cd, T = P.cut_detector, P.types
    up = T.EdgeStatus.UP
    out = {"invalid": [raises(lambda: cd.MultiNodeCutDetector(CD_K, CD_K + 1, CD_L)),
                       raises(lambda: cd.MultiNodeCutDetector(CD_K, 3, 4)),
                       raises(lambda: cd.MultiNodeCutDetector(2, 2, 1)),
                       raises(lambda: cd.MultiNodeCutDetector(CD_K, CD_H, 0))]}
    src = [ep(P, i) for i in range(CD_K + 1)]
    dsts = [ep(P, 2, f"127.0.0.{h}") for h in range(2, 7)]
    rows = []
    wb = cd.MultiNodeCutDetector(CD_K, CD_H, CD_L)
    for i in range(CD_H):
        rows.append(s(wb.aggregate_for_proposal(alert(P, src[i + 1], dsts[0], up, i))))
    rows.append(("proposals", wb.num_proposals))
    for _ in range(CD_H):
        rows.append(s(wb.aggregate_for_proposal(alert(P, src[1], dsts[1], up, 0))))
    rows.append(("proposals", wb.num_proposals, wb.occupancy()))
    for blockers in (1, 3):
        wb = cd.MultiNodeCutDetector(CD_K, CD_H, CD_L)
        for d in dsts[:blockers + 1]:
            for i in range(CD_H - 1):
                rows.append(s(wb.aggregate_for_proposal(alert(P, src[i + 1], d, up, i))))
        for d in dsts[:blockers + 1]:
            rows.append(s(wb.aggregate_for_proposal(alert(P, src[CD_H], d, up, CD_H - 1))))
        for d in dsts[:blockers + 1]:
            rows.append(s(wb.aggregate_for_proposal(alert(P, src[CD_H + 1], d, up, CD_H))))
        rows.append(("proposals", wb.num_proposals, wb.occupancy()))
    wb = cd.MultiNodeCutDetector(CD_K, CD_H, CD_L)
    for i in range(CD_H - 1):
        rows.append(s(wb.aggregate_for_proposal(alert(P, src[i + 1], dsts[0], up, i))))
    for i in range(CD_L - 1):
        rows.append(s(wb.aggregate_for_proposal(alert(P, src[i + 1], dsts[1], up, i))))
    rows.append(s(wb.aggregate_for_proposal(alert(P, src[CD_H], dsts[0], up, CD_H - 1))))
    wb.clear()
    rows.append(("cleared", wb.num_proposals, wb.occupancy()))
    out["rows"] = rows
    return out


def cut_detector_link_invalidation(P):
    """Implicit detection against a real view: the failing nodes' observers
    are themselves failing (tests/test_cut_detection.py::test_link_invalidation)."""
    rng = random.Random(3)
    view = P.membership.MembershipView(CD_K)
    for i in range(30):
        view.ring_add(ep(P, i), nid(P, rng))
    wb = P.cut_detector.MultiNodeCutDetector(CD_K, CD_H, CD_L)
    dst = ep(P, 13)
    observers = view.get_observers_of(dst)
    failed = set(observers[:3])
    rows = []
    for k, observer in enumerate(observers):
        if observer in failed:
            continue
        rows.append(s(wb.aggregate_for_proposal(
            alert(P, observer, dst, P.types.EdgeStatus.DOWN, k))))
    for f in sorted(failed, key=str):
        for k, observer in enumerate(view.get_observers_of(f)):
            if observer not in failed:
                rows.append(s(wb.aggregate_for_proposal(
                    alert(P, observer, f, P.types.EdgeStatus.DOWN, k))))
    rows.append(s(sorted(wb.invalidate_failing_edges(view), key=str)))
    rows.append((wb.num_proposals, wb.occupancy()))
    return rows


def cut_detector_seeded_stream(P, seed):
    """A seeded stream of alerts (random sources, destinations, rings and
    statuses, duplicates included) against a 40-member view, with an
    invalidation pass every 25 alerts."""
    rng = random.Random(seed)
    view = P.membership.MembershipView(CD_K)
    for i in range(40):
        view.ring_add(ep(P, i), nid(P, rng))
    wb = P.cut_detector.MultiNodeCutDetector(CD_K, CD_H, CD_L)
    statuses = [P.types.EdgeStatus.UP, P.types.EdgeStatus.DOWN]
    rows = []
    for step in range(400):
        a = alert(P, ep(P, rng.randrange(40)), ep(P, rng.randrange(8)),
                  statuses[rng.random() < 0.7], rng.randrange(CD_K))
        rows.append(s(wb.aggregate_for_proposal(a)))
        if step % 25 == 24:
            rows.append(s(sorted(wb.invalidate_failing_edges(view), key=str)))
    rows.append((wb.num_proposals, wb.occupancy()))
    return rows


@pytest.mark.parametrize("scenario,args", [(cut_detector_watermarks, ()),
                                           (cut_detector_link_invalidation, ()),
                                           (cut_detector_seeded_stream, (1,)),
                                           (cut_detector_seeded_stream, (2,))],
                         ids=["watermarks", "link_invalidation", "stream_1", "stream_2"])
def test_cut_detector_twin(scenario, args):
    twin(scenario, *args)


# --------------------------------------------------------------------- #
# Paxos and FastPaxos (tests/test_paxos.py)
# --------------------------------------------------------------------- #


class NoOpNet:
    """A client and broadcaster that send nowhere."""

    def __init__(self, P):
        self.P = P

    def send_message(self, remote, msg):
        return self.P.runtime_futures.Promise.completed(None)

    send_message_best_effort = send_message

    def broadcast(self, msg):
        return []

    def set_membership(self, recipients):
        pass

    def shutdown(self):
        pass


def hosts(P, *specs):
    return tuple(P.types.Endpoint.from_string(spec) for spec in specs)


def coordinator_rule(P, seed):
    """Shuffled quorums of phase1b messages at mixed ranks through
    ``select_proposal_using_coordinator_rule`` (PaxosTests.java:252-286)."""
    T = P.types
    rng = random.Random(seed)
    proposals = [hosts(P, "127.0.0.1:5891", "127.0.0.1:5821"),
                 hosts(P, "127.0.0.1:5821", "127.0.0.1:5872"), hosts(P, "127.0.0.1:1")]
    addr = ep(P, 1234)
    out = []
    for _ in range(60):
        n = rng.choice((5, 6, 9, 12))
        paxos = P.paxos.Paxos(addr, 1, n, NoOpNet(P), NoOpNet(P), lambda v: None)
        msgs = []
        for i in range(n):
            which = rng.randrange(3)
            rank = T.Rank(rng.randrange(3), rng.randrange(2**31))
            value = proposals[which] if rng.random() < 0.8 else ()
            msgs.append(T.Phase1bMessage(sender=addr, configuration_id=1, rnd=rank, vrnd=rank,
                                         vval=value))
        rng.shuffle(msgs)
        out.append(s(paxos.select_proposal_using_coordinator_rule(msgs[: n // 2 + 1])))
    empty = P.paxos.Paxos(addr, 1, 5, NoOpNet(P), NoOpNet(P), lambda v: None)
    out.append(raises(lambda: empty.select_proposal_using_coordinator_rule([])))
    out.append([P.paxos.paxos_node_index(ep(P, i)) for i in range(20)])
    return out


def fast_round_votes(P, seed):
    """Seeded fast rounds at the quorum table's sizes: identical votes,
    conflicts, duplicates and other configurations, one vote at a time."""
    T = P.types
    rng = random.Random(seed)
    out = []
    for n in (5, 6, 48, 49, 50, 51, 99, 100):
        decided = []
        fp = P.fast_paxos.FastPaxos(ep(P, 1), 7, n, NoOpNet(P), NoOpNet(P),
                                    P.runtime_scheduler.VirtualScheduler(), decided.append,
                                    rng=random.Random(0))
        values = [hosts(P, "127.0.0.9:1"), hosts(P, "127.0.0.9:2"),
                  hosts(P, "127.0.0.9:1", "127.0.0.9:3")]
        for _ in range(2 * n):
            voter = ep(P, 10_000 + rng.randrange(n + 3))
            config = 7 if rng.random() < 0.95 else 99
            value = values[0] if rng.random() < 0.85 else rng.choice(values)
            fp.handle_messages(T.FastRoundPhase2bMessage(sender=voter, configuration_id=config,
                                                         endpoints=value))
            out.append((n, fp.votes_received, fp.decided, s(decided)))
    return out


def vote_batches(P, seed):
    """Batches of identical votes through the service's path (the port tallies
    a batch at once, ``FastPaxos.handle_vote_batch``; JAX one vote at a time),
    mixed with single votes: duplicates inside and across batches, another
    configuration, a decision in the middle of a batch and votes after it."""
    T = P.types
    rng = random.Random(seed)
    out = []
    for n in (6, 50, 101):
        decided = []
        metrics = importlib.import_module(P.name + ".observability").Metrics()
        fp = P.fast_paxos.FastPaxos(ep(P, 1), 7, n, NoOpNet(P), NoOpNet(P),
                                    P.runtime_scheduler.VirtualScheduler(), decided.append,
                                    rng=random.Random(0), metrics=metrics)
        value, other = hosts(P, "127.0.0.9:1"), hosts(P, "127.0.0.9:2")
        for _ in range(40):
            senders = tuple(ep(P, 10_000 + rng.randrange(n + 2)) for _ in range(rng.randrange(1, n)))
            if rng.random() < 0.3:
                msg = T.FastRoundPhase2bMessage(sender=senders[0], configuration_id=7,
                                                endpoints=rng.choice((value, other)))
                fp.handle_messages(msg)
            else:
                batch = T.FastRoundVoteBatch(
                    senders=senders, configuration_id=7 if rng.random() < 0.9 else 8,
                    endpoints=value if rng.random() < 0.95 else other)
                if hasattr(fp, "handle_vote_batch"):
                    fp.handle_vote_batch(batch)
                else:  # rapid_tpu's MembershipService._handle_vote_batch
                    for sender in batch.senders:
                        fp.handle_messages(T.FastRoundPhase2bMessage(
                            sender=sender, configuration_id=batch.configuration_id,
                            endpoints=batch.endpoints))
            out.append((n, fp.votes_received, fp.decided, s(decided)))
        out.append(sorted(metrics.snapshot().items()))
    assert any(row[2] for row in out if len(row) == 4)
    return out


def classic_round(P, n):
    """N Paxos instances wired directly: one coordinator runs phase 1a to 2b
    and every node decides the value the fast round voted
    (tests/test_paxos.py::test_classic_fallback_end_to_end)."""
    addrs = [ep(P, 4000 + i) for i in range(n)]
    nodes, decisions, sent = {}, {}, []
    handlers = {"Phase1aMessage": "handle_phase1a", "Phase1bMessage": "handle_phase1b",
                "Phase2aMessage": "handle_phase2a", "Phase2bMessage": "handle_phase2b"}

    class Net(NoOpNet):
        def send_message(self, remote, msg):
            sent.append((str(remote), type(msg).__name__))
            getattr(nodes[remote], handlers[type(msg).__name__])(msg)
            return P.runtime_futures.Promise.completed(None)

        send_message_best_effort = send_message

        def broadcast(self, msg):
            sent.append(("*", type(msg).__name__))
            for node in list(nodes.values()):
                getattr(node, handlers[type(msg).__name__])(msg)
            return []

    net = Net(P)
    for addr in addrs:
        nodes[addr] = P.paxos.Paxos(addr, 1, n, net, net,
                                    lambda v, a=addr: decisions.setdefault(a, tuple(v)))
    value = hosts(P, "10.0.0.1:1", "10.0.0.2:2")
    for node in nodes.values():
        node.register_fast_round_vote(value)
    nodes[addrs[0]].start_phase1a(2)
    assert len(decisions) == n and set(decisions.values()) == {value}
    return sent, sorted((str(a), s(v)) for a, v in decisions.items())


def fast_paxos_fallback_timer(P, seed):
    """The classic-round fallback delay: base + Exp(mean N s) jitter drawn from
    the seeded rng, and the phase 1a the timer starts."""
    sent = []

    class Net(NoOpNet):
        def broadcast(self, msg):
            sent.append((type(msg).__name__, s(getattr(msg, "rank", None))))
            return []

    sched = P.runtime_scheduler.VirtualScheduler()
    fp = P.fast_paxos.FastPaxos(ep(P, 1), 7, 12, Net(P), Net(P), sched, lambda v: None,
                                rng=random.Random(seed))
    fp.propose(list(hosts(P, "127.0.0.9:1")))
    sched.run_for(120_000)
    assert [name for name, _ in sent] == ["FastRoundPhase2bMessage", "Phase1aMessage"]
    return sent, sched.now_ms()


@pytest.mark.parametrize("scenario,args", [(coordinator_rule, (1,)), (coordinator_rule, (2,)),
                                           (fast_round_votes, (3,)), (vote_batches, (4,)),
                                           (vote_batches, (5,)), (classic_round, (5,)),
                                           (classic_round, (8,)),
                                           (fast_paxos_fallback_timer, (6,))],
                         ids=["coordinator_1", "coordinator_2", "fast_round", "vote_batches_4",
                              "vote_batches_5", "classic_5", "classic_8", "fallback_timer"])
def test_paxos_twin(scenario, args):
    twin(scenario, *args)


# --------------------------------------------------------------------- #
# Failure detectors
# --------------------------------------------------------------------- #


class ScriptedProbes:
    """A probe client on a virtual clock: each subject answers after its lag
    in ms, or never (None: the promise fails at once, like a deadline)."""

    def __init__(self, P, sched, rng, subjects):
        self.P, self.sched, self.rng, self.subjects = P, sched, rng, subjects
        self.sent = []

    def send_message_best_effort(self, remote, msg):
        self.sent.append((str(remote), type(msg).__name__))
        p = self.P.runtime_futures.Promise()
        roll = self.rng.random()
        if roll < 0.25:
            p.try_set_exception(TimeoutError(f"{remote}"))
        else:
            lag = int(5 + 400 * roll * roll) if str(remote).endswith("3") else 10
            self.sched.schedule(lag, lambda: p.try_set_result(self.P.types.ProbeResponse()))
        return p

    send_message = send_message_best_effort


def failure_detectors(P, kind, seed):
    """One detector per subject ticked every 250 virtual ms against seeded
    probe outcomes: which fire and when, the probes sent, and the factory's
    digests (RTTs, suspicion, per-tier parameters) where it has them."""
    sched = P.runtime_scheduler.VirtualScheduler()
    observer = ep(P, 40, "10.9.0.1")
    subjects = [ep(P, 50, f"10.9.0.{i}") for i in range(2, 6)]
    client = ScriptedProbes(P, sched, random.Random(seed), subjects)
    metrics = importlib.import_module(P.name + ".observability").Metrics()
    settings = P.settings
    if kind == "static":
        blacklist = {subjects[1]}
        factory = P.monitoring_static_fd.StaticFailureDetectorFactory(blacklist)
    elif kind == "pingpong":
        factory = P.monitoring_pingpong.PingPongFailureDetectorFactory(
            observer, client, failure_threshold=5, metrics=metrics, clock=sched.now_ms)
    elif kind == "windowed":
        factory = P.monitoring_pingpong.WindowedPingPongFailureDetectorFactory(
            observer, client, window=6, threshold=0.5, metrics=metrics, clock=sched.now_ms)
    else:
        factory = P.monitoring_adaptive.AdaptivePingPongFactory(
            observer, client, settings.Settings(adaptive_fd=settings.AdaptiveFdSettings(
                enabled=True, warmup_probes=2, gray_confirm=2)),
            metrics=metrics, clock=sched.now_ms,
            tier_of=lambda e: "rack" if str(e).startswith("10.9.0.2") else "wan")
    begin = getattr(factory, "begin_configuration", None)
    if begin is not None:
        begin(tuple(subjects))
    fired = []
    detectors = [factory.create_instance(subj, lambda subj=subj: fired.append(
        (sched.now_ms(), str(subj)))) for subj in subjects]
    rows = []
    for _ in range(40):
        for det in detectors:
            det()
        sched.run_for(250)
        row = [len(fired)]
        for attr in ("edge_digest", "tier_params"):
            fn = getattr(factory, attr, None)
            if fn is not None:
                row.append(fn())
        interval_for = getattr(factory, "interval_ms_for", None)
        if interval_for is not None:
            row.append([interval_for(subj, 1000) for subj in subjects])
        flush_for = getattr(factory, "flush_window_ms", None)
        if flush_for is not None:
            row.append(flush_for(100))
        rows.append(row)
    return fired, client.sent, rows, sorted(metrics.snapshot().items())


@pytest.mark.parametrize("kind", ["static", "pingpong", "windowed", "adaptive"])
@pytest.mark.parametrize("seed", [1, 2])
def test_failure_detector_twin(kind, seed):
    twin(failure_detectors, kind, seed)


def test_topology_tier_resolver_twin():
    """``topology_tier_resolver`` over a duck-typed topology names the same
    tier for every pair on both packages."""

    class Topology:
        def region_of(self, i):
            return i // 8

        def zone_of(self, i):
            return i // 4

        def rack_of(self, i):
            return i // 2

    def tiers(P):
        resolver = P.monitoring_adaptive.topology_tier_resolver(
            Topology(), 0, lambda e: e.port if e.port < 16 else None)
        return [resolver(ep(P, port)) for port in range(20)]

    assert twin(tiers)[:1] == ["rack"]


# --------------------------------------------------------------------- #
# Settings: fields, order, defaults, bounds
# --------------------------------------------------------------------- #


SETTINGS_CLASSES = ["Settings", "AdaptiveFdSettings", "ProfilingSettings", "DurabilitySettings",
                    "SLOSettings", "ForensicsSettings", "HierarchySettings"]


@pytest.mark.parametrize("name", SETTINGS_CLASSES)
def test_settings_class_matches_jax(name):
    """Field names, order, types and defaults, and the wire form
    (``dataclasses.asdict``) of a default and of a changed instance."""
    port_cls = getattr(package("rapid_tpu_torch").settings, name)
    jax_cls = getattr(package("rapid_tpu").settings, name)
    fields = lambda cls: [(f.name, str(f.type), f.default if f.default is not dataclasses.MISSING
                           else "factory") for f in dataclasses.fields(cls)]
    assert fields(port_cls) == fields(jax_cls)
    assert dataclasses.asdict(port_cls()) == dataclasses.asdict(jax_cls())
    assert port_cls.__dataclass_params__.frozen == jax_cls.__dataclass_params__.frozen


def test_settings_catalog_and_bounds_match_jax():
    """The catalog is JAX's, key for key; every knob refuses the same
    out-of-range values; the per-message timeouts agree."""
    P, J = package("rapid_tpu_torch"), package("rapid_tpu")
    assert P.settings.SETTINGS_CATALOG == J.settings.SETTINGS_CATALOG
    for key, bounds in J.settings.SETTINGS_CATALOG.items():
        plane, knob = key.split(".")
        cls = {"adaptive_fd": "AdaptiveFdSettings", "profiling": "ProfilingSettings",
               "durability": "DurabilitySettings", "slo": "SLOSettings",
               "forensics": "ForensicsSettings", "hierarchy": "HierarchySettings"}[plane]
        for value in (bounds["min"] - 1, bounds["max"] + 1):
            value = type(getattr(getattr(J.settings, cls)(), knob))(value)
            outcomes = [raises(lambda pkg=pkg: getattr(pkg.settings, cls)(**{knob: value}))
                        for pkg in (J, P)]
            assert outcomes[0] == outcomes[1], (key, value, outcomes)
    custom = dict(fd_policy="windowed", message_timeout_ms=7, broadcast_flush_window_ms=3)
    port, jax = P.settings.Settings(**custom), J.settings.Settings(**custom)
    assert dataclasses.asdict(port) == dataclasses.asdict(jax)
    for pkg, st in ((P, port), (J, jax)):
        T = pkg.types
        a = ep(pkg, 1)
        got = [st.timeout_for(T.JoinMessage(a, T.NodeId(1, 2), (0,), 1)),
               st.timeout_for(T.ProbeMessage(a)), st.timeout_for(T.LeaveMessage(a)),
               st.deadline_for(T.ProbeMessage(a))]
        assert got == [5000, 1000, 7, 6000]
    assert raises(lambda: P.settings.Settings(fd_policy="other")) == "AssertionError"
