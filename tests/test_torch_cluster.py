"""The port's protocol plane (``rapid_tpu_torch.cluster`` and everything under
it) against the JAX package's, whole clusters at a time.

``TwinHarness`` is ``tests/harness.py``'s ``ClusterHarness`` with the package
chosen by name (``with_faults`` arms that package's ``Nemesis``). Each
scenario of ``tests/test_cluster.py``, ``tests/test_subscriptions.py``,
``tests/test_messaging_scenarios.py``, the in-process parts of
``tests/test_gossip.py``, the nemesis scenarios of
``tests/test_adaptive_fd.py`` and ``tests/test_paxos.py``'s service vote
batch runs once on each package with the same seeds, in-process on a
``VirtualScheduler`` (at most 64 members). The scenario's own checks hold on
both, and the outcomes are equal exactly: every node's sequence of
``VIEW_CHANGE`` events (virtual ms, configuration id, member list, the
changes with their metadata), every ``VIEW_CHANGE_PROPOSAL`` and ``KICKED``
event, the final configuration ids and member lists, the virtual clock, and
whatever the scenario returns. Then the planes a port member refuses, and
the public surface.
"""

import importlib
import random
import types

import pytest

PACKAGES = ("rapid_tpu", "rapid_tpu_torch")
MODULES = ("cluster", "events", "faults", "membership", "cut_detector", "messaging.gossip",
           "messaging.inprocess", "messaging.unicast", "monitoring.pingpong",
           "monitoring.static_fd", "observability", "runtime.futures", "runtime.resources",
           "runtime.scheduler", "service", "settings", "types")
BASE_PORT = 1234


def package(name):
    """Package ``name``'s modules as attributes (dots become underscores)."""
    ns = types.SimpleNamespace(name=name, root=importlib.import_module(name))
    for module in MODULES:
        setattr(ns, module.replace(".", "_"), importlib.import_module(f"{name}.{module}"))
    return ns


def s(value):
    """Endpoints (and containers of them) as strings."""
    if isinstance(value, (list, tuple)):
        return [s(v) for v in value]
    if isinstance(value, (set, frozenset)):
        return sorted(s(v) for v in value)
    if hasattr(value, "hostname") and hasattr(value, "port"):
        return str(value)
    return value


class TwinHarness:
    """``tests/harness.py``'s ``ClusterHarness`` on package ``P``, recording
    every subscription event of every node it builds."""

    def __init__(self, P, seed=0, use_static_fd=True, settings=None):
        self.P = P
        self.scheduler = P.runtime_scheduler.VirtualScheduler()
        self.network = P.messaging_inprocess.InProcessNetwork(self.scheduler)
        self.rng = random.Random(seed)
        self.settings = settings if settings is not None else P.settings.Settings()
        self.blacklist = set()
        self.use_static_fd = use_static_fd
        self.instances = {}
        self.servers = {}
        self.broadcaster_factory = None
        self.nemesis = None
        self.events = []
        self._views = {}

    def with_faults(self, plan):
        """Arm ``plan`` on this package's ``Nemesis``, counting into a registry
        of its own (the process-global one is shared with other tests)."""
        self.nemesis = self.P.faults.Nemesis(plan, self.scheduler,
                                             metrics=self.P.observability.Metrics())
        return self

    def addr(self, i):
        return self.P.types.Endpoint.from_parts("127.0.0.1", BASE_PORT + i)

    def _recorder(self, addr, event):
        UP = self.P.types.EdgeStatus.UP

        def record(configuration_id, changes):
            row = [self.scheduler.now_ms(), str(addr), event.name, configuration_id,
                   [(str(c.endpoint), c.status.name, tuple(c.metadata)) for c in changes]]
            if event.name == "VIEW_CHANGE":
                view = self._views.setdefault(addr, set())
                for c in changes:
                    (view.add if c.status == UP else view.discard)(str(c.endpoint))
                row.append(sorted(view))
            self.events.append(row)

        return record

    def _builder(self, addr, fd=None, metadata=None, subscriptions=None, placement=None):
        P = self.P
        self._views.pop(addr, None)  # a rejoin starts a new view
        server = P.messaging_inprocess.InProcessServer(addr, self.network)
        self.servers[addr] = server
        client = P.messaging_inprocess.InProcessClient(addr, self.network, self.settings)
        scheduler = self.scheduler
        if self.nemesis is not None:
            client = self.nemesis.client(client, address=addr, settings=self.settings)
            server = self.nemesis.server(server, addr)
            scheduler = self.nemesis.scheduler_for(addr)
        builder = (
            P.cluster.ClusterBuilder(addr)
            .set_messaging_client_and_server(client, server)
            .use_scheduler(scheduler)
            .use_settings(self.settings)
            .use_rng(random.Random(self.rng.getrandbits(64)))
        )
        if self.broadcaster_factory is not None:
            builder.set_broadcaster_factory(self.broadcaster_factory)
        if fd is not None:
            builder.set_edge_failure_detector_factory(fd)
        elif self.use_static_fd:
            builder.set_edge_failure_detector_factory(
                P.monitoring_static_fd.StaticFailureDetectorFactory(self.blacklist))
        if metadata:
            builder.set_metadata(metadata)
        if placement:
            builder.use_placement(**placement)
        for event in P.events.ClusterEvents:
            builder.add_subscription(event, self._recorder(addr, event))
        for event, cb in subscriptions or []:
            builder.add_subscription(event, cb)
        return builder

    def start_seed(self, i=0, **kw):
        cluster = self._builder(self.addr(i), **kw).start()
        self.instances[cluster.listen_address] = cluster
        return cluster

    def join_async(self, i, seed_index=0, **kw):
        promise = self._builder(self.addr(i), **kw).join_async(self.addr(seed_index))

        def record(p):
            if p.exception() is None:
                cluster = p.peek()
                self.instances[cluster.listen_address] = cluster

        promise.add_callback(record)
        return promise

    def join(self, i, seed_index=0, timeout_ms=120_000, **kw):
        promise = self.join_async(i, seed_index, **kw)
        assert self.scheduler.run_until(promise.done, timeout_ms=timeout_ms), i
        return promise.peek()

    def create_cluster(self, n, parallel=True, timeout_ms=300_000):
        self.start_seed(0)
        if parallel:
            promises = [self.join_async(i) for i in range(1, n)]
            assert self.scheduler.run_until(lambda: all(p.done() for p in promises),
                                            timeout_ms=timeout_ms)
            for p in promises:
                assert p.exception() is None, p.exception()
        else:
            for i in range(1, n):
                self.join(i)
        return list(self.instances.values())

    def fail_nodes(self, endpoints):
        for endpoint in endpoints:
            self.blacklist.add(endpoint)
            cluster = self.instances.pop(endpoint, None)
            if cluster is not None:
                cluster.shutdown()

    def converged(self, expected_size):
        lists = [inst.get_memberlist() for inst in self.instances.values()]
        return bool(lists) and all(len(m) == expected_size and m == lists[0] for m in lists)

    def wait_and_verify_agreement(self, expected_size, timeout_ms=600_000, poll_ms=500):
        ok = self.scheduler.run_until(lambda: self.converged(expected_size),
                                      timeout_ms=timeout_ms, poll_ms=poll_ms)
        assert ok, {str(e): i.get_membership_size() for e, i in self.instances.items()}
        assert len({i.get_current_configuration_id() for i in self.instances.values()}) == 1

    def outcome(self):
        return {"events": self.events, "now_ms": self.scheduler.now_ms(),
                "final": sorted((str(e), i.get_current_configuration_id(), s(i.get_memberlist()))
                                for e, i in self.instances.items())}

    def shutdown(self):
        for cluster in list(self.instances.values()):
            cluster.shutdown()
        self.instances.clear()


def twin(scenario, **harness_kw):
    """``scenario(h)`` on a ``TwinHarness`` of each package; the outcomes
    (the harness's records and what the scenario returns) must be equal."""
    outs = []
    for name in PACKAGES:
        P = package(name)
        kw = {k: (v(P) if callable(v) else v) for k, v in harness_kw.items()}
        h = TwinHarness(P, **kw)
        try:
            extra = scenario(h)
            outs.append(dict(h.outcome(), extra=extra))
        finally:
            h.shutdown()
    assert outs[1] == outs[0]
    return outs[1]


# --------------------------------------------------------------------- #
# tests/test_cluster.py
# --------------------------------------------------------------------- #


def single_node_cluster(h):
    seed = h.start_seed()
    assert seed.get_membership_size() == 1 and seed.get_memberlist() == [seed.listen_address]


def sequential_joins(h):
    h.start_seed()
    for i in range(1, 10):
        h.join(i)
        h.wait_and_verify_agreement(i + 1)


def parallel_joins_through_single_seed(h):
    h.create_cluster(30, parallel=True)
    h.wait_and_verify_agreement(30)


def staged_join_waves(h):
    h.start_seed()
    total = 1
    for _ in range(3):
        promises = [h.join_async(total + i) for i in range(5)]
        assert h.scheduler.run_until(
            lambda: all(p.done() and p.exception() is None for p in promises),
            timeout_ms=300_000)
        total += 5
        h.wait_and_verify_agreement(total)


def crash_one_node(h):
    h.create_cluster(10)
    h.wait_and_verify_agreement(10)
    h.fail_nodes([h.addr(9)])
    h.wait_and_verify_agreement(9)


def crash_multiple_nodes(h):
    h.create_cluster(25)
    h.wait_and_verify_agreement(25)
    failing = [h.addr(i) for i in range(19, 25)]
    h.fail_nodes(failing)
    h.wait_and_verify_agreement(19)
    for cluster in h.instances.values():
        assert not set(cluster.get_memberlist()) & set(failing)


def crash_seed_node(h):
    h.create_cluster(10)
    h.wait_and_verify_agreement(10)
    h.fail_nodes([h.addr(0)])
    h.wait_and_verify_agreement(9)


def asymmetric_probe_drops(h):
    P = h.P

    def pingpong(i):
        addr = h.addr(i)
        return P.monitoring_pingpong.PingPongFailureDetectorFactory(
            addr, P.messaging_inprocess.InProcessClient(addr, h.network, h.settings),
            clock=h.scheduler.now_ms)

    h.start_seed(0, fd=pingpong(0))
    for i in range(1, 12):
        h.join(i, fd=pingpong(i))
    h.wait_and_verify_agreement(12)
    victims = {h.addr(10), h.addr(11)}
    h.network.add_filter(lambda src, dst, m: not (isinstance(m, P.types.ProbeMessage)
                                                  and dst in victims))
    for victim in victims:
        h.instances.pop(victim)
    h.wait_and_verify_agreement(10, timeout_ms=600_000)


def join_with_dropped_join_messages(h):
    T = h.P.types
    h.start_seed()
    dropped = {"prejoin": 0, "join": 0}

    def drop_first(msg):
        for cls, key in ((T.PreJoinMessage, "prejoin"), (T.JoinMessage, "join")):
            if isinstance(msg, cls) and dropped[key] < 1:
                dropped[key] += 1
                return False
        return True

    h.servers[h.addr(0)].interceptors.append(drop_first)
    h.join(1, timeout_ms=600_000)
    h.wait_and_verify_agreement(2)
    assert dropped == {"prejoin": 1, "join": 1}


def rejoin_after_crash(h):
    h.create_cluster(10)
    h.wait_and_verify_agreement(10)
    victim = h.addr(9)
    h.fail_nodes([victim])
    h.wait_and_verify_agreement(9)
    h.blacklist.discard(victim)
    h.join(9)
    h.wait_and_verify_agreement(10)


def churn_loop(h):
    h.create_cluster(8)
    h.wait_and_verify_agreement(8)
    for _ in range(3):
        victim = h.addr(7)
        h.fail_nodes([victim])
        h.wait_and_verify_agreement(7)
        h.blacklist.discard(victim)
        h.join(7)
        h.wait_and_verify_agreement(8)


def graceful_leave(h):
    h.create_cluster(10)
    h.wait_and_verify_agreement(10)
    leaver = h.instances.pop(h.addr(9))
    done = leaver.leave_gracefully_async()
    assert h.scheduler.run_until(done.done, timeout_ms=120_000)
    h.wait_and_verify_agreement(9)


def join_nonexistent_seed_fails(h):
    promise = h._builder(h.addr(1)).join_async(h.addr(99))
    assert h.scheduler.run_until(promise.done, timeout_ms=600_000)
    assert promise.exception() is not None
    return str(promise.exception())


def classic_paxos_fallback_in_full_stack(h):
    h.create_cluster(6)
    h.wait_and_verify_agreement(6)
    h.network.add_filter(lambda src, dst, m: not isinstance(m, h.P.types.FastRoundPhase2bMessage))
    h.fail_nodes([h.addr(5)])
    h.wait_and_verify_agreement(5, timeout_ms=600_000)


def fast_round_message_delay_still_converges(h):
    h.create_cluster(8)
    h.wait_and_verify_agreement(8)
    h.network.add_delay(
        lambda src, dst, m: 300 if isinstance(m, h.P.types.FastRoundPhase2bMessage) else 0)
    h.fail_nodes([h.addr(7)])
    h.wait_and_verify_agreement(7)


def parallel_join_and_crash_64(h):
    """test_hundred_node_parallel_join_and_crash at 64 members, 12 crashed."""
    h.create_cluster(64, parallel=True)
    h.wait_and_verify_agreement(64)
    failing = [h.addr(i) for i in range(52, 64)]
    h.fail_nodes(failing)
    h.wait_and_verify_agreement(52)


def crash_beyond_fast_paxos_quorum(h):
    """test_crash_beyond_fast_paxos_quorum at 32 members: 11 crashed leave 21,
    short of the fast quorum (32 - 31 // 4 = 25), so the classic round
    (majority 17) decides."""
    h.create_cluster(32, parallel=True)
    h.wait_and_verify_agreement(32)
    failing = [h.addr(i) for i in range(21, 32)]
    h.fail_nodes(failing)
    h.wait_and_verify_agreement(21, timeout_ms=1_200_000)


def refused_view_change_parks_and_applies_when_alerts_land(h):
    T = h.P.types
    h.create_cluster(4)
    h.wait_and_verify_agreement(4)
    node = h.instances[h.addr(0)]
    service = node._membership_service  # noqa: SLF001
    config_id = node.get_current_configuration_id()
    joiner = T.Endpoint.from_parts("127.0.0.1", 4999)
    service.handle_message(T.FastRoundVoteBatch(
        senders=tuple(h.addr(i) for i in range(4)), configuration_id=config_id,
        endpoints=(joiner,)))
    h.scheduler.run_for(500)
    assert service.metrics.get("view_changes_refused_missing_identity") == 1
    assert node.get_membership_size() == 4
    service.handle_message(T.BatchedAlertMessage(sender=h.addr(1), messages=(T.AlertMessage(
        edge_src=h.addr(1), edge_dst=joiner, edge_status=T.EdgeStatus.UP,
        configuration_id=config_id, ring_numbers=(0,), node_id=T.NodeId(1234, 5678)),)))
    h.scheduler.run_for(500)
    assert node.get_membership_size() == 5 and joiner in node.get_memberlist()
    return s(node.get_memberlist()), node.get_current_configuration_id()


def service_vote_batch_reaches_decision(h):
    """tests/test_paxos.py::test_service_vote_batch_reaches_decision."""
    h.create_cluster(6, parallel=False)
    h.wait_and_verify_agreement(6)
    target = h.instances[h.addr(0)]
    batch = h.P.types.FastRoundVoteBatch(
        senders=tuple(h.addr(i) for i in range(5)),
        configuration_id=target.get_current_configuration_id(), endpoints=(h.addr(5),))
    target._membership_service.handle_message(batch)  # noqa: SLF001
    assert h.scheduler.run_until(lambda: target.get_membership_size() == 5, timeout_ms=60_000)


CLUSTER_SCENARIOS = [
    (single_node_cluster, 42), (sequential_joins, 42), (parallel_joins_through_single_seed, 42),
    (staged_join_waves, 42), (crash_one_node, 42), (crash_multiple_nodes, 42),
    (crash_seed_node, 42), (asymmetric_probe_drops, 7), (join_with_dropped_join_messages, 42),
    (rejoin_after_crash, 42), (churn_loop, 42), (graceful_leave, 42),
    (join_nonexistent_seed_fails, 42), (classic_paxos_fallback_in_full_stack, 42),
    (fast_round_message_delay_still_converges, 42), (parallel_join_and_crash_64, 42),
    (crash_beyond_fast_paxos_quorum, 42),
    (refused_view_change_parks_and_applies_when_alerts_land, 42),
    (service_vote_batch_reaches_decision, 91),
]


@pytest.mark.parametrize("scenario,seed", CLUSTER_SCENARIOS,
                         ids=[f.__name__ for f, _ in CLUSTER_SCENARIOS])
def test_cluster_twin(scenario, seed):
    use_static_fd = scenario is not asymmetric_probe_drops
    twin(scenario, seed=seed, use_static_fd=use_static_fd)


# --------------------------------------------------------------------- #
# tests/test_subscriptions.py
# --------------------------------------------------------------------- #


def collect(events):
    def cb(configuration_id, changes):
        events.append((configuration_id, [(str(c.endpoint), c.status.name, tuple(c.metadata))
                                          for c in changes]))
    return cb


def view_change_on_each_join(h):
    VC = h.P.events.ClusterEvents.VIEW_CHANGE
    events = []
    h.start_seed(0, subscriptions=[(VC, collect(events))])
    for i in range(1, 5):
        h.join(i)
        h.wait_and_verify_agreement(i + 1)
    assert len(events) == 5 and len({cid for cid, _ in events}) == 5
    assert events[0][1][0][1] == "UP" and len(events[0][1]) == 1
    return events


def proposal_and_view_change_on_failure(h):
    E = h.P.events.ClusterEvents
    proposals, view_changes = [], []
    h.start_seed(0, subscriptions=[(E.VIEW_CHANGE_PROPOSAL, collect(proposals)),
                                   (E.VIEW_CHANGE, collect(view_changes))])
    for i in range(1, 6):
        h.join(i)
    h.wait_and_verify_agreement(6)
    before = len(proposals)
    victim = h.addr(5)
    h.fail_nodes([victim])
    h.wait_and_verify_agreement(5)
    assert len(proposals) > before
    assert proposals[-1][1] == [(str(victim), "DOWN", ())] == view_changes[-1][1]
    return proposals, view_changes


def metadata_in_down_notification(h):
    VC = h.P.events.ClusterEvents.VIEW_CHANGE
    events = []
    h.start_seed(0, subscriptions=[(VC, collect(events))])
    h.join(1, metadata={"role": b"backend"})
    for i in range(2, 5):
        h.join(i)
    h.wait_and_verify_agreement(5)
    victim = h.addr(1)
    assert dict(h.instances[h.addr(0)].get_cluster_metadata()[victim]) == {"role": b"backend"}
    h.fail_nodes([victim])
    h.wait_and_verify_agreement(4)
    assert events[-1][1] == [(str(victim), "DOWN", (("role", b"backend"),))]
    return events


def capacity_metadata_weights_placement(h):
    placement = {"partitions": 1024, "replicas": 1, "seed": 3}
    h.start_seed(0, placement=placement)
    h.join(1, placement=placement, metadata={"capacity": b"4"})
    for i in range(2, 6):
        h.join(i, placement=placement)
    h.wait_and_verify_agreement(6)
    maps = []
    for inst in h.instances.values():
        pmap = inst.get_placement_map()
        counts = pmap.counts()
        assert counts[h.addr(1)] > 2.5 * 1024 / 9
        maps.append((pmap.version, s(pmap.assignments), pmap.imbalance()))
    diff = h.instances[h.addr(0)].get_placement_diff()
    return maps, (diff.moved, len(diff.handoffs))


def capacity_weight_survives_join_snapshot(h):
    placement = {"partitions": 256, "replicas": 2, "seed": 5}
    h.start_seed(0, placement=placement, metadata={"capacity": b"4"})
    h.join(1, placement=placement)
    h.wait_and_verify_agreement(2)
    h.join(2, placement=placement)
    h.wait_and_verify_agreement(3)
    maps = [inst.get_placement_map() for inst in h.instances.values()]
    assert len({m.version for m in maps}) == 1
    return [(m.version, s(m.assignments)) for m in maps]


def kicked_event_on_removed_node(h):
    kicked = []
    h.start_seed(0)
    for i in range(1, 5):
        subs = [(h.P.events.ClusterEvents.KICKED, collect(kicked))] if i == 4 else None
        h.join(i, subscriptions=subs)
    h.wait_and_verify_agreement(5)
    victim = h.addr(4)
    victim_cluster = h.instances.pop(victim)
    h.blacklist.add(victim)
    h.wait_and_verify_agreement(4)
    assert h.scheduler.run_until(lambda: len(kicked) > 0, timeout_ms=300_000)
    victim_cluster.shutdown()
    return kicked


SUBSCRIPTION_SCENARIOS = [view_change_on_each_join, proposal_and_view_change_on_failure,
                          metadata_in_down_notification, capacity_metadata_weights_placement,
                          capacity_weight_survives_join_snapshot, kicked_event_on_removed_node]


@pytest.mark.parametrize("scenario", SUBSCRIPTION_SCENARIOS, ids=lambda f: f.__name__)
def test_subscriptions_twin(scenario):
    twin(scenario, seed=99)


# --------------------------------------------------------------------- #
# tests/test_messaging_scenarios.py
# --------------------------------------------------------------------- #


def join_phase1_against_1000_node_view(P):
    """A MembershipService on a 1000-member view answers pre-joins: a new
    joiner, a present hostname, a reused identifier."""
    T, K = P.types, 10
    scheduler = P.runtime_scheduler.VirtualScheduler()
    network = P.messaging_inprocess.InProcessNetwork(scheduler)
    rng = random.Random(1)
    view = P.membership.MembershipView(K)
    ep = lambda i: T.Endpoint.from_parts("127.0.0.1", 2000 + i)  # noqa: E731
    for i in range(1000):
        view.ring_add(ep(i), T.NodeId.random(rng))
    resources = P.runtime_resources.SharedResources(scheduler, name="large-view")
    service = P.service.MembershipService(
        ep(0), P.cut_detector.MultiNodeCutDetector(K, 9, 4), view, resources,
        P.settings.Settings(), P.messaging_inprocess.InProcessClient(ep(0), network),
        P.monitoring_static_fd.StaticFailureDetectorFactory(set()), rng=random.Random(0))
    out = []
    for sender, node_id in ((T.Endpoint.from_parts("127.0.0.1", 9999), T.NodeId.random(random.Random(42))),
                            (ep(500), T.NodeId.random(random.Random(43))),
                            (T.Endpoint.from_parts("10.9.9.9", 1), view.get_configuration().node_ids[17])):
        promise = service.handle_message(T.PreJoinMessage(sender=sender, node_id=node_id))
        scheduler.run_for(10)
        r = promise.result(0)
        out.append((r.status_code.name, r.configuration_id, s(r.endpoints)))
    assert out[0][0] == "SAFE_TO_JOIN" and out[0][1] == view.get_current_configuration_id()
    assert out[0][2] == s(view.get_expected_observers_of(T.Endpoint.from_parts("127.0.0.1", 9999)))
    assert [o[0] for o in out[1:]] == ["HOSTNAME_ALREADY_IN_RING", "UUID_ALREADY_IN_RING"]
    status = service.cluster_status()
    out.append((status.membership_size, status.configuration_id, status.placement_version,
                status.handoff_in_flight, status.serving_gets, status.durability_segments,
                status.cell_id if hasattr(status, "cell_id") else None))
    service.shutdown()
    resources.shutdown()
    return out


def broadcaster_fanout_100_members(P):
    T = P.types
    scheduler = P.runtime_scheduler.VirtualScheduler()
    network = P.messaging_inprocess.InProcessNetwork(scheduler)
    ep = lambda i: T.Endpoint.from_parts("127.0.0.1", 2000 + i)  # noqa: E731
    received = []

    class CountingServer(P.messaging_inprocess.InProcessServer):
        def handle(self, msg):
            received.append(str(self.address))
            return P.runtime_futures.Promise.completed(T.Response())

    for i in range(100):
        CountingServer(ep(i), network).start()
    caster = P.messaging_unicast.UnicastToAllBroadcaster(
        P.messaging_inprocess.InProcessClient(ep(0), network), rng=random.Random(1))
    caster.set_membership([ep(i) for i in range(100)])
    assert len(caster.broadcast(T.ProbeMessage(sender=ep(0)))) == 100
    scheduler.run_for(10)
    assert sorted(received) == sorted(str(ep(i)) for i in range(100))
    return received


@pytest.mark.parametrize("scenario", [join_phase1_against_1000_node_view,
                                      broadcaster_fanout_100_members], ids=lambda f: f.__name__)
def test_messaging_scenario_twin(scenario):
    outs = [scenario(package(name)) for name in PACKAGES]
    assert outs[1] == outs[0]


# --------------------------------------------------------------------- #
# tests/test_gossip.py, in process
# --------------------------------------------------------------------- #


class RecordingClient:
    def __init__(self, P):
        self.sent = []
        self.address = P.types.Endpoint.from_parts("127.0.0.1", 9)

    def send_message_best_effort(self, remote, msg):
        self.sent.append((remote, msg))

    send_message = send_message_best_effort


def gossip_units(P):
    """Fanout and TTL of a broadcast, dedup and relay budget of receive, the
    push-pull advertisement and pull repair."""
    T, G = P.types, P.messaging_gossip.GossipBroadcaster
    members = [T.Endpoint.from_parts("127.0.0.1", 1000 + i) for i in range(20)]
    me = members[0]

    def show(sent):
        return [(str(t), type(m).__name__, m.kind, m.ttl, (m.gossip_id.high, m.gossip_id.low),
                 m.payload is not None) for t, m in sent]

    client = RecordingClient(P)
    g = G(client, me, fanout=3, rng=random.Random(1))
    g.set_membership(members)
    g.broadcast(T.ProbeMessage(sender=me))
    out = [show(client.sent)]
    assert client.sent[0][0] == me and client.sent[0][1].ttl == 7
    for mode, budget_sends in (("eager", (2, 4, 4)), ("pushpull", (2, 4, 4))):
        client = RecordingClient(P)
        g = G(client, members[1], fanout=2, rng=random.Random(2), mode=mode)
        g.set_membership(members[:10])
        env = T.GossipEnvelope(sender=members[5], gossip_id=T.NodeId(7, 8), ttl=3,
                               payload=T.ProbeMessage(sender=members[5]))
        got = [type(g.receive(env)).__name__ for _ in range(3)]
        assert got == ["ProbeMessage", "NoneType", "NoneType"]
        assert len(client.sent) == budget_sends[-1]
        out.append((mode, show(client.sent)))
    adv_client, hol_client = RecordingClient(P), RecordingClient(P)
    adv = G(adv_client, members[11], fanout=1, rng=random.Random(7), mode="pushpull")
    hol = G(hol_client, members[12], fanout=1, rng=random.Random(8), mode="pushpull")
    for g in (adv, hol):
        g.set_membership(members[:6])
    adv.receive(T.GossipEnvelope(sender=members[0], gossip_id=T.NodeId(4, 2), ttl=2,
                                 payload=T.ProbeMessage(sender=members[0])))
    ihave = T.GossipEnvelope(sender=members[11], gossip_id=T.NodeId(4, 2), ttl=1,
                             kind=T.GossipEnvelope.KIND_IHAVE)
    assert hol.receive(ihave) is None and hol.receive(ihave) is None
    pulls = [m for _, m in hol_client.sent if m.kind == T.GossipEnvelope.KIND_PULL]
    assert len(pulls) == 1
    adv_client.sent.clear()
    adv.receive(pulls[0])
    answers = [m for _, m in adv_client.sent if m.kind == T.GossipEnvelope.KIND_PAYLOAD]
    assert type(hol.receive(answers[0])).__name__ == "ProbeMessage"
    out.append((show(hol_client.sent), show(adv_client.sent)))
    return out


def test_gossip_units_twin():
    outs = [gossip_units(package(name)) for name in PACKAGES]
    assert outs[1] == outs[0]


def _gossip(mode):
    def scenario_factory(P):
        return lambda client, rng: P.messaging_gossip.GossipBroadcaster(
            client, client.address, fanout=4, rng=rng, mode=mode)
    return scenario_factory


def gossip_cluster_converges(mode, parallel, n, victims):
    def scenario(h):
        h.broadcaster_factory = _gossip(mode)(h.P)
        h.create_cluster(n, parallel=parallel)
        h.wait_and_verify_agreement(n)
        if victims:
            h.fail_nodes([h.addr(i) for i in victims])
            h.wait_and_verify_agreement(n - len(victims))
    return scenario


@pytest.mark.parametrize("mode,parallel,n,victims,seed", [
    ("eager", False, 16, (6, 11), 77), ("eager", True, 12, (), 78), ("pushpull", False, 16, (6, 11), 79)],
    ids=["eager_crash", "eager_join_wave", "pushpull_crash"])
def test_gossip_cluster_twin(mode, parallel, n, victims, seed):
    twin(gossip_cluster_converges(mode, parallel, n, victims), seed=seed)


# --------------------------------------------------------------------- #
# Nemesis scenarios (tests/test_adaptive_fd.py) on each package's fault plane
# --------------------------------------------------------------------- #


def adaptive_settings(P):
    return P.settings.Settings(adaptive_fd=P.settings.AdaptiveFdSettings(enabled=True))


def adaptive_cluster_tolerates_clock_skew(h):
    n = 4
    skewed = h.addr(1)
    h.with_faults(h.P.faults.FaultPlan(seed=5).clock_skew(skewed, offset_ms=350, rate=1.25))
    h.nemesis.arm()
    assert isinstance(h.nemesis.scheduler_for(skewed), h.P.faults.SkewedScheduler)
    h.create_cluster(n, parallel=False)
    h.wait_and_verify_agreement(n)
    h.fail_nodes([h.addr(n - 1)])
    h.wait_and_verify_agreement(n - 1)
    members = set(h.instances[h.addr(0)].get_memberlist())
    assert members == {h.addr(i) for i in range(n - 1)}


def adaptive_cluster_evicts_gray_node(h):
    n = 4
    victim = h.addr(n - 1)
    h.with_faults(h.P.faults.FaultPlan(seed=23).slow_node(victim, response_delay_ms=5000))
    h.nemesis.arm(epoch_ms=1 << 40)
    h.create_cluster(n, parallel=False)
    h.wait_and_verify_agreement(n)
    h.scheduler.run_until(lambda: False, timeout_ms=8_000)
    status = h.instances[h.addr(0)].get_cluster_status()
    assert status.fd_subjects and status.fd_tiers
    digest = (status.fd_subjects, status.fd_rtt_micros, status.fd_suspicion_milli,
              status.fd_tiers, status.fd_tier_interval_ms, status.fd_tier_threshold,
              status.fd_tier_flush_ms)
    h.nemesis.arm()
    start = h.scheduler.now_ms()
    vic = h.instances.pop(victim)
    try:
        h.wait_and_verify_agreement(n - 1)
        detect_ms = h.scheduler.now_ms() - start
        assert vic.get_membership_size() >= 1
    finally:
        vic.shutdown()
    assert set(h.instances[h.addr(0)].get_memberlist()) == {h.addr(i) for i in range(n - 1)}
    assert detect_ms <= 8_000, detect_ms
    return digest, detect_ms


def nemesis_drops_delays_duplicates(h):
    """A plan of every message-plane rule kind (drop, delay with jitter,
    duplicate, reorder, a healing partition) over a 10-member cluster
    through a crash: the transport decorators of each package decide alike."""
    F = h.P.faults
    plan = (F.FaultPlan(seed=31)
            .drop(0.2, msg_types=(h.P.types.AlertMessage,))
            .delay(40, jitter_ms=30)
            .duplicate(0.3)
            .reorder(0.3, max_extra_ms=80)
            .partition_one_way(h.addr(3), h.addr(4), windows=((0, 4_000),)))
    h.with_faults(plan)
    h.nemesis.arm(epoch_ms=1 << 40)
    h.create_cluster(10, parallel=False)
    h.wait_and_verify_agreement(10)
    h.nemesis.arm()
    h.fail_nodes([h.addr(9)])
    h.wait_and_verify_agreement(9, timeout_ms=1_200_000)
    return sorted((k, v) for k, v in h.nemesis.metrics.snapshot().items()
                  if k.startswith("nemesis"))


@pytest.mark.parametrize("scenario,seed,static", [
    (adaptive_cluster_tolerates_clock_skew, 5, False),
    (adaptive_cluster_evicts_gray_node, 23, False),
    (nemesis_drops_delays_duplicates, 31, True)], ids=["clock_skew", "gray_node", "message_faults"])
def test_nemesis_twin(scenario, seed, static):
    settings = (lambda P: P.settings.Settings()) if static else adaptive_settings
    twin(scenario, seed=seed, use_static_fd=static, settings=settings)


# --------------------------------------------------------------------- #
# Planes a port member refuses (ROADMAP.md Queue 1 item 12)
# --------------------------------------------------------------------- #


def _port_builder(h, i, **kw):
    return h._builder(h.addr(i), **kw)


REFUSALS = {
    "handoff": lambda P, b: b.use_handoff(P.root.InMemoryPartitionStore()),
    "serving": lambda P, b: b.use_placement().use_serving(P.root.InMemoryPartitionStore()),
    "durability": lambda P, b: b.use_durability("/nonexistent/wal"),
    "hierarchy": lambda P, b: b.use_settings(P.settings.Settings(
        hierarchy=P.settings.HierarchySettings(enabled=True))),
}


@pytest.mark.parametrize("plane", sorted(REFUSALS))
@pytest.mark.parametrize("entry", ["start", "join_async"])
def test_waiting_plane_is_refused(plane, entry):
    """``use_handoff``, ``use_serving``, ``use_durability`` and a hierarchy
    kill switch that is on make ``start`` and ``join_async`` raise
    ``NotImplementedError`` naming ROADMAP item 12, before any server starts."""
    P = package("rapid_tpu_torch")
    h = TwinHarness(P)
    builder = REFUSALS[plane](P, _port_builder(h, 1))
    with pytest.raises(NotImplementedError, match=rf"the {plane} plane .*ROADMAP.md Queue 1 item 12"):
        builder.start() if entry == "start" else builder.join_async(h.addr(0))
    assert not h.network.is_listening(h.addr(1))


def test_service_refuses_waiting_planes():
    """``MembershipService`` itself refuses a handoff store, serving and the
    hierarchy plane, so no caller builds a half plane around the builder."""
    P = package("rapid_tpu_torch")
    T = P.types
    scheduler = P.runtime_scheduler.VirtualScheduler()
    network = P.messaging_inprocess.InProcessNetwork(scheduler)
    me = T.Endpoint.from_parts("127.0.0.1", 1)
    cases = [({"handoff_store": P.root.InMemoryPartitionStore()}, P.settings.Settings(), "handoff"),
             ({"serving": True}, P.settings.Settings(), "serving"),
             ({}, P.settings.Settings(hierarchy=P.settings.HierarchySettings(enabled=True)),
              "hierarchy")]
    for kw, settings, plane in cases:
        view = P.membership.MembershipView(10, node_ids=[T.NodeId(1, 2)], endpoints=[me])
        with pytest.raises(NotImplementedError, match=rf"the {plane} plane"):
            P.service.MembershipService(
                me, P.cut_detector.MultiNodeCutDetector(10, 9, 4), view,
                P.runtime_resources.SharedResources(scheduler), settings,
                P.messaging_inprocess.InProcessClient(me, network),
                P.monitoring_static_fd.StaticFailureDetectorFactory(set()), **kw)


def test_port_member_answers_waiting_plane_messages_as_jax_without_them():
    """A port member answers Get/Put (RETRY), handoff requests and acks
    (empty Response) and hierarchy frames (ack) as a JAX member built
    without those planes does."""
    outs = []
    for name in PACKAGES:
        P = package(name)
        T = P.types
        h = TwinHarness(P, seed=3)
        h.create_cluster(3)
        h.wait_and_verify_agreement(3)
        service = h.instances[h.addr(0)]._membership_service  # noqa: SLF001
        me = h.addr(1)
        msgs = [T.Get(sender=me, key=b"k"), T.Put(sender=me, key=b"k", value=b"v", request_id=8),
                T.HandoffRequest(sender=me, session_id=3, partition=1, offset=0, length=16),
                T.HandoffAck(sender=me, session_id=3, partition=1),
                T.CellDigestMessage(sender=me, cell=0),
                T.GlobalViewMessage(sender=me, cells=(0,), epochs=(1,))]
        promises = [service.handle_message(m) for m in msgs]
        h.scheduler.run_for(10)
        outs.append([(type(p.peek()).__name__, getattr(p.peek(), "status", None),
                      getattr(p.peek(), "request_id", None)) for p in promises])
        status = h.instances[h.addr(0)].get_cluster_status()
        outs[-1].append((status.handoff_completed, status.serving_puts, status.durability_replayed))
        assert h.instances[h.addr(0)].get_handoff_status() == (0, 0, 0)
        h.shutdown()
    assert outs[1] == outs[0]


# --------------------------------------------------------------------- #
# The public surface
# --------------------------------------------------------------------- #


def _public(module):
    names = getattr(module, "__all__", None)
    if names is None:
        names = [n for n in vars(module) if not n.startswith("_")
                 and getattr(vars(module)[n], "__module__", module.__name__) == module.__name__]
    return set(names)


@pytest.mark.parametrize("module", ["", ".cluster", ".service", ".membership", ".cut_detector",
                                    ".paxos", ".fast_paxos", ".metadata", ".monitoring.base",
                                    ".monitoring.static_fd", ".monitoring.pingpong",
                                    ".monitoring.adaptive", ".runtime.resources",
                                    ".messaging.unicast", ".messaging.ports",
                                    ".messaging.gossip", ".messaging.inprocess",
                                    ".forensics.bundle", ".settings", ".cli.agent"])
def test_every_public_name_of_the_jax_module_exists_in_the_port(module):
    """Each public name JAX's module defines (its ``__all__`` where it has one)
    is a name of the port's module: classes and functions are found by name."""
    jax_mod = importlib.import_module("rapid_tpu" + module)
    port_mod = importlib.import_module("rapid_tpu_torch" + module)
    missing = sorted(n for n in _public(jax_mod) if not hasattr(port_mod, n))
    assert not missing, missing
    if module == "":
        assert sorted(port_mod.__all__) == sorted(jax_mod.__all__)


TRANSPORT_HALF = ["SkewedScheduler", "NemesisClient", "NemesisServer", "_NemesisServiceFilter",
                  "_pipe"]


def test_fault_plane_transport_half_exists_in_the_port():
    """``faults.py``'s transport half: the classes and the ``Nemesis``
    methods that mint them."""
    jax_faults = importlib.import_module("rapid_tpu.faults")
    port_faults = importlib.import_module("rapid_tpu_torch.faults")
    for name in TRANSPORT_HALF:
        assert hasattr(port_faults, name), name
        jax_obj = getattr(jax_faults, name)
        if isinstance(jax_obj, type):
            jax_methods = {n for n in vars(jax_obj) if not n.startswith("__")}
            assert jax_methods <= set(vars(getattr(port_faults, name))), name
    for method in ("client", "server", "scheduler_for", "arm", "decide", "retry_rng"):
        assert callable(getattr(port_faults.Nemesis, method))


# --------------------------------------------------------------------- #
# The planes a port member runs: forensics, profiling history, placement
# --------------------------------------------------------------------- #


def _journal(record):
    """A bundle member's journal without wall-clock stamps and span and trace
    ids (each package numbers its spans from its own process-wide counter)."""
    out = []
    for entry in record.get("journal", ()):
        entry = dict(entry)
        detail = {k: v for k, v in dict(entry.pop("detail", {})).items()
                  if k not in ("trace_id", "span_id")}
        entry.pop("trace_id", None)
        entry.pop("wall_s", None)
        out.append((sorted(entry.items()), sorted(detail.items())))
    return out


def forensics_history_and_placement(h):
    """Five members with the forensics plane (HLC stamps on the wire and in
    the journals), the profiling history and placement on, through a crash,
    then a cluster-wide evidence bundle captured on the virtual clock."""
    placement = {"partitions": 64, "replicas": 2, "seed": 9}
    h.start_seed(0, placement=placement)
    for i in range(1, 5):
        h.join(i, placement=placement)
    h.wait_and_verify_agreement(5)
    h.fail_nodes([h.addr(4)])
    h.wait_and_verify_agreement(4)
    node = h.instances[h.addr(0)]
    promise = node.capture_bundle_async(trigger="twin")
    assert h.scheduler.run_until(promise.done, timeout_ms=60_000)
    bundle = promise.peek()
    manifest = bundle["manifest"]
    assert manifest["members"] == 4 and manifest["unreachable"] == []
    status = node._membership_service.cluster_status(include_history=4)  # noqa: SLF001
    assert status.hlc_physical_ms > 0 and status.placement_version != 0
    return {"members": [(m["node"], _journal(m)) for m in bundle["members"]],
            "events": manifest["events"],
            "status": (status.hlc_physical_ms, status.hlc_logical, status.hlc_incarnation,
                       status.placement_version, status.placement_owned,
                       status.journal_capacity, len(status.history))}


def test_planes_of_a_port_member_twin():
    def settings(P):
        return P.settings.Settings(
            forensics=P.settings.ForensicsSettings(enabled=True),
            profiling=P.settings.ProfilingSettings(enabled=True, history_interval_ms=100))
    twin(forensics_history_and_placement, seed=31, settings=settings)
