"""The port's simulator bridge (``rapid_tpu_torch/sim/bridge.py``) against the
JAX bridge (``rapid_tpu/sim/bridge.py``).

Each scenario of ``tests/test_bridge.py`` runs twice with the same seed: on
the JAX bridge and on the port's bridge (``device="cpu"``, handed
``rapid_tpu``'s protocol classes), each with its own ``InProcessNetwork``,
``VirtualScheduler`` and real members built with ``ClusterBuilder``. The
scenario's own checks hold on both, and the outcomes must be equal exactly:
every ``ViewChangeRecord`` (cut, added, removed, configuration id, virtual
time, members, ``via_classic_round``), the swarm's configuration id and size,
and each real member's configuration id and member list. A third side,
``port_cluster``, runs every scenario with the port's own ``Cluster`` members
on the port's ``InProcessNetwork`` and ``VirtualScheduler`` over the port's
bridge on its default protocol (no ``rapid_tpu`` class in the run), and
must equal the JAX bridge with JAX members. Then: the port's
copies of the protocol classes and of ``address_comparator_key``, the port's
bridge on its default protocol driven by ``chip_smoke.py``'s scripted member,
snapshots across the two bridges, and a bridge on a port mesh."""

import dataclasses
import enum
import importlib
import logging
import pickle
import random

import numpy as np
import pytest

import chip_smoke
import rapid_tpu
import rapid_tpu.types as rtypes
import rapid_tpu_torch
from rapid_tpu.messaging.inprocess import InProcessNetwork
from rapid_tpu.runtime.futures import Promise
from rapid_tpu.runtime.scheduler import VirtualScheduler
from rapid_tpu.service import address_comparator_key as jax_comparator_key
from rapid_tpu.sim.bridge import TpuSimMessaging as JaxBridge
from rapid_tpu_torch import hashing as port_hashing
from rapid_tpu_torch import types as ptypes
from rapid_tpu_torch.runtime import futures as pfutures
from rapid_tpu_torch.shard.engine import make_mesh
from rapid_tpu_torch.sim.bridge import Protocol, TpuSimMessaging as PortBridge
from rapid_tpu_torch.sim.bridge import default_protocol, load_blob

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py

RAPID = Protocol.from_modules(rtypes, Promise)


def _jax_swarm(network, **kw):
    return JaxBridge(network, **kw)


def _port_swarm(network, **kw):
    return PortBridge(network, protocol=RAPID, device="cpu", **kw)


def _mesh_swarm(network, **kw):
    return PortBridge(network, protocol=RAPID, mesh=make_mesh(devices=["cpu"] * 4), **kw)


def _port_cluster_swarm(network, **kw):
    return PortBridge(network, device="cpu", **kw)


# side -> (swarm, the swarm driver's logger, the members' package)
SIDES = {"jax": (_jax_swarm, "rapid_tpu.sim.driver", rapid_tpu),
         "port": (_port_swarm, "rapid_tpu_torch.sim.driver", rapid_tpu),
         "mesh": (_mesh_swarm, "rapid_tpu_torch.sim.driver", rapid_tpu),
         "port_cluster": (_port_cluster_swarm, "rapid_tpu_torch.sim.driver", rapid_tpu_torch)}


class BridgeHarness:
    """``tests/test_bridge.py``'s harness with the swarm's package, and the
    members' (``P``, its types ``T``), chosen by ``side``; keeps every real
    member it builds."""

    def __init__(self, side: str, n_virtual: int = 24, capacity: int = 32, seed: int = 5):
        make_swarm, self.driver_logger, self.P = SIDES[side]
        name = self.P.__name__
        self.T = importlib.import_module(f"{name}.types")
        self.inprocess = importlib.import_module(f"{name}.messaging.inprocess")
        self.scheduler = importlib.import_module(f"{name}.runtime.scheduler").VirtualScheduler()
        self.network = self.inprocess.InProcessNetwork(self.scheduler)
        self.swarm = make_swarm(self.network, n_virtual=n_virtual, capacity=capacity, seed=seed)
        self.settings = self.P.Settings()
        self.rng = random.Random(seed)
        self.clusters = []

    def builder(self, ep, rng_seed=None, settings=None):
        settings = settings or self.settings
        server = self.inprocess.InProcessServer(ep, self.network)
        builder = (
            self.P.ClusterBuilder(ep)
            .set_messaging_client_and_server(
                self.inprocess.InProcessClient(ep, self.network, settings), server
            )
            .use_scheduler(self.scheduler)
            .use_settings(settings)
            .use_rng(random.Random(self.rng.getrandbits(64) if rng_seed is None else rng_seed))
        )
        return builder, server

    def join_real_node(self, name: str, port: int = 9000, metadata=None):
        builder, _ = self.builder(self.T.Endpoint.from_parts(name, port))
        if metadata:
            builder.set_metadata(metadata)
        promise = builder.join_async(self.swarm.endpoint(0))
        self.scheduler.run_for(50)  # deliver join phases; park at observers
        rec = self.swarm.pump()
        assert rec is not None, "join did not decide"
        assert self.scheduler.run_until(promise.done, timeout_ms=10_000)
        cluster = promise.result(0)
        self.clusters.append(cluster)
        return cluster, rec


# --------------------------------------------------------------------- #
# The scenarios of tests/test_bridge.py, one function each
# --------------------------------------------------------------------- #


def real_node_joins_virtual_swarm(side, caplog):
    h = BridgeHarness(side, n_virtual=24, seed=5)
    cluster, rec = h.join_real_node("real-1")
    assert len(rec.added) == 1 and len(rec.removed) == 0
    assert cluster.get_membership_size() == 25
    assert h.swarm.sim.membership_size == 25
    assert cluster.get_current_configuration_id() == h.swarm.sim.configuration_id()
    assert cluster.listen_address in cluster.get_memberlist()
    return h


def real_node_observes_simulated_crash_cut(side, caplog):
    h = BridgeHarness(side, n_virtual=24, seed=6)
    cluster, _ = h.join_real_node("real-1")
    events = []
    cluster.register_subscription(
        h.P.ClusterEvents.VIEW_CHANGE, lambda cid, changes: events.append(changes)
    )
    victims = np.array([3, 11, 17])
    h.swarm.sim.crash(victims)
    rec = h.swarm.pump(max_rounds=16)
    assert rec is not None and sorted(rec.cut) == [3, 11, 17]
    h.scheduler.run_for(200)
    assert cluster.get_membership_size() == 22
    assert cluster.get_current_configuration_id() == h.swarm.sim.configuration_id()
    assert len(events) == 1 and len(events[0]) == 3
    assert {c.endpoint for c in events[0]} == {h.swarm.endpoint(int(v)) for v in victims}
    return h


def real_node_leaves_gracefully(side, caplog):
    h = BridgeHarness(side, n_virtual=16, seed=7)
    cluster, join_rec = h.join_real_node("real-1")
    done = cluster.leave_gracefully_async()
    h.scheduler.run_for(50)
    rec = h.swarm.pump(max_rounds=8)
    assert rec is not None
    assert [h.swarm._endpoint(int(s)) for s in rec.cut] == [cluster.listen_address]
    assert rec.virtual_time_ms - join_rec.virtual_time_ms == 2 * 1000 + 100
    assert h.swarm.sim.membership_size == 16
    assert h.scheduler.run_until(done.done, timeout_ms=30_000)
    return h


def dead_real_node_removed_by_simulated_fd(side, caplog):
    h = BridgeHarness(side, n_virtual=16, seed=8)
    cluster, _ = h.join_real_node("real-1")
    assert h.swarm.sim.membership_size == 17
    cluster.shutdown()
    rec = h.swarm.pump(max_rounds=32, batch=16)
    assert rec is not None
    assert [h.swarm._endpoint(int(s)) for s in rec.cut] == [cluster.listen_address]
    assert h.swarm.sim.membership_size == 16
    return h


def two_real_nodes_share_one_swarm(side, caplog):
    h = BridgeHarness(side, n_virtual=24, capacity=32, seed=9)
    cluster1, _ = h.join_real_node("real-1", 9000)
    cluster2, _ = h.join_real_node("real-2", 9001)
    h.scheduler.run_for(200)
    assert cluster1.get_membership_size() == 26
    assert cluster2.listen_address in cluster1.get_memberlist()
    assert (cluster1.get_current_configuration_id()
            == cluster2.get_current_configuration_id()
            == h.swarm.sim.configuration_id())
    h.swarm.sim.crash(np.array([5]))
    assert h.swarm.pump(max_rounds=16) is not None
    h.scheduler.run_for(200)
    assert cluster1.get_membership_size() == 25
    assert cluster2.get_membership_size() == 25
    return h


def join_metadata_travels_through_bridge(side, caplog):
    h = BridgeHarness(side, n_virtual=16, seed=10)
    cluster, _ = h.join_real_node("real-1", metadata={"zone": b"us-east-1"})
    md = cluster.get_cluster_metadata()
    assert md.get(cluster.listen_address) == (("zone", b"us-east-1"),)
    return h


def uuid_reuse_rejected_across_bridge(side, caplog):
    h = BridgeHarness(side, n_virtual=16, seed=11)
    h.join_real_node("real-1")
    high, low = (int(x) for x in h.swarm.sim.sorted_identifiers()[0])
    resp = h.swarm._handle_pre_join(
        h.swarm.endpoint(0),
        h.T.PreJoinMessage(sender=h.T.Endpoint.from_parts("real-2", 9002),
                              node_id=h.T.NodeId(high, low)),
    )
    assert resp.status_code == h.T.JoinStatusCode.UUID_ALREADY_IN_RING
    h.responses = [resp]
    return h


def real_node_rejoins_after_leave(side, caplog):
    h = BridgeHarness(side, n_virtual=16, seed=13)
    cluster, _ = h.join_real_node("real-1")
    ids_before = len(h.swarm.sim.identifiers_seen)
    done = cluster.leave_gracefully_async()
    h.scheduler.run_for(50)
    assert h.swarm.pump(max_rounds=8) is not None
    assert h.scheduler.run_until(done.done, timeout_ms=30_000)
    assert h.swarm.sim.membership_size == 16
    cluster2, _ = h.join_real_node("real-1")
    assert cluster2.get_membership_size() == 17
    assert cluster2.get_current_configuration_id() == h.swarm.sim.configuration_id()
    assert len(h.swarm.sim.identifiers_seen) == ids_before + 1
    return h


def rejoin_after_crash_detection(side, caplog):
    h = BridgeHarness(side, n_virtual=16, seed=14)
    cluster, _ = h.join_real_node("real-1")
    cluster.shutdown()
    rec = h.swarm.pump(max_rounds=32, batch=16)
    assert rec is not None and h.swarm.sim.membership_size == 16
    cluster2, _ = h.join_real_node("real-1")
    assert cluster2.get_membership_size() == 17
    assert cluster2.get_current_configuration_id() == h.swarm.sim.configuration_id()
    return h


def real_node_down_alert_injected_into_swarm(side, caplog):
    h = BridgeHarness(side, n_virtual=16, seed=12)
    cluster, _ = h.join_real_node("real-1")
    target = cluster._membership_service._view.get_subjects_of(cluster.listen_address)[0]
    slot = h.swarm._slot_of[target]
    h.swarm._absorb_alerts(h.T.BatchedAlertMessage(
        sender=cluster.listen_address,
        messages=(h.T.AlertMessage(
            edge_src=cluster.listen_address,
            edge_dst=target,
            edge_status=h.T.EdgeStatus.DOWN,
            configuration_id=h.swarm.sim.configuration_id(),
            ring_numbers=(0,),
        ),),
    ))
    assert h.swarm.sim._injected_down[slot, 0]
    h.injected = h.swarm.sim._injected_down.copy()
    return h


def prejoin_retry_while_join_pending_is_safe(side, caplog):
    h = BridgeHarness(side, n_virtual=16, seed=15)
    ep = h.T.Endpoint.from_parts("real-retry", 9100)
    nid = h.T.NodeId.random(random.Random(99))
    seed_ep = h.swarm.endpoint(0)
    first = h.swarm._handle_pre_join(seed_ep, h.T.PreJoinMessage(ep, nid))
    assert first.status_code == h.T.JoinStatusCode.SAFE_TO_JOIN
    h.swarm._handle_join(first.endpoints[0], h.T.JoinMessage(ep, nid, (0,), first.configuration_id))
    assert h.swarm._slot_of[ep] in h.swarm.sim.pending_joiners
    retry = h.swarm._handle_pre_join(seed_ep, h.T.PreJoinMessage(ep, nid))
    assert retry.status_code == h.T.JoinStatusCode.SAFE_TO_JOIN
    assert retry.endpoints == first.endpoints
    h.responses = [first, retry]
    return h


def joiner_death_before_admission_reclaims_slot(side, caplog):
    h = BridgeHarness(side, n_virtual=16, capacity=20, seed=16)
    free_before = len(h.swarm._free_slots)
    builder, server = h.builder(h.T.Endpoint.from_parts("doomed", 9200), rng_seed=3,
                                settings=h.P.Settings())
    builder.join_async(h.swarm.endpoint(0))
    h.scheduler.run_for(50)
    assert len(h.swarm._free_slots) == free_before - 1
    assert h.swarm.sim.pending_joiners
    server.shutdown()
    assert h.swarm.pump(max_rounds=8) is None
    assert not h.swarm.sim.pending_joiners
    assert len(h.swarm._free_slots) == free_before
    assert h.swarm.sim.membership_size == 16
    h.free = list(h.swarm._free_slots)
    return h


def quorum_reachable_only_with_real_members_vote(side, caplog):
    h = BridgeHarness(side, n_virtual=15, capacity=20, seed=9)
    cluster, _ = h.join_real_node("real-1")
    assert h.swarm.sim.membership_size == 16
    h.swarm.sim.crash(np.array([1, 2, 3]))
    rec = h.swarm.pump(max_rounds=32, classic_fallback_after_rounds=None)
    assert rec is not None and not rec.via_classic_round
    assert sorted(rec.cut) == [1, 2, 3]
    assert h.swarm.sim.membership_size == 13
    assert not h.swarm.sim.auto_vote[h.swarm._slot_of[cluster.listen_address]]
    return h


def quorum_blocked_when_real_members_vote_is_dropped(side, caplog):
    h = BridgeHarness(side, n_virtual=15, capacity=20, seed=9)
    cluster, _ = h.join_real_node("real-1")
    h.network.add_filter(
        lambda s, d, m: not (
            s == cluster.listen_address and isinstance(m, h.T.FastRoundPhase2bMessage)
        )
    )
    h.swarm.sim.crash(np.array([1, 2, 3]))
    assert h.swarm.pump(max_rounds=32, classic_fallback_after_rounds=None) is None
    rec = h.swarm.pump(max_rounds=16, classic_fallback_after_rounds=4)
    assert rec is not None and rec.via_classic_round
    assert sorted(rec.cut) == [1, 2, 3]
    return h


def _partial_evidence(h, cluster, victims):
    """Full-ring DOWN evidence for ``victims`` from a virtual member, so the
    real member's detector crosses H on exactly that subset."""
    src = h.swarm.endpoint(5)
    evidence = tuple(
        h.T.AlertMessage(
            edge_src=src,
            edge_dst=h.swarm.endpoint(int(v)),
            edge_status=h.T.EdgeStatus.DOWN,
            configuration_id=cluster.get_current_configuration_id(),
            ring_numbers=tuple(range(10)),
        )
        for v in victims
    )
    h.network.deliver(src, cluster.listen_address, h.T.BatchedAlertMessage(src, evidence), 1000)


def real_members_conflicting_vote_forces_classic_fallback(side, caplog):
    h = BridgeHarness(side, n_virtual=15, capacity=20, seed=10)
    cluster, _ = h.join_real_node("real-1")
    h.swarm.sim.crash(np.array([1, 2, 3]))
    _partial_evidence(h, cluster, (1, 2))
    h.scheduler.run_for(300)
    assert h.swarm._slot_of[cluster.listen_address] in h.swarm.sim._extern_voted
    assert h.swarm.pump(max_rounds=32, classic_fallback_after_rounds=None) is None
    rec = h.swarm.pump(max_rounds=16, classic_fallback_after_rounds=4)
    assert rec is not None and rec.via_classic_round
    assert sorted(rec.cut) == [1, 2, 3]
    assert h.swarm.sim.membership_size == 13
    return h


def extern_row_overflow_warns_and_converges_via_fallback(side, caplog):
    caplog.clear()
    h = BridgeHarness(side, n_virtual=15, capacity=26, seed=13)
    members = [h.join_real_node(f"real-{i}")[0] for i in range(6)]
    assert h.swarm.sim.config.extern_proposals == 4
    h.swarm.sim.crash(np.array([1, 2, 3]))
    for cluster, subset in zip(members, [(1,), (2,), (3,), (1, 2), (1, 3), (2, 3)]):
        _partial_evidence(h, cluster, subset)
    with caplog.at_level(logging.WARNING, logger=h.driver_logger):
        h.scheduler.run_for(400)
    assert len(h.swarm.sim._extern_rows) == 4
    overflow_slots = {
        r.args[-1] for r in caplog.records
        if r.name == h.driver_logger and "no free extern proposal row" in r.message
    }
    assert overflow_slots == {h.swarm._slot_of[m.listen_address] for m in members[4:]}
    assert h.swarm.pump(max_rounds=32, classic_fallback_after_rounds=None) is None
    rec = h.swarm.pump(max_rounds=16, classic_fallback_after_rounds=4)
    assert rec is not None and rec.via_classic_round
    assert sorted(rec.cut) == [1, 2, 3]
    assert h.swarm.sim.membership_size == 18
    h.overflow_slots = sorted(overflow_slots)
    return h


def lagging_member_caught_up_after_lost_decision(side, caplog):
    h = BridgeHarness(side, n_virtual=24, seed=10)
    cluster, _ = h.join_real_node("real-1")
    member = cluster.listen_address
    slot = h.swarm._real[member]
    victims = np.unique(np.asarray(h.swarm.sim.state.subjects)[slot])[:3]
    config_before = cluster.get_current_configuration_id()
    lift = h.network.add_filter(lambda s, d, m: d != member)
    h.swarm.sim.crash(victims)
    rec = h.swarm.pump(max_rounds=32)
    assert rec is not None and sorted(rec.cut) == sorted(int(v) for v in victims)
    h.scheduler.run_for(300)
    assert cluster.get_membership_size() == 25
    assert cluster.get_current_configuration_id() == config_before
    lift()
    h.scheduler.run_for(15_000)
    assert cluster.get_membership_size() == 22
    assert cluster.get_current_configuration_id() == h.swarm.sim.configuration_id()
    return h


def _decide(h, victim):
    h.swarm.sim.crash(np.array([victim]))
    for _ in range(40):
        rec = h.swarm.pump()
        h.scheduler.run_for(2_000)
        if rec is not None:
            return rec
    raise AssertionError("no decision")


def lagging_member_walked_forward_through_packet_history(side, caplog):
    h = BridgeHarness(side, n_virtual=24, capacity=32, seed=6)
    cluster, _ = h.join_real_node("10.9.9.1", 9100)
    member_ep = h.T.Endpoint.from_parts("10.9.9.1", 9100)
    assert cluster.get_membership_size() == 25
    lift = h.network.add_filter(lambda s, d, m: d != member_ep)
    _decide(h, 2)
    _decide(h, 3)
    assert cluster.get_membership_size() == 25
    swarm_config = h.swarm.sim.configuration_id()
    assert cluster.get_current_configuration_id() != swarm_config
    lift()
    for _ in range(60):
        h.swarm.pump()
        h.scheduler.run_for(2_000)
        if (cluster.get_membership_size() == 23
                and cluster.get_current_configuration_id() == swarm_config):
            break
    assert cluster.get_membership_size() == 23
    assert cluster.get_current_configuration_id() == swarm_config
    slot = h.swarm._slot_of[member_ep]
    assert h.swarm.sim.active[slot] and h.swarm.sim.alive[slot]
    return h


def member_beyond_packet_history_is_cut_for_rejoin(side, caplog):
    h = BridgeHarness(side, n_virtual=24, capacity=32, seed=7)
    h.join_real_node("10.9.9.2", 9200)
    member_ep = h.T.Endpoint.from_parts("10.9.9.2", 9200)
    slot = h.swarm._slot_of[member_ep]
    lift = h.network.add_filter(lambda s, d, m: d != member_ep)
    for victim in range(2, 11):
        _decide(h, victim)
        if not h.swarm.sim.active[slot]:
            break
        for _ in range(6):
            h.swarm.pump()
            h.scheduler.run_for(3_000)
    for _ in range(60):
        h.swarm.pump()
        h.scheduler.run_for(2_000)
        if not h.swarm.sim.active[slot]:
            break
    assert not h.swarm.sim.active[slot] or not h.swarm.sim.alive[slot]
    lift()
    return h


SCENARIOS = [
    real_node_joins_virtual_swarm,
    real_node_observes_simulated_crash_cut,
    real_node_leaves_gracefully,
    dead_real_node_removed_by_simulated_fd,
    two_real_nodes_share_one_swarm,
    join_metadata_travels_through_bridge,
    uuid_reuse_rejected_across_bridge,
    real_node_rejoins_after_leave,
    rejoin_after_crash_detection,
    real_node_down_alert_injected_into_swarm,
    prejoin_retry_while_join_pending_is_safe,
    joiner_death_before_admission_reclaims_slot,
    quorum_reachable_only_with_real_members_vote,
    quorum_blocked_when_real_members_vote_is_dropped,
    real_members_conflicting_vote_forces_classic_fallback,
    extern_row_overflow_warns_and_converges_via_fallback,
    lagging_member_caught_up_after_lost_decision,
    lagging_member_walked_forward_through_packet_history,
    member_beyond_packet_history_is_cut_for_rejoin,
]


def _records(sim):
    return [
        (rec.cut.tolist(), rec.added.tolist(), rec.removed.tolist(), rec.configuration_id,
         rec.virtual_time_ms, rec.membership_size, rec.via_classic_round)
        for rec in sim.view_changes
    ]


def _outcome(h):
    """Everything a bridged run decided, in plain values."""
    sim = h.swarm.sim
    return {
        "records": _records(sim),
        "configuration_id": sim.configuration_id(),
        "membership_size": sim.membership_size,
        "members": sim.members().tolist(),
        "real": sorted((str(ep), slot) for ep, slot in h.swarm._real.items()),
        "clusters": [
            (str(c.listen_address), "shut down") if c._has_shutdown else
            (str(c.listen_address), c.get_current_configuration_id(),
             sorted(str(ep) for ep in c.get_memberlist()))
            for c in h.clusters
        ],
        "extra": {key: (np.asarray(v).tolist() if isinstance(v, np.ndarray) else _plain(v))
                  for key, v in vars(h).items()
                  if key in ("responses", "injected", "free", "overflow_slots")},
    }


def _plain(value):
    """Protocol messages as (class name, fields), recursively, so either
    package's instances compare."""
    if dataclasses.is_dataclass(value):
        return (type(value).__name__,) + tuple(
            _plain(getattr(value, f.name)) for f in dataclasses.fields(value))
    if isinstance(value, enum.Enum):
        return value.name
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    return value


@pytest.mark.parametrize("scenario", SCENARIOS, ids=[s.__name__ for s in SCENARIOS])
def test_bridge_twin(scenario, caplog):
    """A scenario of tests/test_bridge.py on both bridges: its checks hold on
    each, and the two outcomes are equal."""
    jax_out = _outcome(scenario("jax", caplog))
    port_out = _outcome(scenario("port", caplog))
    assert port_out == jax_out


@pytest.mark.parametrize("scenario", SCENARIOS, ids=[s.__name__ for s in SCENARIOS])
def test_bridge_twin_port_cluster(scenario, caplog):
    """A scenario of tests/test_bridge.py with the port's own members on the
    port's bridge, network and scheduler: equal to the JAX bridge with JAX
    members."""
    jax_out = _outcome(scenario("jax", caplog))
    port_out = _outcome(scenario("port_cluster", caplog))
    assert port_out == jax_out


# --------------------------------------------------------------------- #
# The port's copies: protocol classes, comparator, promise
# --------------------------------------------------------------------- #


def _random_endpoints(n, seed):
    rng = random.Random(seed)
    return [
        (bytes(rng.getrandbits(8) for _ in range(rng.randint(1, 24))), rng.randint(0, 65535))
        for _ in range(n)
    ]


def test_address_comparator_key_matches_the_protocol_plane():
    endpoints = _random_endpoints(500, seed=17)
    for host, port in endpoints:
        assert (port_hashing.address_comparator_key(ptypes.Endpoint(host, port))
                == jax_comparator_key(rtypes.Endpoint(host, port)))
    # the order the bridge sorts cuts in, over either package's endpoints
    port_order = sorted((ptypes.Endpoint(h, p) for h, p in endpoints),
                        key=port_hashing.address_comparator_key)
    jax_order = sorted((rtypes.Endpoint(h, p) for h, p in endpoints), key=jax_comparator_key)
    assert [(e.hostname, e.port) for e in port_order] == [(e.hostname, e.port) for e in jax_order]
    for h in (0, 1, (1 << 63) - 1, 1 << 63, (1 << 64) - 1):
        from rapid_tpu.hashing import to_signed
        assert port_hashing.to_signed(h) == to_signed(h)


def _example(cls, rng, types):
    """A seeded instance of a protocol dataclass of ``types``, every field
    set (nested endpoints, ids and ranks of the same package)."""
    values = {}
    for f in dataclasses.fields(cls):
        kind = str(f.type)
        ep = types.Endpoint(b"h%d" % rng.randint(0, 99), rng.randint(0, 65535))
        if kind == "bytes":
            values[f.name] = bytes(rng.getrandbits(8) for _ in range(rng.randint(1, 12)))
        elif "Tuple[AlertMessage" in kind:
            values[f.name] = tuple(_example(types.AlertMessage, rng, types) for _ in range(2))
        elif "Tuple[Endpoint" in kind and "Tuple[Tuple" not in kind:
            values[f.name] = (ep, types.Endpoint(b"x", 1))
        elif kind.startswith("Endpoint") or kind == "'Endpoint'":
            values[f.name] = ep
        elif "NodeId" in kind and "Tuple" in kind:
            values[f.name] = (types.NodeId(rng.getrandbits(62), -rng.getrandbits(62)),)
        elif "NodeId" in kind:
            values[f.name] = types.NodeId(rng.getrandbits(62), -rng.getrandbits(62))
        elif kind == "Rank":
            values[f.name] = types.Rank(rng.randint(1, 9), rng.randint(0, 99))
        elif kind == "EdgeStatus":
            values[f.name] = types.EdgeStatus.DOWN
        elif kind == "JoinStatusCode":
            values[f.name] = types.JoinStatusCode.CONFIG_CHANGED
        elif kind == "NodeStatus":
            values[f.name] = types.NodeStatus.BOOTSTRAPPING
        elif "Tuple[Tuple[Endpoint" in kind:
            values[f.name] = ((ep, (("zone", b"z"),)),)
        elif "Tuple[Tuple[str" in kind:
            values[f.name] = (("zone", b"z"),)
        elif "Tuple[int" in kind:
            values[f.name] = (0, 3)
        elif kind == "int":
            values[f.name] = rng.getrandbits(63)
        else:
            raise AssertionError(f"{cls.__name__}.{f.name}: {kind}")
    return cls(**values)


def _convert(value, types):
    """``value`` rebuilt field for field with the classes of ``types``."""
    if dataclasses.is_dataclass(value):
        cls = getattr(types, type(value).__name__)
        return cls(**{f.name: _convert(getattr(value, f.name), types)
                      for f in dataclasses.fields(value)})
    if isinstance(value, enum.Enum):
        return getattr(types, type(value).__name__)(value.value)
    if isinstance(value, tuple):
        return tuple(_convert(v, types) for v in value)
    return value


PROTOCOL_CLASSES = [f.name for f in dataclasses.fields(Protocol) if f.name != "Promise"] + [
    "NodeStatus", "Rank"]


@pytest.mark.parametrize("name", PROTOCOL_CLASSES)
def test_port_protocol_class_round_trips_against_rapid_tpu(name):
    """Same fields, defaults, values, ordering and equality as
    ``rapid_tpu.types``; an instance converted field for field to the other
    package's class and back is equal to itself."""
    port_cls, jax_cls = getattr(ptypes, name), getattr(rtypes, name)
    if issubclass(port_cls, enum.Enum):
        assert [(m.name, m.value) for m in port_cls] == [(m.name, m.value) for m in jax_cls]
        return
    def fields(cls):
        return [(f.name, f.default, f.default_factory) for f in dataclasses.fields(cls)]

    assert fields(port_cls) == fields(jax_cls)
    assert port_cls.__dataclass_params__.frozen and port_cls.__dataclass_params__.order == (
        jax_cls.__dataclass_params__.order)
    rng = random.Random(sum(map(ord, name)))
    for _ in range(3):
        original = _example(port_cls, rng, ptypes)
        there = _convert(original, rtypes)
        assert type(there) is jax_cls
        assert _convert(there, ptypes) == original
        assert hash(_convert(there, ptypes)) == hash(original)
    if port_cls.__dataclass_params__.order:
        a, b = _example(port_cls, rng, ptypes), _example(port_cls, rng, ptypes)
        assert (a < b) == (_convert(a, rtypes) < _convert(b, rtypes))


def test_port_endpoint_and_node_id_helpers():
    assert ptypes.Endpoint.from_string("10.0.0.1:9000") == ptypes.Endpoint(b"10.0.0.1", 9000)
    assert str(ptypes.Endpoint.from_parts("a", 1)) == str(rtypes.Endpoint.from_parts("a", 1))
    with pytest.raises(ValueError):
        ptypes.Endpoint.from_parts("a", 70_000)
    with pytest.raises(ValueError):
        ptypes.Endpoint.from_string("no-port")
    for seed in range(20):
        port_id = ptypes.NodeId.random(random.Random(seed))
        jax_id = rtypes.NodeId.random(random.Random(seed))
        assert (port_id.high, port_id.low) == (jax_id.high, jax_id.low)


def test_port_promise_completes_once_and_runs_callbacks():
    p = pfutures.Promise()
    seen = []
    p.add_callback(lambda q: seen.append(q.peek()))
    assert not p.done()
    p.set_result(7)
    assert seen == [7] and p.result(0) == 7
    with pytest.raises(pfutures.PromiseError):
        p.set_result(8)
    assert not p.try_set_exception(RuntimeError())
    failed = pfutures.Promise.failed(KeyError("k"))
    assert isinstance(failed.exception(), KeyError)
    with pytest.raises(KeyError):
        failed.peek()


# --------------------------------------------------------------------- #
# The default protocol, snapshots, a mesh
# --------------------------------------------------------------------- #


def test_scripted_member_on_default_protocol():
    """``chip_smoke.py``'s bridge phase at 1000 members on the CPU: the port's
    own protocol classes, the scripted member's join, votes and leave, the
    mesh of 4 shards, each decision's configuration id equal to a plain
    simulator's driven alike."""
    out = chip_smoke.bridge_sequence(1000, "cpu", ["cpu"] * 4)
    assert [p["name"] for p in out["pumps"]] == [
        "join", "crash, closed form", "crash, scan", "leave", "mesh join", "mesh crash"]
    assert all(p["configuration_id"] == p["plain_configuration_id"] for p in out["pumps"])
    assert out["protocol"] == "rapid_tpu_torch.types"


def test_real_port_members_on_default_protocol():
    """``chip_smoke.py``'s real-member phase at 1000 members on the CPU: the
    port's own ``Cluster`` on the port's bridge, network and scheduler, through
    the scripted member's join, crashes and leave, then 8 members joining in
    one pump and voting in the crash; every member's view equal to the
    swarm's and each configuration id to a plain simulator's."""
    out = chip_smoke.member_sequence(1000, "cpu")
    names = [p["name"] for p in out["pumps"]]
    assert names == ["join", "crash, closed form", "crash, scan", "leave",
                     f"{chip_smoke.PORT_MEMBERS} members join",
                     f"{chip_smoke.PORT_MEMBERS} members, crash"]
    assert all(p["configuration_id"] == p["plain_configuration_id"] for p in out["pumps"])
    pumps = {p["name"]: p for p in out["pumps"]}
    assert pumps["join"]["member_build_ms"] > 0 and pumps["crash, scan"]["member_ms"] > 0
    assert len(pumps[f"{chip_smoke.PORT_MEMBERS} members, crash"]["votes_registered"]) \
        == chip_smoke.PORT_MEMBERS
    assert pumps["leave"]["decided_in_ms"] == 2 * 1000 + 100


def _bridge_pair(tmp_path):
    """A JAX bridge and a port bridge with the same real member (with
    metadata) admitted and a crash decided."""
    out = {}
    for side in ("jax", "port"):
        h = BridgeHarness(side, n_virtual=16, capacity=24, seed=21)
        h.join_real_node("real-1", metadata={"zone": b"eu"})
        h.swarm.sim.crash(np.array([4]))
        assert h.swarm.pump(max_rounds=16) is not None
        out[side] = h
    return out


def _restored_view(bridge):
    return (bridge.sim.configuration_id(), sorted(bridge._real.values()),
            sorted((ep.hostname, ep.port, md) for ep, md in bridge._metadata.items()),
            bridge.sim.members().tolist())


def test_snapshots_cross_between_the_bridges(tmp_path):
    """``save`` on either bridge restores on the other with the same
    configuration id, real slots and metadata (keyed by the restoring side's
    Endpoint class), and the restored swarm goes on deciding alike."""
    pair = _bridge_pair(tmp_path)
    jax_view = _restored_view(pair["jax"].swarm)
    assert jax_view == _restored_view(pair["port"].swarm)
    for writer, reader in (("jax", "port"), ("port", "jax")):
        path = str(tmp_path / f"{writer}.npz")
        pair[writer].swarm.save(path)
        network = InProcessNetwork(VirtualScheduler())
        if reader == "port":
            restored = PortBridge.restore(network, path, protocol=RAPID, device="cpu")
            default = PortBridge.restore(InProcessNetwork(VirtualScheduler()), path, device="cpu")
            assert all(type(ep) is ptypes.Endpoint for ep in default._metadata)
            assert _restored_view(default) == jax_view
        else:
            restored = JaxBridge.restore(network, path)
        assert all(type(ep) is rtypes.Endpoint for ep in restored._metadata)
        assert _restored_view(restored) == jax_view, (writer, reader)
        pair.setdefault("free", []).append(list(restored._free_slots))
        restored.sim.crash(np.array([5]))
        # the real member does not listen on the new network: it is cut too
        rec = restored.pump(max_rounds=16)
        assert rec is not None and 5 in rec.cut.tolist()
        pair.setdefault("after", []).append((rec.cut.tolist(), rec.configuration_id))
    assert pair["after"][0] == pair["after"][1] and pair["free"][0] == pair["free"][1]


class _Evil:
    def __reduce__(self):
        return (print, ("side effect",))


@pytest.mark.parametrize("payload", [
    {"metadata": {}, "x": _Evil()},
    {"metadata": {rtypes.NodeId(1, 2): ()}},
    {"metadata": {}, "f": np.int64(3)},
])
def test_snapshot_blob_refuses_any_other_class(payload):
    with pytest.raises(pickle.UnpicklingError, match="only Endpoint"):
        load_blob(pickle.dumps(payload), ptypes.Endpoint)
    blob = pickle.dumps({"metadata": {rtypes.Endpoint(b"a", 1): (("k", b"v"),)}})
    assert load_blob(blob, ptypes.Endpoint) == {
        "metadata": {ptypes.Endpoint(b"a", 1): (("k", b"v"),)}}


def test_bridged_decision_on_a_port_mesh_matches_the_jax_bridge():
    """A real member joins and a crash decides on a port bridge over a mesh
    of 4 CPU shards (capacity rounded up to divide over it) and on the JAX
    bridge on one device: the same records and member views."""
    outs = []
    for side, capacity in (("jax", 36), ("mesh", 34)):
        h = BridgeHarness(side, n_virtual=30, capacity=capacity, seed=23)
        assert h.swarm.sim.config.capacity == 36
        cluster, _ = h.join_real_node("real-1")
        h.swarm.sim.crash(np.array([2, 9]))
        assert h.swarm.pump(max_rounds=16) is not None
        h.scheduler.run_for(200)
        assert cluster.get_current_configuration_id() == h.swarm.sim.configuration_id()
        outs.append(_outcome(h))
    assert outs[0] == outs[1]


def test_port_bridge_without_device_raises_when_cuda_is_absent(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PortBridge(InProcessNetwork(VirtualScheduler()), n_virtual=8)


def test_default_protocol_is_the_ports_own():
    protocol = default_protocol()
    assert all(getattr(protocol, f.name).__module__.startswith("rapid_tpu_torch.")
               for f in dataclasses.fields(Protocol))
    assert RAPID.Endpoint is rtypes.Endpoint and RAPID.Promise is Promise
