"""The port's swarm gateway (``rapid_tpu_torch/messaging/gateway.py``) with
untouched ``rapid_tpu`` agents over real TCP sockets.

Twins of ``tests/test_gateway.py``: each agent runs ``rapid_tpu``'s
``ClusterBuilder``/``Cluster`` stack on ``rapid_tpu``'s TCP transport,
with ``rapid_tpu``'s ``GatewayRoutedClient`` and ``GatewaySwarmBroadcaster``;
the swarm is the port's ``SwarmGateway(device="cpu")``, whose bridge runs
the port's simulator on the port's own classes. Only bytes cross the
wire. In every case each agent's configuration id and member list equal
the gateway's. Virtual faults are injected through a task on the gateway's
protocol thread, the one thread that touches the swarm. This file holds
the routed frame, joins and cuts, a dead agent, a graceful leave and the
front door on the native reactor; ``test_torch_gateway_restore.py``,
``test_torch_gateway_mesh.py`` and ``test_torch_gateway_member.py`` hold
the rest (one file per worker under ``--dist loadfile``)."""

import random
import time

import numpy as np
import pytest
import torch
from harness import free_port_base

import chip_smoke
import rapid_tpu.types as rtypes
from rapid_tpu import ClusterBuilder, Settings
from rapid_tpu.events import ClusterEvents
from rapid_tpu.messaging import gateway as jax_gateway
from rapid_tpu.messaging.tcp import TcpClientServer
from rapid_tpu_torch import types as ptypes
from rapid_tpu_torch.messaging import gateway as port_gateway
from rapid_tpu_torch.messaging.gateway import SwarmGateway
from rapid_tpu_torch.settings import Settings as PortSettings
from rapid_tpu_torch.sim.topology import ring_order


@pytest.fixture(scope="module", autouse=True)
def port_lockdep_gate():
    """Fail the module if the port's lock-order checker (its own registry,
    on under ``RAPID_LOCKDEP=1``) recorded a violation on any thread."""
    yield
    from rapid_tpu_torch.runtime import lockdep

    assert lockdep.violations() == [], lockdep.violations()


def jax_ep(ep) -> rtypes.Endpoint:
    return rtypes.Endpoint(ep.hostname, ep.port)


def port_ep(ep) -> ptypes.Endpoint:
    return ptypes.Endpoint(ep.hostname, ep.port)


def crash(gateway: SwarmGateway, slots) -> set:
    """Crash virtual members on the protocol thread; their endpoints."""
    slots = np.asarray(slots)
    chip_smoke._on_protocol_thread(gateway, lambda: gateway.bridge.sim.crash(slots))
    return {jax_ep(gateway.bridge.endpoint(int(s))) for s in slots}


def gateway_members(gateway: SwarmGateway) -> list:
    """The swarm's member list in ring-0 order, as ``rapid_tpu`` endpoints."""
    sim = gateway.bridge.sim
    order = ring_order(sim.cluster, sim.active.copy(), 0)
    return [jax_ep(gateway.bridge.endpoint(int(s))) for s in order]


class GatewayHarness:
    """A socket-hosted swarm on the port plus ``rapid_tpu`` agents, all on
    loopback, with ``tests/test_gateway.py``'s settings."""

    def __init__(self, n_virtual=32, seed=11, capacity=None, fd_interval_ms=100,
                 pump_interval_ms=50, broadcaster_factory=None, mesh=None, port_block=64,
                 native_server=False, base=None):
        self.base = free_port_base(port_block) if base is None else base
        knobs = dict(failure_detector_interval_ms=fd_interval_ms, batching_window_ms=50,
                     consensus_fallback_base_delay_ms=1000)
        self.settings = Settings(**knobs)
        self.port_settings = PortSettings(**knobs)
        self.pump_interval_ms = pump_interval_ms
        self.gateway = SwarmGateway(
            ptypes.Endpoint.from_parts("127.0.0.1", self.base), n_virtual=n_virtual,
            capacity=capacity, seed=seed, settings=self.port_settings,
            pump_interval_ms=pump_interval_ms, mesh=mesh, native_server=native_server,
            device=None if mesh is not None else "cpu")
        self.gateway.start()
        self.broadcaster_factory = broadcaster_factory
        self.agents = []

    def restart(self, snapshot: str) -> None:
        """Checkpoint, shut the gateway down, and restore it at the same
        address."""
        self.gateway.save(snapshot)
        self.gateway.shutdown()
        time.sleep(0.3)
        self.gateway = SwarmGateway(
            ptypes.Endpoint.from_parts("127.0.0.1", self.base), restore_from=snapshot,
            settings=self.port_settings, pump_interval_ms=self.pump_interval_ms, device="cpu")
        self.gateway.start()

    def join_agent(self, i, timeout=60, rng=None):
        """Agent ``i`` joins on port ``base + i``; ``rng`` seeds its node id."""
        addr = rtypes.Endpoint.from_parts("127.0.0.1", self.base + i)
        transport = TcpClientServer(addr, self.settings)
        client = jax_gateway.GatewayRoutedClient(
            addr, jax_ep(self.gateway.address), transport, self.settings)
        factory = self.broadcaster_factory or (
            lambda c, rng, routed=client: jax_gateway.GatewaySwarmBroadcaster(routed))
        cluster = (
            ClusterBuilder(addr)
            .use_settings(self.settings)
            .set_messaging_client_and_server(client, transport)
            .set_broadcaster_factory(factory)
        )
        if rng is not None:
            cluster = cluster.use_rng(rng)
        cluster = cluster.join(jax_ep(self.gateway.seed_endpoint()), timeout=timeout)
        self.agents.append(cluster)
        return cluster

    def wait_converged(self, want, timeout=60, agents=None):
        agents = self.agents if agents is None else agents
        deadline = time.time() + timeout
        while time.time() < deadline:
            if (self.gateway.membership_size() == want
                    and all(a.get_membership_size() == want for a in agents)
                    and len({a.get_current_configuration_id() for a in agents}
                            | {self.gateway.configuration_id()}) == 1):
                return True
            time.sleep(0.05)
        sizes = {}
        for a in agents:
            sizes.setdefault(a.get_membership_size(), []).append(a.listen_address.port)
        print(f"wait_converged({want}) timed out: gateway={self.gateway.membership_size()}, "
              f"agent sizes {{size: [ports]}} = { {k: v for k, v in sorted(sizes.items())} }")
        return False

    def assert_agreement(self, agents=None):
        """Every agent's configuration id and member list equal the gateway's."""
        agents = self.agents if agents is None else agents
        want_id = self.gateway.configuration_id()
        want = gateway_members(self.gateway)
        for a in agents:
            assert a.get_current_configuration_id() == want_id, a.listen_address
            assert list(a.get_memberlist()) == want, a.listen_address

    def shutdown(self):
        for a in self.agents:
            try:
                a.shutdown()
            except Exception:  # noqa: BLE001 -- best-effort teardown
                pass
        self.gateway.shutdown()


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_routed_frame_roundtrip(direction):
    """A routed frame from either package reads back in the other,
    byte-identical, the swarm broadcast's wildcard too."""
    sides = {"port": (port_gateway, ptypes), "jax": (jax_gateway, rtypes)}
    (enc_mod, enc_t), (dec_mod, dec_t) = (
        (sides["port"], sides["jax"]) if direction == "port_to_jax" else (sides["jax"], sides["port"]))
    for dst_of in (lambda T: T.Endpoint(b"10.1.2.3", 5042), lambda T: None):
        msg = enc_t.PreJoinMessage(sender=enc_t.Endpoint(b"127.0.0.1", 9001),
                                   node_id=enc_t.NodeId(-5, 77))
        dst = dst_of(enc_t) or enc_mod.SWARM_BROADCAST
        frame = enc_mod.encode_routed(123, dst, msg)
        request_no, dst_back, msg_back = dec_mod.decode_routed(frame)
        assert request_no == 123
        assert (dst_back.hostname, dst_back.port) == (dst.hostname, dst.port)
        assert msg_back == dec_t.PreJoinMessage(sender=dec_t.Endpoint(b"127.0.0.1", 9001),
                                                node_id=dec_t.NodeId(-5, 77))
        back_dst = dec_t.Endpoint(dst_back.hostname, dst_back.port)
        assert dec_mod.encode_routed(123, back_dst, msg_back) == frame


def test_agents_join_socket_swarm_and_observe_cut():
    h = GatewayHarness(n_virtual=32, seed=11)
    try:
        a1 = h.join_agent(1)
        assert h.wait_converged(33, agents=[a1])
        h.assert_agreement()

        h.join_agent(2)
        h.join_agent(3)
        assert h.wait_converged(35)
        h.assert_agreement()
        assert len(h.agents[0].get_memberlist()) == 35

        # crash three virtual nodes; every real agent observes the exact cut
        events = []
        a1.register_subscription(
            ClusterEvents.VIEW_CHANGE, lambda cid, changes: events.append(changes))
        crashed = crash(h.gateway, [3, 11, 17])
        assert h.wait_converged(32)
        h.assert_agreement()
        assert len(events) == 1
        assert {c.endpoint for c in events[0]} == crashed
    finally:
        h.shutdown()


def test_dead_agent_removed_from_socket_swarm():
    h = GatewayHarness(n_virtual=24, seed=12)
    try:
        a1 = h.join_agent(1)
        a2 = h.join_agent(2)
        assert h.wait_converged(26)
        h.assert_agreement()
        a2.shutdown()  # abrupt death: socket closes, no leave
        h.agents.remove(a2)
        assert h.wait_converged(25, timeout=90)
        h.assert_agreement()
        assert a2.listen_address not in a1.get_memberlist()
        assert port_ep(a2.listen_address) not in h.gateway.bridge._real  # noqa: SLF001
    finally:
        h.shutdown()


def test_agent_leaves_socket_swarm_gracefully():
    h = GatewayHarness(n_virtual=24, seed=13)
    try:
        h.join_agent(1)
        a2 = h.join_agent(2)
        assert h.wait_converged(26)
        a2.leave_gracefully(timeout=60)
        h.agents.remove(a2)
        assert h.wait_converged(25, timeout=60)
        h.assert_agreement()
    finally:
        h.shutdown()


def test_agents_join_swarm_through_native_reactor():
    """The twin of ``tests/test_gateway.py::test_agents_join_swarm_through_native_reactor``:
    the gateway's front door on the port's C++ epoll reactor
    (``native_server=True``, no Python server). Two agents join, observe a
    virtual cut and converge; the same agents (ports and node ids) against
    the Python server give the same configuration ids at every step."""
    base = free_port_base(64)
    ids = {}
    for native in (False, True):
        h = GatewayHarness(n_virtual=24, seed=13, native_server=native, base=base)
        try:
            assert (h.gateway._framed is None) == native  # noqa: SLF001
            assert (h.gateway._reactor is not None) == native  # noqa: SLF001
            a1 = h.join_agent(1, rng=random.Random(101))
            a2 = h.join_agent(2, rng=random.Random(102))
            assert h.wait_converged(26)
            joined = h.gateway.configuration_id()
            crash(h.gateway, [5, 9])
            assert h.wait_converged(24)
            h.assert_agreement()
            assert a1.get_current_configuration_id() == a2.get_current_configuration_id() \
                == h.gateway.configuration_id()
            ids[native] = (joined, h.gateway.configuration_id())
        finally:
            h.shutdown()
    assert ids[True] == ids[False]


@pytest.mark.parametrize("device", [None, "cuda"])
def test_the_gateway_runs_on_the_card_unless_told_otherwise(device):
    """Without a GPU, the default device and ``cuda`` raise; the CPU is
    never chosen silently."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    base = free_port_base(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SwarmGateway(ptypes.Endpoint.from_parts("127.0.0.1", base), n_virtual=8,
                     device=device)
