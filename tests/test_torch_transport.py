"""The port's TCP transport (``rapid_tpu_torch/messaging/tcp.py``) against
``rapid_tpu``'s, across the wire in both directions.

Twins of the six cases of ``tests/test_tcp_transport.py``. In each, one side
is the port's ``TcpClientServer`` and the other ``rapid_tpu``'s, and every
socket case runs both ways round (``port_serves``: the port's server and
``rapid_tpu``'s clients; ``jax_serves``: the reverse). A service answers in
its own package's classes; only bytes cross. The live cluster runs
``rapid_tpu``'s ``ClusterBuilder`` on every node, one of them on the port's
transport behind an adapter that carries messages between the two
packages' classes by field names (``torch_wire_fixtures.convert``)."""

import sys
import threading
import time
from pathlib import Path

import pytest

import rapid_tpu.types as rtypes
from rapid_tpu import ClusterBuilder
from rapid_tpu.messaging import codec as jax_codec
from rapid_tpu.messaging.tcp import TcpClientServer as JaxTransport
from rapid_tpu.monitoring.static_fd import StaticFailureDetectorFactory
from rapid_tpu.runtime.futures import Promise as JaxPromise
from rapid_tpu.settings import Settings as JaxSettings
from rapid_tpu_torch import types as ptypes
from rapid_tpu_torch.messaging import codec as port_codec
from rapid_tpu_torch.messaging.tcp import TcpClientServer as PortTransport
from rapid_tpu_torch.runtime.futures import Promise as PortPromise
from rapid_tpu_torch.settings import Settings as PortSettings

sys.path.insert(0, str(Path(__file__).parent / "golden"))

import torch_wire_fixtures as fx  # noqa: E402

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py


class Side:
    """One package's transport, classes, promise and settings."""

    def __init__(self, transport, types, promise, settings):
        self.transport, self.T, self.Promise, self.Settings = transport, types, promise, settings

    def ep(self, port):
        return self.T.Endpoint.from_parts("127.0.0.1", port)


PORT = Side(PortTransport, ptypes, PortPromise, PortSettings)
JAX = Side(JaxTransport, rtypes, JaxPromise, JaxSettings)
DIRECTIONS = {"port_serves": (PORT, JAX), "jax_serves": (JAX, PORT)}


def _roundtrip_messages(T):
    ep1, ep2 = T.Endpoint.from_parts("127.0.0.1", 7101), T.Endpoint.from_parts("127.0.0.1", 7102)
    nid = T.NodeId(123456789, -987654321)
    return [
        T.PreJoinMessage(sender=ep1, node_id=nid),
        T.JoinMessage(sender=ep1, node_id=nid, ring_numbers=(0, 3, 9),
                      configuration_id=-5, metadata=(("role", b"backend"),)),
        T.JoinResponse(sender=ep2, status_code=T.JoinStatusCode.SAFE_TO_JOIN,
                       configuration_id=42, endpoints=(ep1, ep2), identifiers=(nid,),
                       metadata=((ep1, (("k", b"v"),)),)),
        T.BatchedAlertMessage(sender=ep1, messages=(
            T.AlertMessage(edge_src=ep1, edge_dst=ep2, edge_status=T.EdgeStatus.DOWN,
                           configuration_id=7, ring_numbers=(1, 2)),
            T.AlertMessage(edge_src=ep2, edge_dst=ep1, edge_status=T.EdgeStatus.UP,
                           configuration_id=7, ring_numbers=(0,), node_id=nid,
                           metadata=(("a", b"b"),)),
        )),
        T.ProbeMessage(sender=ep1),
        T.ProbeResponse(T.NodeStatus.BOOTSTRAPPING),
        T.FastRoundPhase2bMessage(sender=ep1, configuration_id=9, endpoints=(ep1, ep2)),
        T.Phase1bMessage(sender=ep2, configuration_id=9, rnd=T.Rank(2, -7),
                         vrnd=T.Rank(1, 1), vval=(ep1,)),
        T.Response(),
    ]


@pytest.mark.parametrize("i", range(len(_roundtrip_messages(ptypes))),
                         ids=lambda i: type(_roundtrip_messages(ptypes)[i]).__name__)
def test_codec_roundtrip(i):
    msg = _roundtrip_messages(ptypes)[i]
    jax_msg = _roundtrip_messages(rtypes)[i]
    frame = port_codec.encode(77, msg)
    assert frame == jax_codec.encode(77, jax_msg)
    assert port_codec.decode(frame) == (77, msg)
    assert jax_codec.decode(frame) == (77, jax_msg)


class EchoService:
    """Answers probes in its own package's classes; counts messages."""

    def __init__(self, side: Side):
        self.side = side
        self.count = 0
        self.types = set()
        self.lock = threading.Lock()

    def handle_message(self, msg):
        with self.lock:
            self.count += 1
            self.types.add(type(msg).__module__)
        T = self.side.T
        if isinstance(msg, T.ProbeMessage):
            return self.side.Promise.completed(T.ProbeResponse(T.NodeStatus.OK))
        return self.side.Promise.completed(T.Response())


@pytest.fixture
def port_base():
    from harness import free_port_base

    return free_port_base(120)


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_many_clients_one_server(port_base, direction):
    """NettyClientServerTest.java:41-81 (clients -> 1 server), across packages."""
    srv, cli = DIRECTIONS[direction]
    server_addr = srv.ep(port_base)
    server = srv.transport(server_addr)
    service = EchoService(srv)
    server.set_membership_service(service)
    server.start()
    clients = []
    try:
        clients = [cli.transport(cli.ep(port_base + 1 + i)) for i in range(20)]
        target = cli.ep(port_base)
        promises = [c.send_message(target, cli.T.ProbeMessage(sender=c.address))
                    for c in clients for _ in range(5)]
        for p in promises:
            assert p.result(10) == cli.T.ProbeResponse(cli.T.NodeStatus.OK)
        assert service.count == 100
        assert service.types == {srv.T.__name__}
    finally:
        for c in clients:
            c.shutdown()
        server.shutdown()


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_one_client_many_servers(port_base, direction):
    """NettyClientServerTest.java:83-117, across packages."""
    srv, cli = DIRECTIONS[direction]
    servers = []
    for i in range(10):
        server = srv.transport(srv.ep(port_base + i))
        server.set_membership_service(EchoService(srv))
        server.start()
        servers.append(server)
    client = cli.transport(cli.ep(port_base + 100))
    try:
        promises = [client.send_message(cli.ep(port_base + i),
                                        cli.T.ProbeMessage(sender=client.address))
                    for i in range(10)]
        for p in promises:
            assert p.result(10) == cli.T.ProbeResponse(cli.T.NodeStatus.OK)
    finally:
        client.shutdown()
        for s in servers:
            s.shutdown()


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_bootstrapping_before_service_wired(port_base, direction):
    """Probes answered BOOTSTRAPPING before set_membership_service
    (GrpcServer.java:83-95 semantics over TCP); other messages dropped."""
    srv, cli = DIRECTIONS[direction]
    addr = srv.ep(port_base)
    server = srv.transport(addr)
    server.start()
    client = cli.transport(cli.ep(port_base + 1))
    fast_client = cli.transport(cli.ep(port_base + 2), cli.Settings(message_timeout_ms=200))
    try:
        target = cli.ep(port_base)
        p = client.send_message_best_effort(target, cli.T.ProbeMessage(sender=client.address))
        assert p.result(10) == cli.T.ProbeResponse(cli.T.NodeStatus.BOOTSTRAPPING)
        p2 = fast_client.send_message_best_effort(
            target, cli.T.PreJoinMessage(sender=fast_client.address, node_id=cli.T.NodeId(1, 2)))
        with pytest.raises(TimeoutError):
            p2.result(5)
    finally:
        fast_client.shutdown()
        client.shutdown()
        server.shutdown()


class _PortAsJaxClient:
    """The port's transport as a ``rapid_tpu`` messaging client: messages go
    out in the port's classes, replies come back in ``rapid_tpu``'s."""

    def __init__(self, transport: PortTransport):
        self._t = transport

    def _relay(self, port_promise):
        out = JaxPromise()

        def done(p):
            if p.exception() is not None:
                out.try_set_exception(p.exception())
            else:
                out.try_set_result(fx.convert(p.peek(), rtypes))

        port_promise.add_callback(done)
        return out

    def send_message(self, remote, msg):
        return self._relay(self._t.send_message(fx.convert(remote, ptypes),
                                                fx.convert(msg, ptypes)))

    def send_message_best_effort(self, remote, msg):
        return self._relay(self._t.send_message_best_effort(fx.convert(remote, ptypes),
                                                            fx.convert(msg, ptypes)))

    def shutdown(self):
        self._t.shutdown()


class _PortAsJaxServer:
    """The port's transport as a ``rapid_tpu`` messaging server: requests
    reach the service in ``rapid_tpu``'s classes, responses go back in the
    port's."""

    def __init__(self, transport: PortTransport):
        self._t = transport

    def start(self):
        self._t.start()

    def shutdown(self):
        pass  # the client adapter shuts the shared transport down

    def set_membership_service(self, service):
        class Service:
            def handle_message(self, msg):
                out = PortPromise()

                def done(p):
                    if p.exception() is not None:
                        out.try_set_exception(p.exception())
                    else:
                        out.try_set_result(fx.convert(p.peek(), ptypes))

                service.handle_message(fx.convert(msg, rtypes)).add_callback(done)
                return out

        self._t.set_membership_service(Service())


def test_real_time_tcp_cluster(port_base):
    """A live 3-node cluster over real sockets and the real-time scheduler,
    its middle node on the port's transport: join, converge, crash the
    third, converge again."""
    blacklist = set()
    settings = JaxSettings(failure_detector_interval_ms=30, batching_window_ms=10,
                           consensus_fallback_base_delay_ms=200)
    port_settings = PortSettings(failure_detector_interval_ms=30, batching_window_ms=10,
                                 consensus_fallback_base_delay_ms=200)

    def build(i, seed=None, port_side=False):
        addr = JAX.ep(port_base + i)
        if port_side:
            transport = PortTransport(PORT.ep(port_base + i), port_settings)
            client, server = _PortAsJaxClient(transport), _PortAsJaxServer(transport)
        else:
            client = server = JaxTransport(addr, settings)
        builder = (
            ClusterBuilder(addr)
            .use_settings(settings)
            .set_messaging_client_and_server(client, server)
            .set_edge_failure_detector_factory(StaticFailureDetectorFactory(blacklist))
        )
        if seed is None:
            return builder.start()
        return builder.join(seed, timeout=30)

    def converged(nodes, size):
        deadline = time.time() + 30
        while time.time() < deadline:
            if all(n.get_membership_size() == size for n in nodes):
                return True
            time.sleep(0.05)
        return False

    seed = build(0)
    c1 = build(1, seed.listen_address, port_side=True)
    c2 = build(2, seed.listen_address)
    try:
        assert converged([seed, c1, c2], 3), [n.get_membership_size() for n in (seed, c1, c2)]
        assert seed.get_memberlist() == c1.get_memberlist() == c2.get_memberlist()
        assert (seed.get_current_configuration_id() == c1.get_current_configuration_id()
                == c2.get_current_configuration_id())
        blacklist.add(c2.listen_address)
        c2.shutdown()
        assert converged([seed, c1], 2), [n.get_membership_size() for n in (seed, c1)]
        assert seed.get_current_configuration_id() == c1.get_current_configuration_id()
    finally:
        seed.shutdown()
        c1.shutdown()


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_closed_connections_evicted_from_cache(port_base, direction):
    """A departed peer's closed connection leaves the client's outbound
    cache and its queue-depth digest, whichever package serves."""
    srv, cli = DIRECTIONS[direction]
    server_addr = srv.ep(port_base)
    server = srv.transport(server_addr)
    server.set_membership_service(EchoService(srv))
    server.start()
    client = cli.transport(cli.ep(port_base + 1))
    target = cli.ep(port_base)
    try:
        try:
            p = client.send_message(target, cli.T.ProbeMessage(sender=client.address))
            assert p.result(10) == cli.T.ProbeResponse(cli.T.NodeStatus.OK)
            with client._conn_lock:
                assert target in client._connections
            assert f"msg.queue_depth{{peer={target}}}" in client.transport_digest()
        finally:
            server.shutdown()
        deadline = time.time() + 10
        while time.time() < deadline:
            with client._conn_lock:
                if target not in client._connections:
                    break
            time.sleep(0.01)
        with client._conn_lock:
            assert target not in client._connections
        assert client.transport_digest() == {}
    finally:
        client.shutdown()
