"""The port's native epoll transport (``rapid_tpu_torch/messaging/native_tcp.py``
on ``runtime/native_io.py`` over ``csrc/host/rapid_io.cpp``).

Twins of ``tests/test_native_tcp.py`` but for its ``slow`` ThreadSanitizer
stress, with the wire crossed between packages: ``rapid_tpu``'s pure-Python
clients against the port's native server, the port's native client against
``rapid_tpu``'s Python server, BOOTSTRAPPING before the service is wired,
the ephemeral port, EOF on shutdown, a stalled peer, an oversized frame, and
a real-time cluster of port members entirely on the native transport. Last,
``chip_smoke.py``'s native gateway phase on the CPU at 1000 virtual members
(``gateway_sequence(native_server=True)``): the port's
``SwarmGateway(native_server=True)`` with a member in its own process, every
configuration id equal to the Python server's run; and ``native_gateway``,
the port agent on ``--transport native-tcp``."""

import socket
import struct
import threading
import time

import pytest
from harness import free_port_base

import chip_smoke
import rapid_tpu.types as rtypes
from rapid_tpu.messaging.tcp import TcpClientServer as JaxTransport
from rapid_tpu.runtime.futures import Promise as JaxPromise
from rapid_tpu.settings import Settings as JaxSettings
from rapid_tpu_torch import ClusterBuilder, Settings
from rapid_tpu_torch import types as ptypes
from rapid_tpu_torch.messaging.native_tcp import NativeTcpClientServer, native_io_available
from rapid_tpu_torch.monitoring.static_fd import StaticFailureDetectorFactory
from rapid_tpu_torch.runtime.futures import Promise as PortPromise
from rapid_tpu_torch.runtime.native_io import EV_FRAME, NativeReactor

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py

pytestmark = pytest.mark.skipif(
    not native_io_available(), reason="the port's rapid_io.cpp did not build (no g++)"
)

NID = rtypes.NodeId(424242, -171717)


@pytest.fixture
def port_base():
    return free_port_base(24)


class EchoService:
    """A membership service stand-in for either package: probes answered
    OK, everything else an empty ``Response``."""

    def __init__(self, types, promise):
        self.types, self.promise = types, promise
        self.count = 0
        self.lock = threading.Lock()

    def handle_message(self, msg):
        with self.lock:
            self.count += 1
        if isinstance(msg, self.types.ProbeMessage):
            return self.promise.completed(self.types.ProbeResponse(self.types.NodeStatus.OK))
        return self.promise.completed(self.types.Response())


def jax_client(port):
    return JaxTransport(rtypes.Endpoint.from_parts("127.0.0.1", port))


def test_jax_clients_against_port_native_server(port_base):
    """Wire interop: 20 ``rapid_tpu`` Python clients x 5 requests against one
    port native server (NettyClientServerTest.java:41-81 at the same load)."""
    addr = ptypes.Endpoint.from_parts("127.0.0.1", port_base)
    server = NativeTcpClientServer(addr)
    service = EchoService(ptypes, PortPromise)
    server.set_membership_service(service)
    server.start()
    clients = [jax_client(port_base + 1 + i) for i in range(20)]
    try:
        target = rtypes.Endpoint.from_parts("127.0.0.1", port_base)
        promises = [c.send_message(target, rtypes.ProbeMessage(sender=c.address))
                    for c in clients for _ in range(5)]
        for p in promises:
            assert p.result(10) == rtypes.ProbeResponse(rtypes.NodeStatus.OK)
        assert service.count == 100
    finally:
        for c in clients:
            c.shutdown()
        server.shutdown()


def test_port_native_client_against_jax_python_server(port_base):
    """The inherited client half of the port's native transport speaks to
    ``rapid_tpu``'s Python server."""
    server = JaxTransport(rtypes.Endpoint.from_parts("127.0.0.1", port_base))
    server.set_membership_service(EchoService(rtypes, JaxPromise))
    server.start()
    client = NativeTcpClientServer(ptypes.Endpoint.from_parts("127.0.0.1", port_base + 1))
    client.start()
    try:
        p = client.send_message(ptypes.Endpoint.from_parts("127.0.0.1", port_base),
                                ptypes.ProbeMessage(sender=client.address))
        assert p.result(10) == ptypes.ProbeResponse(ptypes.NodeStatus.OK)
    finally:
        client.shutdown()
        server.shutdown()


def test_bootstrapping_before_service_wired_native(port_base):
    """GrpcServer.java:83-95 semantics on the port's native server: probes
    answered BOOTSTRAPPING before ``set_membership_service``, everything else
    dropped."""
    server = NativeTcpClientServer(ptypes.Endpoint.from_parts("127.0.0.1", port_base))
    server.start()
    target = rtypes.Endpoint.from_parts("127.0.0.1", port_base)
    client = jax_client(port_base + 1)
    fast_client = JaxTransport(rtypes.Endpoint.from_parts("127.0.0.1", port_base + 2),
                               JaxSettings(message_timeout_ms=200))
    try:
        p = client.send_message_best_effort(target, rtypes.ProbeMessage(sender=client.address))
        assert p.result(10) == rtypes.ProbeResponse(rtypes.NodeStatus.BOOTSTRAPPING)
        p2 = fast_client.send_message_best_effort(
            target, rtypes.PreJoinMessage(sender=fast_client.address, node_id=NID))
        with pytest.raises(TimeoutError):
            p2.result(5)
    finally:
        fast_client.shutdown()
        client.shutdown()
        server.shutdown()


def test_ephemeral_port_adopted(port_base):
    """Binding port 0 adopts the kernel-assigned port into the address."""
    server = NativeTcpClientServer(ptypes.Endpoint.from_parts("127.0.0.1", 0))
    server.set_membership_service(EchoService(ptypes, PortPromise))
    server.start()
    client = jax_client(port_base)
    try:
        assert server.address.port > 0
        p = client.send_message(rtypes.Endpoint(server.address.hostname, server.address.port),
                                rtypes.ProbeMessage(sender=client.address))
        assert p.result(10) == rtypes.ProbeResponse(rtypes.NodeStatus.OK)
    finally:
        client.shutdown()
        server.shutdown()


def test_peer_senses_native_shutdown_by_eof(port_base):
    """``shutdown()`` FINs accepted connections: a ``rapid_tpu`` client sees
    EOF promptly instead of waiting for its deadline."""
    server = NativeTcpClientServer(ptypes.Endpoint.from_parts("127.0.0.1", port_base))
    server.set_membership_service(EchoService(ptypes, PortPromise))
    server.start()
    target = rtypes.Endpoint.from_parts("127.0.0.1", port_base)
    client = jax_client(port_base + 1)
    try:
        p = client.send_message(target, rtypes.ProbeMessage(sender=client.address))
        assert p.result(10) == rtypes.ProbeResponse(rtypes.NodeStatus.OK)
        conn = client._connection(target)  # noqa: SLF001 -- liveness probe
        server.shutdown()
        deadline = time.time() + 5
        while time.time() < deadline and not conn.closed:
            time.sleep(0.02)
        assert conn.closed, "client never observed the server's FIN"
    finally:
        client.shutdown()
        server.shutdown()


def test_real_time_cluster_on_native_transport(port_base):
    """A live 3-member cluster of port members entirely on the port's native
    transport: join, converge, crash one, converge again."""
    blacklist = set()
    settings = Settings(failure_detector_interval_ms=30, batching_window_ms=10,
                        consensus_fallback_base_delay_ms=200)

    def build(i, seed=None):
        addr = ptypes.Endpoint.from_parts("127.0.0.1", port_base + i)
        transport = NativeTcpClientServer(addr, settings)
        builder = (ClusterBuilder(addr).use_settings(settings)
                   .set_messaging_client_and_server(transport, transport)
                   .set_edge_failure_detector_factory(StaticFailureDetectorFactory(blacklist)))
        return builder.start() if seed is None else builder.join(seed, timeout=30)

    seed = build(0)
    c1 = build(1, seed.listen_address)
    c2 = build(2, seed.listen_address)
    try:
        deadline = time.time() + 30
        while time.time() < deadline and not (
                seed.get_membership_size() == c1.get_membership_size()
                == c2.get_membership_size() == 3):
            time.sleep(0.05)
        assert seed.get_membership_size() == 3
        assert seed.get_memberlist() == c1.get_memberlist() == c2.get_memberlist()
        assert seed.get_current_configuration_id() == c2.get_current_configuration_id()

        blacklist.add(c2.listen_address)
        c2.shutdown()
        deadline = time.time() + 30
        while time.time() < deadline and not (
                seed.get_membership_size() == 2 == c1.get_membership_size()):
            time.sleep(0.05)
        assert seed.get_membership_size() == 2 and c1.get_membership_size() == 2
        assert seed.get_current_configuration_id() == c1.get_current_configuration_id()
    finally:
        seed.shutdown()
        c1.shutdown()


def test_send_never_blocks_on_stalled_peer():
    """A peer that stops reading must not block ``send()``: bytes queue in
    the reactor and flush on EPOLLOUT once the peer drains, intact and in
    order."""
    reactor = NativeReactor("127.0.0.1", 0)
    try:
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
        sock.connect(("127.0.0.1", reactor.port))
        sock.sendall(struct.pack("!I", 3) + b"hi!")
        ev, conn_id, payload = reactor.poll(timeout_ms=5000)
        assert ev == EV_FRAME and payload == b"hi!"

        chunk = bytes(range(256)) * 256  # 64 KiB
        t0 = time.time()
        for _ in range(200):
            assert reactor.send(conn_id, chunk)
        assert time.time() - t0 < 5.0, "send() blocked on a stalled peer"

        def read_exactly(n):
            buf = bytearray()
            while len(buf) < n:
                got = sock.recv(n - len(buf))
                assert got, "connection died mid-drain"
                buf.extend(got)
            return bytes(buf)

        sock.settimeout(30)
        for i in range(200):
            (length,) = struct.unpack("!I", read_exactly(4))
            assert length == len(chunk), f"frame {i} length {length}"
            assert read_exactly(length) == chunk, f"frame {i} corrupted"
        sock.close()
    finally:
        reactor.shutdown()


def test_oversized_frame_kills_only_that_connection():
    """A frame claiming more than 64 MiB drops that connection; the others
    keep working. A frame larger than the poll buffer grows it."""
    reactor = NativeReactor("127.0.0.1", 0)
    try:
        bad = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        bad.connect(("127.0.0.1", reactor.port))
        good = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        good.connect(("127.0.0.1", reactor.port))

        bad.sendall(struct.pack("!I", (64 << 20) + 1))
        bad.settimeout(10)
        assert bad.recv(1) == b""

        big = bytes(range(251)) * 8000  # ~2 MB, past the 1 MiB buffer
        good.sendall(struct.pack("!I", 5) + b"hello" + struct.pack("!I", len(big)) + big)
        seen = []
        deadline = time.time() + 10
        while time.time() < deadline and len(seen) < 2:
            ev, _, payload = reactor.poll(timeout_ms=500)
            if ev == EV_FRAME:
                seen.append(payload)
        assert seen == [b"hello", big], "healthy connection was disturbed"
        good.close()
        bad.close()
    finally:
        reactor.shutdown()


def test_chip_smoke_native_gateway_and_agent():
    python_gateway = chip_smoke.gateway_sequence(1000, "cpu")
    python_agent = chip_smoke.agent_sequence(1000, "cpu", scripted=python_gateway)
    gateway = chip_smoke.gateway_sequence(1000, "cpu", native_server=True,
                                          member_port=python_gateway["member_port"])
    out = chip_smoke.native_gateway(1000, "cpu", python_agent)
    names = ["join", "crash, closed form", "crash, scan", "leave"]
    assert [r["name"] for r in gateway["steps"]] == names
    assert gateway["native_server"] and gateway["member_port"] \
        == python_gateway["member_port"]
    assert [r["configuration_id"] for r in gateway["steps"]] \
        == [r["configuration_id"] for r in python_gateway["steps"]]
    agent = out["agent"]
    assert agent["transport"] == "native-tcp" and agent["native_server"]
    assert [r["name"] for r in agent["steps"]] == names
    for row in agent["steps"]:
        assert row["configuration_id"] == row["plain_configuration_id"], row["name"]
    for row in agent["steps"][:3]:
        assert row["agent_configuration_id"] == row["configuration_id"], row["name"]
