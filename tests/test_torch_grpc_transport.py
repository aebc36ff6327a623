"""The port's gRPC transport (``GrpcServer``, ``GrpcClient`` in
``rapid_tpu_torch/messaging/grpc_transport.py`` over ``http2.py``) against
``rapid_tpu``'s on grpcio, across the wire in both directions.

- The golden capture (``tests/golden/torch_grpc_frames.json``): the port
  replays it (``chip_smoke.grpc_golden``, the card's check), and a fresh
  capture of grpcio decodes to the same header blocks.
- Crossed: the port's client against JAX's server and JAX's client against
  the port's server. Every request class of
  ``tests/golden/torch_proto_frames.json`` reaches the service as the same
  message and gets the reply JAX's client gets from JAX's server; probe and
  not-ready answers before the service is wired, and their status names;
  a reply of more than 1 MB and a request above 64 KB (flow control both
  ways); a message above 4 MiB as RESOURCE_EXHAUSTED; a deadline passed on a
  parked call as DEADLINE_EXCEEDED; a failing service as INTERNAL; gzip and
  deflate from grpcio; many concurrent calls on one connection.
- A live cluster of 2 JAX members on grpcio and 2 port members on the port's
  transport converges on one configuration id and survives a crash.
- Twins of ``tests/test_grpc_transport.py`` on the port alone: the live
  3-node cluster, channel invalidation across a peer restart, idle
  eviction, the join wave through one seed (10 joiners; a
  thread-per-response server with 8 workers deadlocks on it); of
  ``tests/test_batch_messaging.py::test_mixed_batched_unbatched_grpc_cluster_converges``
  and of ``tests/test_gossip.py::test_gossip_refused_on_jvm_wire_transport``;
  and the server's shutdown failing a parked call at once."""

import collections
import dataclasses
import json
import sys
import threading
import time
from pathlib import Path

import grpc
import pytest
from harness import free_port_base

import chip_smoke
import rapid_tpu.types as rtypes
from rapid_tpu import ClusterBuilder as JaxClusterBuilder
from rapid_tpu.messaging import grpc_transport as jax_gt
from rapid_tpu.messaging.wire_schema import GRPC_METHOD_PATH, MSG
from rapid_tpu.monitoring.static_fd import StaticFailureDetectorFactory as JaxStaticFd
from rapid_tpu.runtime.futures import Promise as JaxPromise
from rapid_tpu.settings import Settings as JaxSettings
from rapid_tpu_torch import ClusterBuilder, Settings
from rapid_tpu_torch import types as ptypes
from rapid_tpu_torch.cluster import JoinException
from rapid_tpu_torch.messaging import grpc_transport as port_gt
from rapid_tpu_torch.messaging.gossip import GossipBroadcaster
from rapid_tpu_torch.messaging.http2 import MAX_MESSAGE, GrpcError
from rapid_tpu_torch.monitoring.static_fd import StaticFailureDetectorFactory
from rapid_tpu_torch.runtime.futures import Promise as PortPromise

sys.path.insert(0, str(Path(__file__).parent / "golden"))
import generate_torch_grpc_frames as gen  # noqa: E402
import torch_wire_fixtures as fx  # noqa: E402

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py

WAIT_S = 20.0
AGREE_S = 30.0  # a live cluster's wait for agreement, a join's limit too
GOLDEN = json.loads((Path(__file__).parent / "golden" / "torch_grpc_frames.json").read_text())
PROTO = json.loads((Path(__file__).parent / "golden" / "torch_proto_frames.json").read_text())
REQUESTS = collections.defaultdict(list)
for _frame in PROTO["frames"]:
    if _frame["direction"] == "request" and "error" not in _frame:
        REQUESTS[_frame["message"]["msg"][0]].append(_frame)
# each request class's reply: a response frame of the golden corpus
REPLY_FRAME = {"JoinMessage": "JoinResponse", "PreJoinMessage": "JoinResponse",
               "ProbeMessage": "ProbeResponse", "ClusterStatusRequest": "ClusterStatusResponse",
               "Get": "PutAck", "Put": "PutAck", "HandoffRequest": "HandoffChunk"}
JAX, PORT = fx.jax_wire(), fx.port_wire()


class Side:
    """One package: its transport, classes, wire, promise and settings."""

    def __init__(self, gt, wire, promise, settings):
        self.gt, self.wire, self.T = gt, wire, wire.types
        self.Promise, self.Settings = promise, settings

    def ep(self, port):
        return self.T.Endpoint.from_parts("127.0.0.1", port)

    def client(self, port, **settings):
        return self.gt.GrpcClient(self.ep(port), self.Settings(**settings))


JAX_SIDE = Side(jax_gt, JAX, JaxPromise, JaxSettings)
PORT_SIDE = Side(port_gt, PORT, PortPromise, Settings)
# (client side, server side) of each crossing
CROSSED = {"port_client": (PORT_SIDE, JAX_SIDE), "jax_client": (JAX_SIDE, PORT_SIDE)}
# long deadlines, no retries: a failure shows as itself
CALL = {"message_retries": 0, "message_timeout_ms": 30_000, "join_message_timeout_ms": 30_000}


def reply_for(side, cls_name):
    name = REPLY_FRAME.get(cls_name)
    if name is None:
        return side.T.Response()
    frame = next(f for f in PROTO["frames"] if f["message"]["msg"][0] == name and "hex" in f)
    return fx.message(frame, side.wire)


class Service:
    """A membership service stand-in: records each request and answers with
    its class's reply, or ``override(msg)`` where set (a reply, or an
    exception to fail the promise with, or ``None`` to park it)."""

    def __init__(self, side):
        self.side, self.received, self.override = side, [], None

    def handle_message(self, msg):
        self.received.append(msg)
        promise = self.side.Promise()
        reply = (self.override(msg) if self.override is not None
                 else reply_for(self.side, type(msg).__name__))
        if isinstance(reply, Exception):
            promise.set_exception(reply)
        elif reply is not None:
            promise.set_result(reply)
        return promise


class Ends:
    """A server of each package with its service, and a client of each."""

    def __init__(self, wired=True):
        base = free_port_base(4)
        self.ports = {"jax": base, "port": base + 1}
        self.servers, self.services, self.clients = {}, {}, {}
        for i, (name, side) in enumerate((("jax", JAX_SIDE), ("port", PORT_SIDE))):
            server = side.gt.GrpcServer(side.ep(self.ports[name]))
            self.services[name] = Service(side)
            if wired:
                server.set_membership_service(self.services[name])
            server.start()
            self.servers[name] = server
            self.clients[name] = side.client(base + 2 + i, **CALL)

    def call(self, client, server, msg_for):
        """``client``'s package sends ``msg_for(side)`` to ``server``'s
        package's server: the reply, or the error raised."""
        side = JAX_SIDE if client == "jax" else PORT_SIDE
        try:
            return self.clients[client].send_message(
                side.ep(self.ports[server]), msg_for(side)).result(WAIT_S)
        except (grpc.RpcError, GrpcError) as e:
            return e

    def close(self):
        for c in self.clients.values():
            c.shutdown()
        for s in self.servers.values():
            s.shutdown()


@pytest.fixture(scope="module")
def ends():
    e = Ends()
    try:
        yield e
    finally:
        e.close()


def status(outcome):
    """A failed call as (status name, details)."""
    assert isinstance(outcome, (grpc.RpcError, GrpcError)), outcome
    return outcome.code().name, outcome.details()


def contexts(msg, wire):
    tc, hlc = wire.trace_context_of(msg), wire.hlc_of(msg)
    return (None if tc is None else dataclasses.astuple(tc),
            None if hlc is None else dataclasses.astuple(hlc))


# ---------------------------------------------------------------------------
# the golden capture
# ---------------------------------------------------------------------------


def test_golden_capture_replays():
    out = chip_smoke.grpc_golden("cpu")
    assert out["blocks"] == sum(len(c[side]["blocks"]) for c in GOLDEN["captures"].values()
                                for side in ("client", "server"))


@pytest.mark.parametrize("server", gen.SERVERS)
def test_golden_capture_equals_a_fresh_one(server):
    """grpcio still puts the recorded header blocks on the wire, per-run
    values (``gen.PER_RUN``) aside, and the calls end as recorded."""
    client, served, outcomes = gen.capture(server)
    recorded = GOLDEN["captures"][server]
    assert outcomes == recorded["calls"]
    assert GOLDEN["grpcio"] == grpc.__version__
    for side, data in (("client", client), ("server", served)):
        fresh = chip_smoke.decode_capture(data, client_side=side == "client")
        assert gen.masked(fresh["blocks"]) == gen.masked(recorded[side]["blocks"]), side


# ---------------------------------------------------------------------------
# the wire crossed between the packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cls", sorted(REQUESTS))
@pytest.mark.parametrize("direction", sorted(CROSSED))
def test_request_class_gets_the_reply_jax_gets(ends, direction, cls):
    """Every frame of the class: the crossed call delivers the message JAX's
    client delivers to JAX's server (fields, trace context and HLC stamp),
    and returns the reply JAX's client gets there."""
    client, server = CROSSED[direction]
    cname, sname = ("port", "jax") if direction == "port_client" else ("jax", "port")
    for frame in REQUESTS[cls]:
        baseline = ends.call("jax", "jax", lambda s: fx.message(frame, s.wire))
        want_msg = ends.services["jax"].received.pop()
        got = ends.call(cname, sname, lambda s: fx.message(frame, s.wire))
        got_msg = ends.services[sname].received.pop()
        assert fx.convert(got, client.T) == fx.convert(baseline, client.T), frame["name"]
        assert fx.convert(got_msg, JAX.types) == want_msg, frame["name"]
        assert contexts(got_msg, server.wire) == contexts(want_msg, JAX), frame["name"]


@pytest.mark.parametrize("client", ["jax", "port"])
@pytest.mark.parametrize("server", ["jax", "port"])
def test_before_the_service_is_wired(client, server):
    """A probe gets BOOTSTRAPPING, anything else UNAVAILABLE "membership
    service not ready", whichever package serves or calls."""
    e = Ends(wired=False)
    try:
        probe = e.call(client, server, lambda s: s.T.ProbeMessage(sender=s.ep(1)))
        side = JAX_SIDE if client == "jax" else PORT_SIDE
        assert probe == side.T.ProbeResponse(side.T.NodeStatus.BOOTSTRAPPING)
        leave = e.call(client, server, lambda s: s.T.LeaveMessage(sender=s.ep(1)))
        assert status(leave) == ("UNAVAILABLE", "membership service not ready")
    finally:
        e.close()


def _big_reply(side, n=30_000):
    return side.T.JoinResponse(
        sender=side.ep(1), status_code=side.T.JoinStatusCode.SAFE_TO_JOIN, configuration_id=-9,
        endpoints=fx.endpoints(side.T, n, 5000), identifiers=fx.node_ids(side.T, n, 3))


def _big_request(side, size):
    return side.T.JoinMessage(sender=side.ep(1), node_id=side.T.NodeId(1, 2),
                              ring_numbers=(0, 1), configuration_id=7,
                              metadata=(("blob", bytes(range(256)) * (size // 256)),))


@pytest.mark.parametrize("direction", sorted(CROSSED))
def test_large_messages_cross_both_ways(ends, direction):
    """A reply above 1 MB and a request above 64 KB (past HTTP/2's default
    65 535 B windows, before the peer's SETTINGS raise them) go through."""
    client, server = CROSSED[direction]
    cname, sname = ("port", "jax") if direction == "port_client" else ("jax", "port")
    ends.services[sname].override = lambda msg: _big_reply(server)
    try:
        got = ends.call(cname, sname, lambda s: _big_request(s, 200_000))
        assert got == _big_reply(client)
        assert len(port_gt.to_wire_response(_big_reply(PORT_SIDE))) > 1 << 20
        (received,) = ends.services[sname].received[-1:]
        assert received.metadata == _big_request(server, 200_000).metadata
    finally:
        ends.services[sname].override = None
        ends.services[sname].received.clear()


@pytest.mark.parametrize("what", ["request", "reply"])
@pytest.mark.parametrize("direction", sorted(CROSSED))
def test_above_4_mib_is_resource_exhausted(ends, direction, what):
    """grpcio's default 4 MiB receive limit, held by both packages: a
    request or a reply above it fails as RESOURCE_EXHAUSTED."""
    cname, sname = ("port", "jax") if direction == "port_client" else ("jax", "port")
    _, server = CROSSED[direction]
    size = MAX_MESSAGE + 4096
    if what == "reply":
        ends.services[sname].override = lambda msg: server.T.JoinResponse(
            sender=server.ep(1), status_code=server.T.JoinStatusCode.SAFE_TO_JOIN,
            configuration_id=1, metadata=((server.ep(2), (("blob", b"x" * size),)),))
    try:
        out = ends.call(cname, sname, lambda s: _big_request(s, size if what == "request" else 0))
        code, details = status(out)
        assert code == "RESOURCE_EXHAUSTED", details
        assert f"vs. {MAX_MESSAGE}" in details
        if what == "request":
            assert not ends.services[sname].received
    finally:
        ends.services[sname].override = None
        ends.services[sname].received.clear()


@pytest.mark.parametrize("client", ["jax", "port"])
@pytest.mark.parametrize("server", ["jax", "port"])
def test_parked_call_past_its_deadline(ends, client, server):
    """A call the service never answers ends as DEADLINE_EXCEEDED at its
    grpc-timeout, and a service that fails the promise gives INTERNAL with
    its text, whichever package serves or calls."""
    side = JAX_SIDE if client == "jax" else PORT_SIDE
    short = side.client(free_port_base(1), message_retries=0, message_timeout_ms=300)
    ends.services[server].override = lambda msg: None
    try:
        t0 = time.time()
        with pytest.raises((grpc.RpcError, GrpcError)) as info:
            short.send_message(side.ep(ends.ports[server]),
                               side.T.LeaveMessage(sender=side.ep(1))).result(WAIT_S)
        assert info.value.code().name == "DEADLINE_EXCEEDED"
        assert time.time() - t0 < 5
        ends.services[server].override = lambda msg: RuntimeError("the service broke")
        out = ends.call(client, server, lambda s: s.T.LeaveMessage(sender=s.ep(1)))
        assert status(out) == ("INTERNAL", "the service broke")
    finally:
        ends.services[server].override = None
        ends.services[server].received.clear()
        short.shutdown()


@pytest.mark.parametrize("compression", ["Gzip", "Deflate"])
def test_compressed_messages_from_grpcio(ends, compression):
    """grpcio's client compressing its request to the port's server, and
    grpcio's server compressing its reply to the port's client: both
    inflate."""
    request = jax_gt.to_wire_request(rtypes.ProbeMessage(sender=JAX_SIDE.ep(1)))
    channel = grpc.insecure_channel(f"127.0.0.1:{ends.ports['port']}",
                                    compression=getattr(grpc.Compression, compression))
    try:
        reply = channel.unary_unary(
            GRPC_METHOD_PATH, request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=MSG["RapidResponse"].FromString)(request, timeout=WAIT_S)
        assert jax_gt.from_wire_response(reply) == reply_for(JAX_SIDE, "ProbeMessage")
    finally:
        channel.close()
    assert ends.services["port"].received.pop() == PORT_SIDE.T.ProbeMessage(
        sender=PORT_SIDE.ep(1))
    server = grpc.server(__import__("concurrent.futures").futures.ThreadPoolExecutor(2),
                         compression=getattr(grpc.Compression, compression))
    reply = jax_gt.to_wire_response(_big_reply(JAX_SIDE, 2000))
    handler = grpc.unary_unary_rpc_method_handler(lambda req, ctx: reply,
                                                  response_serializer=lambda m: m.SerializeToString())
    server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(
        "remoting.MembershipService", {"sendRequest": handler}),))
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()
    try:
        got = ends.clients["port"].send_message(
            PORT_SIDE.ep(port), PORT_SIDE.T.ProbeMessage(sender=PORT_SIDE.ep(1))).result(WAIT_S)
        assert got == _big_reply(PORT_SIDE, 2000)
    finally:
        server.stop(0).wait()


@pytest.mark.parametrize("direction", sorted(CROSSED))
def test_concurrent_calls_share_one_connection(ends, direction):
    """200 calls at once on one connection: every header block decoded in
    arrival order keeps both sides' HPACK tables in step, and every call
    gets its reply."""
    cname, sname = ("port", "jax") if direction == "port_client" else ("jax", "port")
    client, _ = CROSSED[direction]
    c = ends.clients[cname]
    dials = getattr(c, "stats", {}).get("connections", 0)
    futures = [c.send_message(client.ep(ends.ports[sname]),
                              client.T.ProbeMessage(sender=client.ep(i)))
               for i in range(200)]
    want = reply_for(client, "ProbeMessage")
    assert [f.result(WAIT_S) for f in futures] == [want] * 200
    got = sorted(m.sender.port for m in ends.services[sname].received[-200:])
    assert got == list(range(200))
    ends.services[sname].received.clear()
    if cname == "port":
        assert c.stats["connections"] - dials <= 1  # the 200 calls shared one connection


def _mixed_member(kind, i, base, settings, blacklists, seed=None):
    if kind == "jax":
        addr = JAX_SIDE.ep(base + i)
        builder = (JaxClusterBuilder(addr).use_settings(JaxSettings(**settings))
                   .set_messaging_client_and_server(jax_gt.GrpcClient(addr, JaxSettings(**settings)),
                                                    jax_gt.GrpcServer(addr))
                   .set_edge_failure_detector_factory(JaxStaticFd(blacklists["jax"])))
    else:
        addr = PORT_SIDE.ep(base + i)
        builder = (ClusterBuilder(addr).use_settings(Settings(**settings))
                   .set_messaging_client_and_server(port_gt.GrpcClient(addr, Settings(**settings)),
                                                    port_gt.GrpcServer(addr))
                   .set_edge_failure_detector_factory(StaticFailureDetectorFactory(
                       blacklists["port"])))
    if seed is None:
        return builder.start()
    side = JAX_SIDE if kind == "jax" else PORT_SIDE
    return builder.join(side.ep(seed), timeout=30)


def test_mixed_cluster_of_both_packages_converges_and_survives_a_crash():
    """2 JAX members on grpcio and 2 port members on the port's transport:
    one member list and one configuration id; then a port member crashes
    and the other 3 agree again."""
    base = free_port_base(5)
    settings = {"failure_detector_interval_ms": 50, "batching_window_ms": 20,
                "consensus_fallback_base_delay_ms": 300}
    blacklists = {"jax": set(), "port": set()}
    kinds = ("jax", "port", "jax", "port")
    clusters = [_mixed_member(kinds[0], 0, base, settings, blacklists)]
    try:
        for i in range(1, 4):
            clusters.append(_mixed_member(kinds[i], i, base, settings, blacklists, seed=base))
            chip_smoke._until_agreed(clusters, i + 1, timeout=AGREE_S)
        joined = chip_smoke._until_agreed(clusters, 4, timeout=AGREE_S)
        victim = clusters.pop()
        blacklists["jax"].add(JAX_SIDE.ep(base + 3))
        blacklists["port"].add(PORT_SIDE.ep(base + 3))
        victim.shutdown()
        crashed = chip_smoke._until_agreed(clusters, 3, timeout=AGREE_S)
        assert crashed != joined
    finally:
        for c in clusters:
            c.shutdown()


# ---------------------------------------------------------------------------
# twins of the JAX package's gRPC tests, on the port alone
# ---------------------------------------------------------------------------


def _port_member(i, base, settings, blacklist, seed=None):
    """Member ``i`` on the port's gRPC at ``base + i`` (``chip_smoke._grpc_member``)."""
    return chip_smoke._grpc_member(i, range(base, base + i + 1), settings, blacklist, seed,
                                   timeout=AGREE_S)


def test_live_grpc_cluster():
    """3-node cluster over the port's gRPC sockets: join, converge, crash,
    converge."""
    base = free_port_base(8)
    blacklist = set()
    settings = Settings(failure_detector_interval_ms=30, batching_window_ms=10,
                        consensus_fallback_base_delay_ms=200)
    seed = _port_member(0, base, settings, blacklist)
    c1 = _port_member(1, base, settings, blacklist, seed.listen_address)
    c2 = _port_member(2, base, settings, blacklist, seed.listen_address)
    try:
        chip_smoke._until_agreed([seed, c1, c2], 3, timeout=AGREE_S)
        blacklist.add(c2.listen_address)
        c2.shutdown()
        chip_smoke._until_agreed([seed, c1], 2, timeout=AGREE_S)
    finally:
        seed.shutdown()
        c1.shutdown()


def test_channel_invalidation_peer_restart():
    """Kill a peer and restart it on the same address: the next send_message
    succeeds within the retry budget -- the cached channel to the dead peer is
    invalidated on failure (Retries.java:63-66, GrpcClient.java:113,131)."""
    base = free_port_base(2)
    addr, me = PORT_SIDE.ep(base), PORT_SIDE.ep(base + 1)
    bootstrapping = ptypes.ProbeResponse(ptypes.NodeStatus.BOOTSTRAPPING)
    client = port_gt.GrpcClient(me, Settings())
    server = port_gt.GrpcServer(addr)
    server.start()
    try:
        assert client.send_message(addr, ptypes.ProbeMessage(sender=me)).result(10) == bootstrapping
        server.shutdown()
        with pytest.raises(GrpcError) as info:
            client.send_message(addr, ptypes.ProbeMessage(sender=me)).result(15)
        assert info.value.code().name == "UNAVAILABLE"
        assert addr not in client._channels  # the failed call dropped the cached channel
        server = port_gt.GrpcServer(addr)  # restart on the SAME address
        server.start()
        assert client.send_message(addr, ptypes.ProbeMessage(sender=me)).result(10) == bootstrapping
    finally:
        server.shutdown()
        client.shutdown()


def test_channel_idle_eviction():
    """Channels idle past IDLE_EVICT_S are evicted from the cache
    (GrpcClient.java:87-95's 30s expireAfterAccess)."""
    base = free_port_base(2)
    addr, me = PORT_SIDE.ep(base), PORT_SIDE.ep(base + 1)
    client = port_gt.GrpcClient(me, Settings())
    client.IDLE_EVICT_S = 0.05
    server = port_gt.GrpcServer(addr)
    server.start()
    try:
        client.send_message(addr, ptypes.ProbeMessage(sender=me)).result(10)
        assert addr in client._channels
        time.sleep(0.15)
        other = PORT_SIDE.ep(base + 2)
        client._stub(other)  # any access sweeps the idle set
        assert addr not in client._channels  # the stale entry was evicted
        assert other in client._channels
    finally:
        server.shutdown()
        client.shutdown()


def test_concurrent_join_wave_through_one_seed():
    """10 concurrent joiners through ONE seed over real sockets. Join
    phase-2 responses are parked until the view change commits
    (MembershipService.java:229-286); with a thread-per-response server of 8
    workers this deadlocks, so this is the proof that RPC completion is
    asynchronous (GrpcServer.java:77-96 parity)."""
    n_joiners = 10
    base = free_port_base(n_joiners + 2)
    settings = Settings(failure_detector_interval_ms=100, batching_window_ms=50,
                        consensus_fallback_base_delay_ms=500)
    blacklist = set()
    seed = _port_member(0, base, settings, blacklist)
    clusters, errors, lock = [seed], [], threading.Lock()

    def join(i):
        try:
            c = _port_member(i, base, settings, blacklist, seed.listen_address)
            with lock:
                clusters.append(c)
        except Exception as e:  # noqa: BLE001
            errors.append((i, e))

    threads = [threading.Thread(target=join, args=(i,)) for i in range(1, n_joiners + 1)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert not errors, f"join failures: {errors}"
        chip_smoke._until_agreed(clusters, n_joiners + 1, timeout=AGREE_S)
    finally:
        for c in clusters:
            c.shutdown()


def test_mixed_batched_unbatched_grpc_cluster_converges():
    """3 live port members on gRPC where only nodes 0 and 2 batch
    broadcasts: join, converge, push a burst through a batching node's
    broadcaster so MessageBatch envelopes reach the unbatched node, crash the
    batched node 2 and converge again (twin of
    ``tests/test_batch_messaging.py``'s gRPC case)."""
    base = free_port_base(4)
    blacklist = set()

    def settings_for(i):
        return Settings(failure_detector_interval_ms=50, batching_window_ms=10,
                        consensus_fallback_base_delay_ms=300,
                        broadcast_flush_window_ms=15 if i % 2 == 0 else 0)

    clusters = [_port_member(0, base, settings_for(0), blacklist)]
    try:
        for i in (1, 2):
            clusters.append(_port_member(i, base, settings_for(i), blacklist,
                                         clusters[0].listen_address))
        chip_smoke._until_agreed(clusters, 3, timeout=AGREE_S)
        for _ in range(6):
            clusters[0]._membership_service._broadcaster.broadcast(
                ptypes.ProbeMessage(sender=clusters[0].listen_address))
        unbatched = clusters[1]._membership_service.metrics
        deadline = time.time() + 30
        while time.time() < deadline and unbatched.snapshot().get("messages.MessageBatch", 0) < 1:
            time.sleep(0.05)
        snap = unbatched.snapshot()
        assert snap.get("messages.MessageBatch", 0) >= 1, snap
        assert snap.get("messages.ProbeMessage", 0) >= 6, snap
        crashed = clusters.pop()
        blacklist.add(crashed.listen_address)
        crashed.shutdown()
        chip_smoke._until_agreed(clusters, 2, timeout=AGREE_S)
    finally:
        for c in clusters:
            c.shutdown()


def test_gossip_refused_on_jvm_wire_transport():
    """Build-time rejection of the gossip + gRPC pairing: the JVM wire has
    no GossipEnvelope, so best-effort dissemination would fail silently."""
    addr = PORT_SIDE.ep(45991)
    client, server = port_gt.GrpcClient(addr), port_gt.GrpcServer(addr)
    builder = (ClusterBuilder(addr).set_messaging_client_and_server(client, server)
               .set_broadcaster_factory(
                   lambda c, rng: GossipBroadcaster(c, c.address, fanout=4, rng=rng)))
    with pytest.raises(JoinException, match="native-codec transport"):
        builder.start()


def test_shutdown_fails_a_parked_call_at_once():
    """The server's shutdown sends GOAWAY, gives calls in flight 0.5 s and
    closes: a parked call fails as UNAVAILABLE then, long before its
    deadline, and the server's connections are gone."""
    base = free_port_base(2)
    addr, me = PORT_SIDE.ep(base), PORT_SIDE.ep(base + 1)
    service = Service(PORT_SIDE)
    service.override = lambda msg: None  # parked for good
    server = port_gt.GrpcServer(addr)
    server.set_membership_service(service)
    server.start()
    client = port_gt.GrpcClient(me, Settings(message_retries=0, join_message_timeout_ms=30_000))
    try:
        parked = client.send_message(addr, ptypes.JoinMessage(
            sender=me, node_id=ptypes.NodeId(1, 2), ring_numbers=(0,), configuration_id=1))
        deadline = time.time() + WAIT_S
        while not service.received and time.time() < deadline:
            time.sleep(0.01)
        t0 = time.time()
        server.shutdown()
        with pytest.raises(GrpcError) as info:
            parked.result(WAIT_S)
        assert info.value.code().name == "UNAVAILABLE"
        assert time.time() - t0 < 3
        assert not server._connections
        assert server.stats["GOAWAY out"] == 1
    finally:
        client.shutdown()


# ---------------------------------------------------------------------------
# the card's phase at small sizes
# ---------------------------------------------------------------------------


def test_chip_phase_join_response_over_every_transport():
    """``chip_smoke.grpc_join_response``: the 100k ``JoinResponse`` arrives
    equal over the port's gRPC, TCP and native TCP transports, its gRPC wall
    split into encode, transfer and decode."""
    runs = chip_smoke.grpc_join_response("cpu", reps=1)
    g = runs["grpc"]
    assert set(runs) == {"grpc", "tcp", "native-tcp"}
    assert g["encode_ms"] > 0 and g["decode_ms"] > 0 and g["data_frames"] >= 1
    assert g["wall_ms"] == pytest.approx(g["encode_ms"] + g["transfer_ms"] + g["decode_ms"])


def test_chip_phase_cluster():
    """``chip_smoke.grpc_cluster`` with 5 joiners: one configuration id after
    the wave, another after the crash."""
    out = chip_smoke.grpc_cluster("cpu", joiners=5)
    assert out["joined_id"] != out["crashed_id"]
