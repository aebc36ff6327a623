"""Real-socket TCP transport: length-prefixed frames, request/response
correlation, connection reuse.

The port's own copy of ``rapid_tpu/messaging/tcp.py``, on the port's codec:
its frames are ``rapid_tpu``'s, so either package's transport talks to the
other's. The analogue of the reference's raw-Netty alternative transport
(NettyClientServer.java): one class implements both IMessagingClient and
IMessagingServer (:65); responses are matched to requests via a per-connection
request number (:267-277); outbound channels are cached per remote. Framing
and payload encoding live in ``messaging/codec.py``.

Built on the event-loop core in ``messaging/reactor.py``: one I/O thread per
``TcpClientServer`` multiplexes every inbound and outbound socket through a
``selectors`` loop, replacing the old thread-per-connection design (a reader
thread per ``_Connection``, a thread per accepted socket, and the shared
``_TimeoutWheel`` deadline thread). Request deadlines are reactor timers;
outbound frames coalesce in per-peer channel queues and flush with one
scatter-gather syscall per tick per peer; dials are nonblocking ``connect``s
observed by the reactor, gated per peer by a decorrelated-jitter backoff so
a crashed peer costs one pending dial, not a connect storm. The swarm
gateway (``gateway.py``) sends through it and builds its server on
``FramedTcpServer``.
"""

from __future__ import annotations

import itertools
import logging
import random
import socket
import threading
import time
from typing import Callable, Dict, Optional

from ..observability import Metrics, global_metrics
from ..runtime.lockdep import make_lock
from ..runtime.futures import Promise
from ..settings import Settings
from ..types import Endpoint, NodeStatus, ProbeMessage, ProbeResponse, RapidMessage
from .base import IMessagingClient, IMessagingServer
from .codec import HEADER, decode, encode
from .reactor import Acceptor, Channel, Reactor, shared_reactor
from .retries import RetryPolicy, call_with_retries, wall_scheduler

LOG = logging.getLogger(__name__)


def _write_frame(sock, frame: bytes) -> None:
    """Write one length-prefixed frame. Channel-backed writers (everything
    the reactor accepted) expose ``send_frame`` and take the zero-copy
    queued path; plain sockets fall back to a blocking ``sendall``."""
    send_frame = getattr(sock, "send_frame", None)
    if send_frame is not None:
        send_frame(frame)
    else:
        sock.sendall(HEADER.pack(len(frame)) + frame)


class _Connection:
    """One outbound connection: a reactor channel plus the response
    correlation map. The dial is nonblocking -- frames queue in the channel
    until the connect completes, and a failed or timed-out dial fails every
    pending promise via the channel's close callback."""

    def __init__(
        self,
        remote: Endpoint,
        timeout_s: float,
        reactor: Optional[Reactor] = None,
        metrics: Optional[Metrics] = None,
        on_dial_outcome: Optional[Callable[[Endpoint, bool], None]] = None,
        on_closed: Optional[Callable[["_Connection"], None]] = None,
    ) -> None:
        self.remote = remote
        self.reactor = reactor if reactor is not None else shared_reactor()
        self.lock = make_lock("_Connection.lock")
        self.outstanding: Dict[int, Promise] = {}  # guarded-by: lock
        self.closed = False  # guarded-by: lock
        self._on_dial_outcome = on_dial_outcome
        self._on_closed = on_closed
        self.channel = Channel.connect(
            self.reactor,
            (remote.hostname.decode(), remote.port),
            timeout_s,
            self._chan_frame,
            on_close=self._chan_closed,
            on_connect=self._chan_connected,
            metrics=metrics,
        )

    def _chan_frame(self, channel: Channel, frame: memoryview) -> None:
        request_no, response = decode(frame)
        with self.lock:
            promise = self.outstanding.pop(request_no, None)
        if promise is not None:
            promise.try_set_result(response)

    def _chan_connected(self, channel: Channel) -> None:
        if self._on_dial_outcome is not None:
            self._on_dial_outcome(self.remote, True)

    def _chan_closed(self, channel: Channel, exc) -> None:
        with self.lock:
            if self.closed:
                return
            self.closed = True
            pending = list(self.outstanding.values())
            self.outstanding.clear()
        if not channel.connected and self._on_dial_outcome is not None:
            self._on_dial_outcome(self.remote, False)
        if self._on_closed is not None:
            self._on_closed(self)
        for promise in pending:
            if not promise.done():
                try:
                    promise.set_exception(ConnectionError("connection closed"))
                except Exception:  # noqa: BLE001 -- lost race with completion
                    pass

    def pending_bytes(self) -> int:
        return self.channel.pending_bytes()

    def forget(self, request_no: int) -> None:
        """Drop a correlation entry whose promise completed without a response
        frame (timeout/drop) -- otherwise entries accumulate for the life of
        the connection."""
        with self.lock:
            self.outstanding.pop(request_no, None)

    def close(self) -> None:
        self.channel.close(None)


def send_framed(conn: _Connection, request_no: int, frame: bytes,
                timeout_s: float, remote: Endpoint) -> Promise:
    """One framed request over a correlated connection: register the entry,
    queue the frame (the channel's outbound queue keeps concurrent senders'
    frames whole and ordered), arm the deadline as a reactor timer, and reap
    the correlation entry on completion. Shared by the node transport and
    the gateway-routed client so the scaffolding cannot drift between
    them."""
    out: Promise = Promise()
    with conn.lock:
        if conn.closed:
            already_closed = True
        else:
            already_closed = False
            conn.outstanding[request_no] = out
    if already_closed:
        out.set_exception(ConnectionError("connection closed"))
        return out
    try:
        conn.channel.send_frame(frame)
    except OSError as e:
        conn.forget(request_no)
        if not out.done():
            try:
                out.set_exception(e)
            except Exception:  # noqa: BLE001 -- lost race with close sweep
                pass
        return out
    # non-strict: a response arriving at exactly the deadline must win the
    # race, not crash the reactor thread
    timer = conn.reactor.call_later(
        timeout_s,
        lambda: out.try_set_exception(TimeoutError(f"no response from {remote}")),
    )

    def on_complete(_p: Promise, c=conn, rn=request_no, t=timer) -> None:
        t.cancel()
        c.forget(rn)

    out.add_callback(on_complete)
    return out


class _ChannelWriter:
    """Socket-shaped reply handle passed to ``on_frame`` callbacks: the
    write side of an accepted channel. ``sendall``/``send_frame`` only queue
    (the reactor flushes), so replies never block on a slow reader, and
    ``fileno()`` returns -1 once the peer is gone -- the contract the swarm
    gateway's writer lanes rely on."""

    __slots__ = ("_channel",)

    def __init__(self, channel: Channel) -> None:
        self._channel = channel

    def send_frame(self, frame: bytes) -> None:
        self._channel.send_frame(frame)

    def sendall(self, data: bytes) -> None:
        self._channel.send_buffers((data,))

    def fileno(self) -> int:
        return self._channel.fileno()

    def close(self) -> None:
        self._channel.close(None)


class FramedTcpServer:
    """Accept loop + connection lifecycle for length-prefixed framed servers.

    Owns the socket mechanics shared by every framed server (the node
    transport and the swarm gateway): a reactor ``Acceptor`` in place of the
    old accept thread, one multiplexed ``Channel`` per inbound connection in
    place of a thread per socket, and teardown that still delivers the FIN
    peers rely on to sense liveness. Inbound frames are handed to
    ``on_frame(writer, write_lock, frame)`` where ``writer`` is the
    connection's ``_ChannelWriter``; ``frame`` is ``bytes`` unless the
    server opts into ``frames_as_memoryview`` (valid only for the duration
    of the call). Constructed-but-never-started instances shut down as a
    safe no-op.
    """

    def __init__(
        self,
        listen_address: Endpoint,
        on_frame: Callable[[object, threading.Lock, bytes], None],
        name: str = "tcp-server",
        reactor: Optional[Reactor] = None,
        metrics: Optional[Metrics] = None,
        frames_as_memoryview: bool = False,
    ) -> None:
        self.address = listen_address
        self._on_frame = on_frame
        self._name = name
        self._reactor = reactor
        self._owns_reactor = False
        self._metrics = metrics
        self._frames_as_memoryview = frames_as_memoryview
        self._acceptor: Optional[Acceptor] = None
        self._accepted_lock = make_lock("FramedTcpServer._accepted_lock")
        # channel -> (writer, per-connection write lock)
        self._accepted: Dict[Channel, tuple] = {}  # guarded-by: _accepted_lock
        self._running = False

    def start(self) -> None:
        if self._reactor is None:
            self._reactor = Reactor(f"{self._name}-io-{self.address.port}")
            self._owns_reactor = True
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((self.address.hostname.decode(), self.address.port))
        sock.listen(128)
        self._running = True
        self._acceptor = Acceptor(self._reactor, sock, self._accept)

    def _accept(self, sock: socket.socket) -> None:
        channel = Channel(
            self._reactor, sock, self._chan_frame,
            on_close=self._chan_closed, metrics=self._metrics,
        )
        writer = _ChannelWriter(channel)
        write_lock = make_lock("FramedTcpServer.write_lock")
        with self._accepted_lock:
            if not self._running:
                accept_open = False  # lost the race with shutdown()
            else:
                accept_open = True
                self._accepted[channel] = (writer, write_lock)
        if not accept_open:
            channel.close(None)

    def _chan_frame(self, channel: Channel, frame: memoryview) -> None:
        with self._accepted_lock:
            entry = self._accepted.get(channel)
        if entry is None:
            return
        writer, write_lock = entry
        payload = frame if self._frames_as_memoryview else bytes(frame)
        self._on_frame(writer, write_lock, payload)

    def _chan_closed(self, channel: Channel, exc) -> None:
        with self._accepted_lock:
            self._accepted.pop(channel, None)

    def shutdown(self) -> None:
        self._running = False
        if self._acceptor is not None:
            self._acceptor.close()
            self._acceptor = None
        with self._accepted_lock:
            accepted = list(self._accepted)
            self._accepted.clear()
        for channel in accepted:
            channel.close(None)
        if self._owns_reactor and self._reactor is not None:
            self._reactor.stop()


class TcpClientServer(IMessagingClient, IMessagingServer):
    """Both halves of the transport in one object, like the reference's
    NettyClientServer -- server channels and client channels share one
    reactor (``self._io``), so the whole node does its socket I/O on a
    single thread."""

    def __init__(self, listen_address: Endpoint, settings: Optional[Settings] = None) -> None:
        self.address = listen_address
        self._settings = settings if settings is not None else Settings()
        self._service = None
        self._request_no = itertools.count()
        self._connections: Dict[Endpoint, _Connection] = {}
        self._conn_lock = make_lock("TcpClientServer._conn_lock")
        # per-peer dial backoff gate: remote -> {"until", "prev", "since"}
        # (monotonic ms); a peer inside its window fails fast instead of
        # issuing another connect syscall
        self._dial_gate: Dict[Endpoint, dict] = {}  # guarded-by: _conn_lock
        self._dial_rng = random.Random()
        self._dial_policy = RetryPolicy(
            base_delay_ms=self._settings.dial_backoff_base_ms,
            max_delay_ms=self._settings.dial_backoff_max_ms,
            jitter=self._settings.retry_jitter,
        )
        self.metrics = Metrics(
            parent=global_metrics(), plane="transport", node=str(listen_address)
        )
        # named _io as in the JAX package, whose native transport subclass
        # stores its C++ reactor as self._reactor
        self._io = Reactor(f"tcp-io-{listen_address.port}")
        self._framed = FramedTcpServer(
            listen_address, self._on_frame, "tcp-server",
            reactor=self._io, metrics=self.metrics, frames_as_memoryview=True,
        )

    # -- server side ---------------------------------------------------------

    def start(self) -> None:
        self._framed.start()

    def _on_frame(self, sock, write_lock: threading.Lock, frame) -> None:
        request_no, msg = decode(frame)
        self._dispatch(msg).add_callback(
            lambda p, rn=request_no: self._reply(sock, write_lock, rn, p)
        )

    def _reply(self, sock, write_lock: threading.Lock,
               request_no: int, promise: Promise) -> None:
        if promise.exception() is not None:
            return  # no response; the caller's deadline handles it
        response = promise._result  # noqa: SLF001
        if response is None:
            return
        try:
            # replies from concurrent protocol tasks share one channel; its
            # outbound queue keeps frames whole, so no write lock is needed
            _write_frame(sock, encode(request_no, response))
        except OSError:
            pass

    def _dispatch(self, msg: RapidMessage) -> Promise:
        service = self._service
        if service is None:
            if isinstance(msg, ProbeMessage):
                return Promise.completed(ProbeResponse(NodeStatus.BOOTSTRAPPING))
            return Promise()  # dropped until the service is wired
        try:
            return service.handle_message(msg)
        except Exception as e:  # noqa: BLE001
            return Promise.failed(e)

    def set_membership_service(self, service) -> None:
        self._service = service

    # -- client side ---------------------------------------------------------

    def _connection(self, remote: Endpoint) -> _Connection:
        now_ms = time.monotonic() * 1000.0
        with self._conn_lock:
            conn = self._connections.get(remote)
            if conn is not None and not conn.closed:
                return conn
            gate = self._dial_gate.get(remote)
            if gate is not None and now_ms < gate["until"]:
                # inside the backoff window: one pending/failed dial already
                # represents this peer; fail fast instead of re-dialing
                self.metrics.incr("msg.dial_backoffs")
                raise ConnectionError(
                    f"dial backoff for {remote} "
                    f"({gate['until'] - now_ms:.0f}ms remaining)"
                )
        # dial OUTSIDE the lock: even a nonblocking connect does DNS + a
        # syscall, and the cache lock is shared across all remotes -- one
        # dead peer must not stall every sender on the node
        try:
            fresh = _Connection(
                remote, self._settings.message_timeout_ms / 1000.0,
                reactor=self._io, metrics=self.metrics,
                on_dial_outcome=self._dial_outcome,
                on_closed=self._forget_connection,
            )
        except OSError:
            self._dial_outcome(remote, False)
            raise
        with self._conn_lock:
            conn = self._connections.get(remote)
            if conn is not None and not conn.closed:
                winner = conn  # lost a dial race; keep the established one
            else:
                winner = self._connections[remote] = fresh
        if winner is not fresh:
            fresh.close()
        return winner

    def _forget_connection(self, conn: _Connection) -> None:
        """Evict a closed connection from the cache. Without this, every
        departed peer leaves a closed _Connection in ``_connections``
        forever -- the cache (and the transport_digest walk over it) grows
        monotonically with peer churn. Identity-checked so a dial-race
        loser's close can never evict the winning connection."""
        with self._conn_lock:
            if self._connections.get(conn.remote) is conn:
                del self._connections[conn.remote]

    def _dial_outcome(self, remote: Endpoint, ok: bool) -> None:
        """Advance or clear the per-peer backoff gate. Failure delays follow
        the decorrelated-jitter policy from messaging/retries.py; the epoch
        resets once the peer has been gated past its dial deadline, so a
        long-dead peer keeps getting (rate-limited) fresh dials."""
        now_ms = time.monotonic() * 1000.0
        with self._conn_lock:
            if ok:
                self._dial_gate.pop(remote, None)
                return
            gate = self._dial_gate.get(remote)
            if gate is None or now_ms - gate["since"] >= self._settings.dial_deadline_ms:
                gate = {"since": now_ms, "prev": 0.0, "until": 0.0}
                self._dial_gate[remote] = gate
            delay = self._dial_policy.next_delay_ms(gate["prev"], self._dial_rng)
            gate["prev"] = delay
            gate["until"] = now_ms + delay

    def _send_once(self, remote: Endpoint, msg: RapidMessage,
                   timeout_ms: Optional[int] = None) -> Promise:
        try:
            conn = self._connection(remote)
        except OSError as e:
            return Promise.failed(e)
        request_no = next(self._request_no)
        timeout = (
            timeout_ms if timeout_ms is not None
            else self._settings.timeout_for(msg)
        )
        return send_framed(
            conn, request_no, encode(request_no, msg), timeout / 1000.0,
            remote,
        )

    def _retry_kwargs(self, deadline_ms: int) -> dict:
        """Backoff/deadline wiring for the hardened retry combinator: only a
        nonzero settings backoff pays for the shared wall-clock scheduler."""
        if self._settings.retry_base_delay_ms <= 0:
            return {}
        return {
            "scheduler": wall_scheduler(),
            "policy": self._settings.retry_policy(),
            "deadline_ms": deadline_ms,
        }

    def send_message(self, remote: Endpoint, msg: RapidMessage) -> Promise:
        return call_with_retries(
            lambda: self._send_once(remote, msg),
            self._settings.message_retries,
            **self._retry_kwargs(self._settings.deadline_for(msg)),
        )

    def send_message_with_timeout(
        self, remote: Endpoint, msg: RapidMessage, timeout_ms: int
    ) -> Promise:
        """send_message with an explicit per-attempt deadline, for callers
        whose message class deserves a different budget than the settings
        table (the gateway's decision-packet deliveries use the join-class
        deadline: the receiving member may be mid-bootstrap of a new view,
        busy rather than dead)."""
        return call_with_retries(
            lambda: self._send_once(remote, msg, timeout_ms),
            self._settings.message_retries,
            **self._retry_kwargs(
                timeout_ms * (self._settings.message_retries + 1)
            ),
        )

    def send_message_best_effort(self, remote: Endpoint, msg: RapidMessage) -> Promise:
        return self._send_once(remote, msg)

    # -- observability -------------------------------------------------------

    def transport_digest(self) -> Dict[str, float]:
        """Per-peer outbound queue depths (bytes waiting in each channel's
        coalescing buffer). A persistently deep queue is the backpressure
        signature of a slow-reading peer."""
        with self._conn_lock:
            connections = dict(self._connections)
        digest: Dict[str, float] = {}
        for remote, conn in sorted(connections.items(), key=lambda kv: str(kv[0])):
            if not conn.closed:
                digest[f"msg.queue_depth{{peer={remote}}}"] = float(
                    conn.pending_bytes()
                )
        return digest

    # -- lifecycle -----------------------------------------------------------

    def shutdown(self) -> None:
        self._framed.shutdown()
        self._shutdown_client_half()

    def _shutdown_client_half(self) -> None:
        """Close every cached outbound connection and stop the I/O reactor
        (shared with subclasses that replace the server half)."""
        with self._conn_lock:
            connections = list(self._connections.values())
            self._connections.clear()
        for conn in connections:
            conn.close()
        self._io.stop()
