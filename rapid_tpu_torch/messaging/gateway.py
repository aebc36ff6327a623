"""Socket gateway: a swarm on the card reachable by external OS processes.

The port's own copy of ``rapid_tpu/messaging/gateway.py``. The reference's
seam design means *any* transport can host a membership service
(IMessagingServer.java:24-41, GrpcServer.java:133-148). This module hosts
the port's ``TpuSimMessaging`` (``sim/bridge.py``) -- N virtual nodes whose
protocol state lives as tensors in the port's simulator, on a CUDA device
unless the caller names another -- behind a real TCP socket, so a real
agent process (the shape of the reference's standalone agent,
StandaloneAgent.java:94-116) joins, probes, broadcasts, votes, observes cuts,
and leaves against those peers over the wire. Over a socket the wire is the
interface, not the classes: an untouched ``rapid_tpu`` agent and the port's
own client (``GatewayRoutedClient`` here) both reach it, and the bridge
speaks the port's default protocol (``rapid_tpu_torch.types``).

Routing: one gateway socket fronts *thousands* of virtual endpoints, so the
wire frame must carry the destination (a plain rapid frame does not -- the
reference's server knows who it is by which socket it binds). The routed
frame prepends the destination endpoint to the standard codec envelope;
responses travel back correlated by request number exactly as in the plain
transport (NettyClientServer.java:267-277's pattern). Agent-side, a
``GatewayRoutedClient`` wraps the agent's normal transport: destinations
whose hostname is locally routable go direct (agent <-> agent traffic),
everything else -- the synthetic 10.x.y.z virtual addresses -- rides the
gateway connection. This is a transport-plugin concern, exactly what the
IMessagingClient seam exists for (IMessagingClient.java:25-48).

Threading model mirrors the reference: ALL swarm-side protocol logic
(bridge.handle + pump) is serialized on one protocol thread
(SharedResources.java:53's single protocolExecutor). The bridge's
clock-advance during the pre-decision vote exchange (pump phase B) is mapped
onto that thread's own task queue: ``run_for`` drains inbound requests for
the wait window, so real members' votes are tallied *during* the pause
rather than queuing behind it. That thread is the only one that touches the
device: it makes the swarm's device its current device before its first
task (torch's current device is per thread), and the socket reader's probe
fast path reads only the simulator's host liveness mirrors.
"""

from __future__ import annotations

import itertools
import logging
import queue
import socket
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Set, Tuple

import torch

from ..runtime.lockdep import make_lock
from ..runtime.futures import Promise
from ..runtime.scheduler import RealScheduler
from ..settings import Settings
from ..shard.engine import require_single_process
from ..sim.engine import resolve_device
from ..types import (
    Endpoint,
    JoinMessage,
    PreJoinMessage,
    ProbeMessage,
    ProbeResponse,
    RapidMessage,
)
from .base import IBroadcaster, IMessagingClient
from .codec import ENVELOPE, decode, encode
from .retries import call_with_retries
from .tcp import (
    FramedTcpServer,
    TcpClientServer,
    _Connection,
    _write_frame,
    send_framed,
)

LOG = logging.getLogger(__name__)

# routed envelope: request number, destination host length (host bytes and a
# u32 port follow), then the standard (tag, payload) body
ROUTED_HEADER = struct.Struct("!QH")
_PORT = struct.Struct("!I")


def encode_routed(request_no: int, dst: Endpoint, msg: RapidMessage) -> bytes:
    body = encode(request_no, msg)[ENVELOPE.size - 1 :]  # (tag, payload)
    return (
        ROUTED_HEADER.pack(request_no, len(dst.hostname))
        + dst.hostname
        + _PORT.pack(dst.port)
        + body
    )


def decode_routed(frame: bytes) -> Tuple[int, Endpoint, RapidMessage]:
    request_no, host_len = ROUTED_HEADER.unpack_from(frame)
    offset = ROUTED_HEADER.size
    host = frame[offset : offset + host_len]
    offset += host_len
    (port,) = _PORT.unpack_from(frame, offset)
    offset += _PORT.size
    # reconstitute a standard envelope for the shared decoder
    _, msg = decode(ENVELOPE.pack(request_no, frame[offset]) + frame[offset + 1 :])
    return request_no, Endpoint(host, port), msg


DEFAULT_DIRECT_HOSTS = (b"127.0.0.1", b"localhost")

# how long SwarmGateway.on_protocol_thread waits for the protocol thread to
# run a call, or to exit after shutdown, before it raises TimeoutError
PROTOCOL_CALL_TIMEOUT_S = 60.0


class GatewayRoutedClient(IMessagingClient):
    """Agent-side client: direct transport for routable peers, the gateway
    connection for everything else (the swarm's virtual endpoints)."""

    def __init__(
        self,
        address: Endpoint,
        gateway: Endpoint,
        direct: IMessagingClient,
        settings: Optional[Settings] = None,
        direct_hosts: Optional[Set[bytes]] = None,
    ) -> None:
        self.address = address
        self.gateway = gateway
        self._direct = direct
        self._settings = settings if settings is not None else Settings()
        self._direct_hosts = (
            set(direct_hosts)
            if direct_hosts is not None
            else set(DEFAULT_DIRECT_HOSTS)
        )
        self._direct_hosts.add(address.hostname)
        self._request_no = itertools.count(1)
        self._conn: Optional[_Connection] = None
        self._conn_lock = make_lock("GatewayRoutedClient._conn_lock")

    def _is_direct(self, remote: Endpoint) -> bool:
        return remote.hostname in self._direct_hosts

    def _connection(self) -> _Connection:
        with self._conn_lock:
            if self._conn is None or self._conn.closed:
                # deliberately dialing under the lock: there is exactly ONE
                # upstream (the gateway), so no unrelated sender is stalled,
                # and serializing the dial prevents a thundering herd of
                # duplicate gateway connections after a drop
                self._conn = _Connection(  # noqa: blocking-under-lock
                    self.gateway, self._settings.message_timeout_ms / 1000.0
                )
            return self._conn

    def _send_routed_once(self, remote: Endpoint, msg: RapidMessage) -> Promise:
        try:
            conn = self._connection()
        except OSError as e:
            return Promise.failed(e)
        request_no = next(self._request_no)
        return send_framed(
            conn, request_no, encode_routed(request_no, remote, msg),
            self._settings.timeout_for(msg) / 1000.0, remote,
        )

    def send_message(self, remote: Endpoint, msg: RapidMessage) -> Promise:
        if self._is_direct(remote):
            return self._direct.send_message(remote, msg)
        return call_with_retries(
            lambda: self._send_routed_once(remote, msg),
            self._settings.message_retries,
        )

    def send_message_best_effort(self, remote: Endpoint, msg: RapidMessage) -> Promise:
        if self._is_direct(remote):
            return self._direct.send_message_best_effort(remote, msg)
        return self._send_routed_once(remote, msg)

    def shutdown(self) -> None:
        self._direct.shutdown()
        with self._conn_lock:
            if self._conn is not None:
                self._conn.close()
                self._conn = None


# wildcard destination: one routed frame that the gateway ingests once on
# behalf of every virtual member (see GatewaySwarmBroadcaster)
SWARM_BROADCAST = Endpoint(b"*", 0)


class GatewaySwarmBroadcaster(IBroadcaster):
    """Broadcaster for members running behind a gateway.

    Unicast-to-all through a gateway is pathological at swarm scale: a
    broadcast to N members becomes N identical frames ground through ONE
    socket (at 10k virtual nodes a single vote broadcast takes tens of
    seconds and floods the gateway's protocol queue). But every
    swarm-bound copy is redundant -- the bridge ingests alert batches and
    votes once per sender and the device delivers them to every virtual
    member as array work -- so this broadcaster collapses them into ONE
    wildcard frame (``SWARM_BROADCAST``; TpuSimMessaging.handle_broadcast),
    while direct (real-member) recipients keep the reference's
    per-recipient best-effort unicast."""

    def __init__(self, routed: "GatewayRoutedClient") -> None:
        self._routed = routed
        self._direct_recipients: List[Endpoint] = []
        self._any_swarm = False

    def set_membership(self, recipients: List[Endpoint]) -> None:
        self._direct_recipients = [
            r for r in recipients if self._routed._is_direct(r)  # noqa: SLF001
        ]
        self._any_swarm = len(self._direct_recipients) < len(recipients)

    def broadcast(self, msg: RapidMessage) -> List[Promise]:
        promises = [
            self._routed.send_message_best_effort(r, msg)
            for r in self._direct_recipients
        ]
        if self._any_swarm:
            promises.append(
                self._routed._send_routed_once(SWARM_BROADCAST, msg)  # noqa: SLF001
            )
        return promises


class GatewayGossipBroadcaster(IBroadcaster):
    """Epidemic dissemination among the real members behind a gateway.

    Composition of the two broadcast optimizations: swarm-bound copies
    collapse into ONE wildcard frame exactly like GatewaySwarmBroadcaster
    (the device delivers them to every virtual member as array work), while
    the direct (real-member) plane uses GossipBroadcaster's relay instead of
    unicast-to-all -- at M real members that turns each broadcast's direct
    leg from M-1 sends into ~fanout, the dissemination alternative the
    reference names but never ships (IBroadcaster.java:24-26). The swarm is
    one "super-node" from the epidemic's viewpoint: it hears every broadcast
    exactly once and never relays."""

    def __init__(self, routed: "GatewayRoutedClient", gossip) -> None:
        self._routed = routed
        self._gossip = gossip
        self._any_swarm = False

    def set_membership(self, recipients: List[Endpoint]) -> None:
        direct = [
            r for r in recipients if self._routed._is_direct(r)  # noqa: SLF001
        ]
        self._any_swarm = len(direct) < len(recipients)
        self._gossip.set_membership(direct)

    def broadcast(self, msg: RapidMessage) -> List[Promise]:
        promises = self._gossip.broadcast(msg)
        if self._any_swarm:
            promises.append(
                self._routed._send_routed_once(SWARM_BROADCAST, msg)  # noqa: SLF001
            )
        return promises

    def receive(self, env) -> Optional[RapidMessage]:
        """Relay-plane entry (the membership service forwards inbound
        GossipEnvelopes here, like for a plain GossipBroadcaster)."""
        return self._gossip.receive(env)


class _GatewayScheduler(RealScheduler):
    """RealScheduler plus ``run_for``: the bridge's clock advance drains the
    gateway's protocol queue for the window, so inbound votes are processed
    *during* the pre-decision pause (TpuSimMessaging._advance_clock)."""

    def __init__(self, drain: Callable[[float], None]) -> None:
        super().__init__()
        self._drain = drain

    def run_for(self, ms: int) -> None:
        self._drain(ms / 1000.0)


class _LivenessState:
    __slots__ = ("alive", "misses", "last_query")

    def __init__(self, alive: bool, now: float) -> None:
        self.alive = alive
        self.misses = 0
        self.last_query = now


class _GatewayNetwork:
    """The bridge-facing network adapter: liveness by dialing, delivery over
    the gateway's outbound client (InProcessNetwork's contract, on sockets).

    Liveness dials run on a background monitor, NOT the protocol thread: the
    bridge senses every real member each pump, and a loaded box misses dials
    (0.25 s timeout each) -- 50 members' worth of synchronous dials blocked
    the protocol thread for seconds per pump, starving joiners' phase-1
    requests past their retry budget (a 50-joiner wave starved that way).
    ``is_listening`` now answers from the monitor's cache in O(1);
    only the FIRST query for an unknown endpoint dials synchronously (the
    join-admission path, where the agent was just talking to us)."""

    PROBE_TIMEOUT_S = 0.25
    # background refresh cadence; death detection latency is one period plus
    # the timeout-tolerance window below
    REFRESH_S = 0.5
    # watched endpoints not asked about for this long are dropped (removed
    # members stop being queried by the bridge, so the watch set self-cleans)
    WATCH_TTL_S = 30.0
    # parallel dial lanes for the refresher (dials are I/O-bound waits)
    DIAL_WORKERS = 8

    # ambiguous dial failures (timeouts under load) tolerated before a
    # member is reported gone; a refused connection is definitive death
    DIAL_TIMEOUTS_TO_FAIL = 3

    def __init__(self, out_client: TcpClientServer, scheduler: RealScheduler) -> None:
        self.scheduler = scheduler
        self._out = out_client
        self._handlers: List[object] = []
        self._watch: Dict[Endpoint, _LivenessState] = {}
        self._watch_lock = make_lock("_GatewayNetwork._watch_lock")
        self._inflight = 0  # guarded-by: _inflight_lock
        self._inflight_lock = make_lock("_GatewayNetwork._inflight_lock")
        self._stop = threading.Event()
        self._monitor = threading.Thread(  # noqa: messaging-thread
            target=self._monitor_loop, name="gateway-liveness", daemon=True
        )
        self._dialers = ThreadPoolExecutor(
            max_workers=self.DIAL_WORKERS, thread_name_prefix="gateway-dial"
        )
        # delivery workers: sends (whose connect can block for the full
        # message timeout on an unreachable member) run OFF the protocol
        # thread, so probes/joins from healthy agents are never queued behind
        # a dead member's dials. Per-destination frame order is preserved by
        # hashing the destination to a fixed single-thread lane; multiple
        # lanes keep one slow member from backing up deliveries to the rest
        self._delivery = [
            ThreadPoolExecutor(
                max_workers=1, thread_name_prefix=f"gateway-delivery-{i}"
            )
            for i in range(4)
        ]
        # started last: the monitor loop dereferences _dialers (and a first
        # refresh can race construction), so every executor must be assigned
        # before the thread runs
        self._monitor.start()

    def attach_handler(self, handler) -> None:
        self._handlers.append(handler)

    def _dial(self, address: Endpoint) -> Optional[bool]:
        """One dial: True = listening, False = definitively gone (refused),
        None = ambiguous (timeout/transient on a loaded host)."""
        try:
            probe = socket.create_connection(
                (address.hostname.decode(), address.port),
                timeout=self.PROBE_TIMEOUT_S,
            )
            probe.close()
            return True
        except ConnectionRefusedError:
            return False
        except OSError:
            return None

    def _refresh_one(self, address: Endpoint, state: _LivenessState) -> None:
        outcome = self._dial(address)
        if outcome is True:
            state.alive = True
            state.misses = 0
        elif outcome is False:
            # the port actively refused: the process is gone -- definitive
            state.alive = False
            state.misses = 0
        else:
            # timeout or transient error: a loaded host can miss a dial
            # without being dead, and declaring a live member gone starts a
            # cut/rejoin cascade -- tolerate consecutive ambiguous misses
            state.misses += 1
            if state.misses >= self.DIAL_TIMEOUTS_TO_FAIL:
                # declared gone; reset the budget so a rejoin at this
                # address gets the full tolerance again
                state.alive = False
                state.misses = 0

    def _monitor_loop(self) -> None:
        while not self._stop.wait(self.REFRESH_S):
            now = time.monotonic()
            with self._watch_lock:
                expired = [
                    ep
                    for ep, st in self._watch.items()
                    if now - st.last_query > self.WATCH_TTL_S
                ]
                for ep in expired:
                    del self._watch[ep]
                snapshot = list(self._watch.items())
            if not snapshot:
                continue
            try:
                list(
                    self._dialers.map(
                        lambda item: self._refresh_one(*item), snapshot
                    )
                )
            except RuntimeError:  # pool shut down mid-refresh
                return

    def is_listening(self, address: Endpoint) -> bool:
        now = time.monotonic()
        conn = self._out._connections.get(address)  # noqa: SLF001
        if conn is not None and not conn.closed:
            # keep (or seed) the watch entry while the live connection
            # answers for us: when the member later dies and the cached
            # connection drops, the monitor must already be watching, or
            # the next pump pays a synchronous dial per dead member
            with self._watch_lock:
                state = self._watch.get(address)
                if state is None:
                    self._watch[address] = _LivenessState(True, now)
                else:
                    state.alive = True
                    state.misses = 0
                    state.last_query = now
            return True
        with self._watch_lock:
            state = self._watch.get(address)
            if state is not None:
                state.last_query = now
                return state.alive
        # first contact (join admission, or a rejoin after the watch entry
        # expired): one synchronous dial seeds the watch entry. An ambiguous
        # first dial counts as alive -- the monitor's tolerance window takes
        # over from here
        outcome = self._dial(address)
        alive = outcome is not False
        with self._watch_lock:
            self._watch.setdefault(address, _LivenessState(alive, now))
        return alive

    def deliver(
        self, src: Endpoint, dst: Endpoint, msg: RapidMessage, timeout_ms: int
    ) -> Promise:
        # src rides inside the message payload, as on every rapid transport.
        # Retried (send_message, not best-effort): decision packets are the
        # member's only way to learn a view change, and a transient socket
        # failure must not strand it on the old configuration
        out: Promise = Promise()

        def send() -> None:
            try:
                self._out.send_message_with_timeout(
                    dst, msg, timeout_ms
                ).add_callback(
                    lambda p: out.done()
                    or (
                        out.set_exception(p.exception())
                        if p.exception() is not None
                        else out.try_set_result(p._result)  # noqa: SLF001
                    )
                )
            except Exception as e:  # noqa: BLE001
                if not out.done():
                    out.set_exception(e)

        with self._inflight_lock:
            self._inflight += 1
        out.add_callback(self._delivered)
        lane = hash(dst) % len(self._delivery)
        try:
            self._delivery[lane].submit(send)
        except RuntimeError as e:  # pool shut down: gateway teardown race
            out.set_exception(e)
        return out

    def _delivered(self, _promise: Promise) -> None:
        with self._inflight_lock:
            self._inflight -= 1

    def in_flight(self) -> int:
        """Deliveries sent and not yet answered (or failed)."""
        with self._inflight_lock:
            return self._inflight

    def shutdown(self) -> None:
        self._stop.set()
        self._dialers.shutdown(wait=False)
        for pool in self._delivery:
            pool.shutdown(wait=False)


class SwarmGateway:
    """Hosts a TpuSimMessaging swarm behind one real TCP socket.

    start() binds the socket and the pump loop; external processes join the
    swarm through ``seed_endpoint()`` using a GatewayRoutedClient. All bridge
    access is serialized on the protocol thread; responses complete
    asynchronously when the simulated view change commits (parked joins),
    mirroring MembershipService.java:229-286 over a real wire.
    """

    def __init__(
        self,
        listen_address: Endpoint,
        n_virtual: int = 0,
        capacity: Optional[int] = None,
        config=None,
        seed: int = 0,
        settings: Optional[Settings] = None,
        pump_interval_ms: int = 100,
        pump_max_rounds: int = 32,
        restore_from: Optional[str] = None,
        restore_config_overrides: Optional[dict] = None,
        mesh=None,
        native_server: bool = False,
        device=None,
    ) -> None:
        """JAX's parameters in JAX's order, then ``device``.

        ``mesh``: a ``shard.engine.Mesh`` to shard the swarm over (its own
        devices; ``device`` is then unused). ``device``: where the swarm
        runs, as for ``Simulator``: CUDA unless the caller names another,
        and an error without a card, never a silent CPU run.
        ``native_server``: accept/read routed frames on the C++ epoll
        reactor (``runtime/native_io.py`` over ``csrc/host/rapid_io.cpp``)
        instead of the Python server; the wire format and everything above
        it (routing, parking, the pump) is identical. ``start`` raises when
        the reactor's library does not build or load."""
        from ..sim.bridge import TpuSimMessaging

        require_single_process(mesh, "the gateway")
        if mesh is None:
            device = resolve_device(device)
            if device.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(
                    f"no CUDA device is available for device={str(device)!r}; "
                    "pass device='cpu' to run the swarm on the CPU"
                )
            if device.type == "cuda" and device.index is None:
                # named explicitly: the protocol thread adopts it as its own
                # current device, whatever this thread's is
                device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.address = listen_address
        self._settings = settings if settings is not None else Settings()
        self._out = TcpClientServer(listen_address, self._settings)
        # join-class prioritization (the reference gives joins a 5x RPC
        # deadline for the same reason, GrpcClient.java:55-59): a joiner's
        # phase-1 request is answered ahead of queued broadcast traffic and
        # ahead of a pending pump (whose device dispatches are the longest
        # tasks on this thread), so a join wave cannot starve later joiners
        # past their retry budget. Within a class, FIFO via the sequence
        self._tasks: "queue.PriorityQueue[Tuple[int, int, Optional[Callable[[], None]]]]" = (
            queue.PriorityQueue()
        )
        self._task_seq = itertools.count()
        self._scheduler = _GatewayScheduler(self._drain_for)
        self.network = _GatewayNetwork(self._out, self._scheduler)
        if restore_from is not None:
            if n_virtual or capacity is not None or config is not None or seed:
                raise ValueError(
                    "restore_from takes identity/config from the snapshot; "
                    "re-apply non-persisted SimConfig fields via "
                    "restore_config_overrides, not n_virtual/capacity/"
                    "config/seed"
                )
            self.bridge = TpuSimMessaging.restore(
                self.network, restore_from,
                config_overrides=restore_config_overrides,
                mesh=mesh,
                device=device,
            )
        else:
            if n_virtual <= 0:
                raise ValueError("pass n_virtual > 0, or restore_from a snapshot")
            self.bridge = TpuSimMessaging(
                self.network,
                n_virtual=n_virtual,
                capacity=capacity,
                config=config,
                seed=seed,
                mesh=mesh,
                device=device,
            )
        self._pump_interval_s = pump_interval_ms / 1000.0
        self._pump_max_rounds = pump_max_rounds
        self._native_server = native_server
        self._reactor = None
        self._framed = (
            None
            if native_server
            else FramedTcpServer(listen_address, self._on_frame, "gateway")
        )
        self._threads: List[threading.Thread] = []
        self._task_stats: Dict[str, list] = {}
        # reply-writer lanes: see _on_frame (keyed by connection so one
        # agent's backpressure cannot block replies to the rest)
        self._writers = [
            ThreadPoolExecutor(max_workers=1,
                               thread_name_prefix=f"gateway-writer-{i}")
            for i in range(2)
        ]
        self._running = False
        self._protocol_thread: Optional[threading.Thread] = None
        self._decisions: List[object] = []
        self._decision_lock = make_lock("SwarmGateway._decision_lock")
        self._warned_lock = make_lock("SwarmGateway._warned_lock")
        self._warned_unowned: set = set()  # guarded-by: _warned_lock

    # task classes for the protocol thread's priority queue. The pump
    # shares the frame class on purpose: at a strictly lower priority a
    # sustained stream of broadcast frames could starve it forever, and the
    # pump is the only producer of decisions, parked-join completion, and
    # liveness sensing -- FIFO within the class bounds its wait by the
    # backlog present when it was enqueued. Join-class frames still jump
    # the whole queue (the reference's 5x join deadline rationale).
    PRIO_JOIN = 0   # PreJoin / Join: small, latency-sensitive
    PRIO_FRAME = 1  # other inbound frames, save/warm, the pump
    PRIO_PUMP = 1
    _PRIO_SENTINEL = 3

    def _put_task(self, fn: Optional[Callable[[], None]], prio: int,
                  label: str = "task") -> None:
        item = None if fn is None else (fn, label)
        self._tasks.put((prio, next(self._task_seq), item))

    def _run_task(self, fn: Callable[[], None], label: str) -> None:
        """Execute one protocol task with per-class wall-time accounting.
        The gateway's single protocol thread is its scarcest resource
        (SharedResources.java:53's model); when something starves, the
        stats say WHICH task class ate the thread instead of leaving it to
        archaeology."""
        start = time.monotonic()
        try:
            fn()
        except Exception:  # noqa: BLE001 -- the loop must survive
            LOG.exception("gateway protocol task failed (%s)", label)
        finally:
            elapsed = time.monotonic() - start
            stats = self._task_stats.setdefault(label, [0, 0.0, 0.0])
            stats[0] += 1
            stats[1] += elapsed
            stats[2] = max(stats[2], elapsed)
            if elapsed > 1.0:
                LOG.warning(
                    "slow protocol task %s: %.2fs (joiners' phase-1 "
                    "deadline is %dms)", label, elapsed,
                    self._settings.join_message_timeout_ms,
                )

    def task_stats(self) -> Dict[str, Tuple[int, float, float]]:
        """{label: (count, total_s, max_s)} for the protocol thread."""
        return {k: tuple(v) for k, v in self._task_stats.items()}

    # ------------------------------------------------------------------ #
    # public surface
    # ------------------------------------------------------------------ #

    def seed_endpoint(self, slot: int = 0) -> Endpoint:
        return self.bridge.endpoint(slot)

    def decisions(self) -> List[object]:
        with self._decision_lock:
            return list(self._decisions)

    def configuration_id(self) -> int:
        """The swarm's configuration id, read on the protocol thread: from
        any other thread a read could fold the id in the middle of a view
        change and cache it over the installed one."""
        return self.on_protocol_thread(lambda: self.bridge.sim.configuration_id())

    def membership_size(self) -> int:
        """The swarm's size, read on the protocol thread (as above)."""
        return self.on_protocol_thread(lambda: self.bridge.sim.membership_size)

    def on_protocol_thread(self, fn: Callable[[], object]):
        """``fn()`` on the protocol thread, the one thread that touches the
        swarm, at join priority, and its result (or its exception, raised
        here): how a caller reads the swarm or injects a virtual fault. It
        runs in place on that thread itself, and on the caller's thread only
        when no protocol thread can run a task: before ``start``, or after
        ``shutdown`` once that thread has left its last task and exited. It
        runs once either way."""
        thread = self._protocol_thread
        if thread is threading.current_thread():
            return fn()
        if thread is None:
            return fn()  # not started: no other thread touches the swarm
        done = threading.Event()
        claim = threading.Lock()  # whoever takes it runs fn()
        out: list = []

        def run() -> None:
            try:
                out.append((True, fn()))
            except Exception as e:  # noqa: BLE001 -- raised on the caller's thread
                out.append((False, e))
            finally:
                done.set()

        def task() -> None:
            if claim.acquire(blocking=False):
                run()

        deadline = time.monotonic() + PROTOCOL_CALL_TIMEOUT_S
        if self._running:
            self._put_task(task, self.PRIO_JOIN, "caller")
            while self._running and not done.wait(0.05):
                if time.monotonic() > deadline:
                    raise TimeoutError("the gateway's protocol thread did not run the call")
        if not done.is_set():
            # shut down: a task the protocol thread holds (or one that drains
            # the queue, and may still run this call) ends before fn() runs here
            thread.join(max(0.0, deadline - time.monotonic()))
            if thread.is_alive():
                raise TimeoutError("the gateway's protocol thread did not exit")
            if claim.acquire(blocking=False):
                run()
        done.wait()
        ok, value = out[0]
        if not ok:
            raise value
        return value

    def save(self, path: str, timeout: float = 30.0) -> None:
        """Checkpoint the swarm (configuration + real-member plane) from the
        protocol thread, so the snapshot is consistent with in-flight
        handling. A new gateway started with ``restore_from=path`` resumes
        the same configuration id; live agents reconnect transparently."""
        done = threading.Event()
        error: list = []

        def task() -> None:
            try:
                self.bridge.save(path)
            except Exception as e:  # noqa: BLE001
                error.append(e)
            finally:
                done.set()

        self._put_task(task, self.PRIO_FRAME, "save")
        if not done.wait(timeout):
            raise TimeoutError("gateway snapshot did not complete")
        if error:
            raise error[0]

    def warm(self, timeout: float = 600.0) -> None:
        """Warm the swarm engine on the protocol thread (the bridge's
        ``warm_compile``: the kernels' first build and load, the first
        decision of each branch). Call between start() and advertising the
        seed: the first-time work can exceed a joining agent's retry
        budget, so agents should find a warmed swarm."""
        done = threading.Event()
        error: list = []

        def task() -> None:
            try:
                # probe variants, the decision path, and the classic
                # fallback -- everything the pump can hit once agents exist
                # (first-time work mid-join-wave starves every joiner past
                # its phase-1 retry budget)
                self.bridge.warm_compile()
            except Exception as e:  # noqa: BLE001
                error.append(e)
            finally:
                done.set()

        self._put_task(task, self.PRIO_FRAME, "warm")
        if not done.wait(timeout):
            raise TimeoutError("gateway warm-up did not complete")
        if error:
            raise error[0]

    def start(self) -> None:
        self._running = True
        threads = [
            (self._protocol_loop, "gateway-protocol"),
            (self._pump_loop, "gateway-pump"),
        ]
        if self._native_server:
            from ..runtime.native_io import NativeReactor

            self._reactor = NativeReactor(
                self.address.hostname.decode(), self.address.port
            )
            threads.append((self._native_dispatch_loop, "gateway-reactor"))
        else:
            self._framed.start()
        for target, name in threads:
            t = threading.Thread(target=target, name=name, daemon=True)  # noqa: messaging-thread
            if target == self._protocol_loop:
                self._protocol_thread = t
            t.start()
            self._threads.append(t)

    def _native_dispatch_loop(self) -> None:
        from ..runtime.native_io import EV_FRAME, EV_SHUTDOWN

        reactor = self._reactor
        while self._running:
            ev, conn_id, payload = reactor.poll(timeout_ms=500)
            if ev == EV_SHUTDOWN:
                return
            if ev == EV_FRAME:
                self._on_native_frame(conn_id, payload)  # decode guarded inside

    def shutdown(self) -> None:
        self._running = False
        if self._reactor is not None:
            self._reactor.shutdown()
        if self._framed is not None:
            self._framed.shutdown()
        self._put_task(None, self._PRIO_SENTINEL)
        self.network.shutdown()
        for pool in self._writers:
            pool.shutdown(wait=False)
        self._out.shutdown()
        self._scheduler.shutdown()

    # ------------------------------------------------------------------ #
    # protocol serialization
    # ------------------------------------------------------------------ #

    def _protocol_loop(self) -> None:
        device = self.device
        if device is not None and device.type == "cuda":
            torch.cuda.set_device(device)
        while self._running:
            _, _, item = self._tasks.get()
            if item is None:
                return
            self._run_task(*item)

    def _drain_for(self, seconds: float) -> None:
        """Process queued tasks for a wall-clock window (bridge clock advance;
        runs ON the protocol thread, so serialization is preserved).

        The window opens once the deliveries in flight -- the announcement
        the bridge has just sent -- are answered, or at the message deadline
        (tasks are processed meanwhile). In the JAX package's gateway the
        window opens at once, so the wire's own time counts against the
        members' ``seconds``: at 100k members the port's pure-Python codec
        spends more than the bridge's 100 ms on a 1000-alert announcement
        and its vote alone (PERF.md, the gateway phase), and a real
        member's vote would miss the tally it was asked for."""
        opens = time.monotonic() + self._settings.message_timeout_ms / 1000.0
        if self._drain_until(opens, lambda: not self.network.in_flight()):
            self._drain_until(time.monotonic() + seconds)

    def _drain_until(self, deadline: float, done: Optional[Callable[[], bool]] = None) -> bool:
        """Run queued tasks until ``deadline`` or ``done()``; False when the
        shutdown sentinel came up (re-posted for the loop)."""
        while done is None or not done():
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return True
            try:
                # poll ``done`` every 5 ms while it is given
                _, _, item = self._tasks.get(
                    timeout=remaining if done is None else min(remaining, 0.005))
            except queue.Empty:
                if done is None:
                    return True
                continue
            if item is None:
                # re-post the shutdown sentinel
                self._put_task(None, self._PRIO_SENTINEL)
                return False
            self._run_task(*item)
        return True

    def _pump_loop(self) -> None:
        pending = threading.Event()

        def pump() -> None:
            try:
                rec = self.bridge.pump(max_rounds=self._pump_max_rounds)
                if rec is not None:
                    with self._decision_lock:
                        self._decisions.append(rec)
            finally:
                pending.clear()

        while self._running:
            time.sleep(self._pump_interval_s)
            if not self._running:
                return
            if not pending.is_set():
                pending.set()
                self._put_task(pump, self.PRIO_PUMP, "pump")

    # ------------------------------------------------------------------ #
    # inbound routed connections
    # ------------------------------------------------------------------ #

    def _on_frame(self, sock: socket.socket, write_lock: threading.Lock,
                  frame: bytes) -> None:
        # reply writes are offloaded to writer lanes keyed by connection: a
        # slow-reading agent fills its socket buffer, and a synchronous
        # write would block whichever thread replies (the protocol thread,
        # for parked join responses) on that one agent's backpressure
        def reply_send(data: bytes) -> None:
            def write() -> None:
                try:
                    with write_lock:
                        _write_frame(sock, data)
                except OSError:
                    pass

            fd = sock.fileno()
            if fd < 0:
                return  # socket already closed; nothing to reply to
            self._writers[fd % len(self._writers)].submit(write)

        self._enqueue_routed(reply_send, frame)

    def _on_native_frame(self, conn_id: int, frame: bytes) -> None:
        reactor = self._reactor

        def reply_send(data: bytes) -> None:
            if reactor is not None:
                reactor.send(conn_id, data)

        self._enqueue_routed(reply_send, frame)

    def _enqueue_routed(self, reply_send, frame: bytes) -> None:
        try:
            request_no, dst, msg = decode_routed(frame)
        except Exception:  # noqa: BLE001 -- a bad frame must not kill either
            LOG.warning("undecodable routed frame dropped")  # front door
            return
        if isinstance(msg, ProbeMessage) and dst != SWARM_BROADCAST:
            # Probe fast path ON THE READER THREAD, never the protocol
            # queue: at swarm scale the FD probe volume is the dominant
            # frame class (every real member probes K virtual subjects per
            # FD interval), and grinding it through the protocol thread
            # starves joins behind it. The reference answers probes outside
            # the protocol path too (GrpcServer.java:83-96 replies before
            # the service is even wired). The racy reads (slot map, sim
            # liveness arrays) are safe: CPython dict/numpy-scalar reads
            # are atomic, and a probe seeing a one-pump-stale liveness bit
            # is indistinguishable from probe-in-flight timing. Both arrays
            # are the simulator's host numpy mirrors: no device read, so no
            # sync, happens on this thread.
            self._answer_probe(reply_send, request_no, dst)
            return
        prio = (
            self.PRIO_JOIN
            if isinstance(msg, (PreJoinMessage, JoinMessage))
            else self.PRIO_FRAME
        )
        self._put_task(
            lambda rs=reply_send, rn=request_no, d=dst, m=msg: self._handle_one(
                rs, rn, d, m
            ),
            prio,
            f"frame:{type(msg).__name__}",
        )

    def _warn_unowned_once(self, dst: Endpoint) -> bool:
        """True exactly once per unowned endpoint. The probe fast path warns
        from the reader thread while routed frames warn from the protocol
        thread, so the warn-once set needs its own guard."""
        with self._warned_lock:
            if dst in self._warned_unowned:
                return False
            self._warned_unowned.add(dst)
            return True

    def _answer_probe(self, reply_send, request_no: int, dst: Endpoint) -> None:
        slot = self.bridge._slot_of.get(dst)  # noqa: SLF001
        if slot is None or dst in self.bridge._real:  # noqa: SLF001
            # not a virtual endpoint; the sender's deadline handles it --
            # but keep the warn-once misroute diagnostic (probes are the
            # dominant peer traffic; silently eating them would turn a
            # missing --direct-host into an undiagnosed cut cascade)
            if self._warn_unowned_once(dst):
                LOG.warning(
                    "routed probe for non-virtual endpoint %s dropped; if "
                    "this is a real agent's address, its peers need it in "
                    "their direct-host set",
                    dst,
                )
            return
        sim = self.bridge.sim
        if bool(sim.active[slot]) and bool(sim.alive[slot]):
            reply_send(encode(request_no, ProbeResponse()))
        # a dead virtual node sends no response, like a dead process

    def _handle_one(
        self,
        reply_send,  # Callable[[bytes], None]: framed write to the requester
        request_no: int,
        dst: Endpoint,
        msg: RapidMessage,
    ) -> None:
        if dst == SWARM_BROADCAST:
            # one frame standing for a broadcast to every virtual member
            # (GatewaySwarmBroadcaster); ingested exactly once
            try:
                promise = self.bridge.handle_broadcast(msg)
            except Exception:  # noqa: BLE001
                LOG.exception("handle_broadcast failed")
                return
            self._attach_reply(reply_send, request_no, promise)
            return
        if not self.bridge.owns(dst):
            # a real member's address, or an unknown endpoint: there is no
            # virtual node here; the sender's deadline handles it. Warn once
            # per endpoint -- a steady stream of these means an agent is
            # misrouting peer traffic here (missing --direct-host)
            if self._warn_unowned_once(dst):
                LOG.warning(
                    "routed frame for non-virtual endpoint %s dropped; if this "
                    "is a real agent's address, its peers need it in their "
                    "direct-host set",
                    dst,
                )
            return
        try:
            promise = self.bridge.handle(dst, msg)
        except Exception:  # noqa: BLE001
            LOG.exception("bridge.handle failed for %s", dst)
            return
        self._attach_reply(reply_send, request_no, promise)

    @staticmethod
    def _attach_reply(reply_send, request_no: int, promise: Promise) -> None:
        def reply(p: Promise) -> None:
            if p.exception() is not None:
                return  # no response; the sender's deadline expires
            response = p._result  # noqa: SLF001
            if response is None:
                return
            reply_send(encode(request_no, response))

        promise.add_callback(reply)
