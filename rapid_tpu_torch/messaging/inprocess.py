"""In-process transport: full protocol, zero sockets.

The port's own copy of ``rapid_tpu/messaging/inprocess.py``.

Reference trick: the gRPC in-process channel keyed by endpoint string
(GrpcClient.java:165-171, GrpcServer.java:133-138) lets 50-100 node clusters
run the complete protocol in one JVM. Here an InProcessNetwork is the registry;
delivery hops through the scheduler (so messages are asynchronous and ordered
by virtual/real time), and per-link fault hooks (drop/delay/partition) are
first-class -- they subsume the reference's test interceptors
(ServerDropInterceptors/ClientInterceptors, MessageDropInterceptor.java).
"""

from __future__ import annotations

import logging
import random
import zlib
from typing import Callable, Dict, List, Optional

from ..runtime.futures import Promise
from ..runtime.scheduler import Scheduler
from ..settings import Settings
from ..types import Endpoint, NodeStatus, ProbeMessage, ProbeResponse, RapidMessage
from .base import IMessagingClient, IMessagingServer
from .retries import call_with_retries

LOG = logging.getLogger(__name__)

# (src, dst, msg) -> keep delivering? Returning False drops the message.
LinkFilter = Callable[[Endpoint, Endpoint, RapidMessage], bool]
# (src, dst, msg) -> extra one-way delay in ms (0 = none)
LinkDelay = Callable[[Endpoint, Endpoint, RapidMessage], int]


class InProcessNetwork:
    """Shared registry + fault-injection plane for one in-process cluster."""

    def __init__(self, scheduler: Scheduler) -> None:
        self.scheduler = scheduler
        self._servers: Dict[Endpoint, "InProcessServer"] = {}
        self._filters: List[LinkFilter] = []
        self._delays: List[LinkDelay] = []
        # fallback handlers for endpoints not backed by a per-node server --
        # e.g. a TpuSimMessaging swarm hosting thousands of virtual nodes
        # behind one handler (owns(ep) -> bool, handle(dst, msg) -> Promise)
        self._handlers: List[object] = []

    # -- fault injection -----------------------------------------------------

    def add_filter(self, f: LinkFilter) -> Callable[[], None]:
        self._filters.append(f)
        return lambda: self._filters.remove(f)

    def add_delay(self, d: LinkDelay) -> Callable[[], None]:
        self._delays.append(d)
        return lambda: self._delays.remove(d)

    def partition_one_way(self, src: Endpoint, dst: Endpoint) -> Callable[[], None]:
        """Drop all src->dst traffic (models iptables INPUT one-way loss)."""
        return self.add_filter(lambda s, d, m: not (s == src and d == dst))

    # -- registry ------------------------------------------------------------

    def register(self, server: "InProcessServer") -> None:
        self._servers[server.address] = server

    def unregister(self, server: "InProcessServer") -> None:
        if self._servers.get(server.address) is server:
            del self._servers[server.address]

    def attach_handler(self, handler) -> None:
        """Attach a multi-endpoint fallback handler (e.g. a simulation swarm)."""
        self._handlers.append(handler)

    def is_listening(self, address: Endpoint) -> bool:
        """Is a per-node server currently registered at this address?"""
        return address in self._servers

    # -- delivery ------------------------------------------------------------

    def deliver(self, src: Endpoint, dst: Endpoint, msg: RapidMessage,
                timeout_ms: int) -> Promise:
        """One attempt: apply fault plane, hop through the scheduler, dispatch
        at the destination server, enforce the deadline."""
        out: Promise = Promise()
        for f in self._filters:
            if not f(src, dst, msg):
                # dropped on the wire: the sender just sees its deadline expire
                self.scheduler.schedule(timeout_ms, lambda: _timeout(out, dst, msg))
                return out
        delay = sum(d(src, dst, msg) for d in self._delays)

        def attempt() -> None:
            server = self._servers.get(dst)
            if server is None:
                for handler in self._handlers:
                    if handler.owns(dst):
                        server = handler
                        break
            if server is None:
                _fail(out, ConnectionError(f"no server listening at {dst}"))
                return
            try:
                if server in self._handlers:
                    promise = server.handle(dst, msg)
                else:
                    promise = server.handle(msg)
                promise.add_callback(lambda p: _copy(p, out))
            except Exception as e:  # noqa: BLE001
                _fail(out, e)

        self.scheduler.schedule(delay, attempt)
        self.scheduler.schedule(timeout_ms + delay, lambda: _timeout(out, dst, msg))
        return out


def _copy(src: Promise, dst: Promise) -> None:
    if dst.done():
        return
    exc = src.exception()
    if exc is not None:
        _fail(dst, exc)
    else:
        dst.try_set_result(src._result)  # noqa: SLF001 -- promise-internal copy


def _fail(p: Promise, exc: BaseException) -> None:
    if not p.done():
        try:
            p.set_exception(exc)
        except Exception:  # noqa: BLE001 -- lost race with completion
            pass


def _timeout(p: Promise, dst: Endpoint, msg: RapidMessage) -> None:
    _fail(p, TimeoutError(f"no response from {dst} for {type(msg).__name__}"))


class InProcessServer(IMessagingServer):
    """Dispatches incoming messages to the node's MembershipService.

    Until set_membership_service is called, probes are answered BOOTSTRAPPING
    and everything else is silently dropped (GrpcServer.java:77-96) -- the
    joining node's server is started before the join completes.
    """

    def __init__(self, address: Endpoint, network: InProcessNetwork) -> None:
        self.address = address
        self._network = network
        self._service = None
        self._started = False
        # test seam: functions (msg) -> bool; False drops the message at the
        # server (ServerDropInterceptors.FirstN, MessageDropInterceptor.java)
        self.interceptors: List[Callable[[RapidMessage], bool]] = []

    def start(self) -> None:
        self._network.register(self)
        self._started = True

    def shutdown(self) -> None:
        self._network.unregister(self)
        self._started = False

    def set_membership_service(self, service) -> None:
        self._service = service

    def handle(self, msg: RapidMessage) -> Promise:
        for interceptor in self.interceptors:
            if not interceptor(msg):
                return Promise()  # never completes -> sender times out
        if self._service is None:
            if isinstance(msg, ProbeMessage):
                return Promise.completed(ProbeResponse(NodeStatus.BOOTSTRAPPING))
            return Promise()  # dropped (GrpcServer.java:77-82)
        return self._service.handle_message(msg)


class InProcessClient(IMessagingClient):
    """Client side: per-message-type deadlines + async retries
    (GrpcClient.java:102-131)."""

    def __init__(self, address: Endpoint, network: InProcessNetwork,
                 settings: Optional[Settings] = None,
                 rng: Optional[random.Random] = None) -> None:
        self.address = address
        self._network = network
        self._settings = settings if settings is not None else Settings()
        # jitter draws; content-seeded (not id/hash-salted) so virtual-time
        # runs replay bit-identically across processes
        self._rng = rng if rng is not None else random.Random(
            zlib.crc32(address.hostname) ^ address.port
        )
        self._shutdown = False

    def send_message(self, remote: Endpoint, msg: RapidMessage) -> Promise:
        timeout = self._settings.timeout_for(msg)
        return call_with_retries(
            lambda: self._network.deliver(self.address, remote, msg, timeout),
            self._settings.message_retries,
            scheduler=self._network.scheduler,
            policy=self._settings.retry_policy(),
            deadline_ms=self._settings.deadline_for(msg),
            rng=self._rng,
        )

    def send_message_best_effort(self, remote: Endpoint, msg: RapidMessage) -> Promise:
        timeout = self._settings.timeout_for(msg)
        return self._network.deliver(self.address, remote, msg, timeout)

    def shutdown(self) -> None:
        self._shutdown = True
