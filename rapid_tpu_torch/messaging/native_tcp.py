"""TCP transport with a native epoll server half.

The port's own copy of ``rapid_tpu/messaging/native_tcp.py``, on the port's
``messaging/tcp.py`` and ``codec.py``. Same seam, same wire format, same
client half as ``TcpClientServer`` -- only the server's socket mechanics
move to native code: the C++ reactor
(csrc/host/rapid_io.cpp via runtime.native_io) multiplexes all accepted
connections on one epoll thread, where the Python server spends a blocking
reader thread per connection. This mirrors how the reference stacks its
transport on a shared native-adjacent event loop (Netty's NIO group,
SharedResources.java:63-67) rather than on JDK blocking sockets.

Interoperability is total: the frame format is codec's u32-length prefix,
so ``NativeTcpClientServer`` servers talk to ``TcpClientServer`` clients
and vice versa; the two are drop-in replacements for each other anywhere
an ``IMessagingServer`` is expected (Cluster, the standalone agent), and
either package's transport talks to the other's.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

from ..runtime.futures import Promise
from ..runtime.native_io import EV_CLOSED, EV_FRAME, EV_SHUTDOWN, NativeReactor
from ..runtime.native_io import available as native_io_available
from ..settings import Settings
from ..types import Endpoint
from .codec import decode, encode
from .tcp import TcpClientServer

LOG = logging.getLogger(__name__)

__all__ = ["NativeTcpClientServer", "native_io_available"]


class NativeTcpClientServer(TcpClientServer):
    """``TcpClientServer`` with the server half on the native reactor.

    The client half (connection cache, request correlation, retries) is
    inherited unchanged; ``start``/``shutdown`` swap the accept/read
    machinery for the epoll loop, and replies address connections by the
    reactor's ``conn_id`` instead of a socket object.
    """

    def __init__(
        self, listen_address: Endpoint, settings: Optional[Settings] = None
    ) -> None:
        super().__init__(listen_address, settings)
        # the parent's FramedTcpServer stays constructed-but-never-started
        # (no socket until start()); its shutdown() is a safe no-op, so the
        # inherited lifecycle keeps working on this subclass
        self._reactor: Optional[NativeReactor] = None
        self._dispatcher: Optional[threading.Thread] = None
        self._running = False

    # -- server side ---------------------------------------------------------

    def start(self) -> None:
        self._reactor = NativeReactor(
            self.address.hostname.decode(), self.address.port
        )
        if self.address.port == 0:  # ephemeral bind: adopt the real port
            self.address = Endpoint(self.address.hostname, self._reactor.port)
        self._running = True
        self._dispatcher = threading.Thread(  # noqa: messaging-thread
            target=self._dispatch_loop,
            name=f"native-tcp-{self.address}",
            daemon=True,
        )
        self._dispatcher.start()

    def _dispatch_loop(self) -> None:
        reactor = self._reactor
        assert reactor is not None
        while self._running:
            ev, conn_id, payload = reactor.poll(timeout_ms=500)
            if ev == EV_SHUTDOWN:
                return
            if ev == EV_FRAME:
                try:
                    request_no, msg = decode(payload)
                except Exception:  # noqa: BLE001 -- malformed frame: drop it
                    LOG.warning("undecodable frame from conn %d", conn_id)
                    continue
                self._dispatch(msg).add_callback(
                    lambda p, c=conn_id, rn=request_no: self._native_reply(
                        c, rn, p
                    )
                )
            elif ev == EV_CLOSED:
                pass  # request/response transport: no per-conn state to drop

    def _native_reply(self, conn_id: int, request_no: int,
                      promise: Promise) -> None:
        if promise.exception() is not None:
            return  # no response; the caller's deadline handles it
        response = promise._result  # noqa: SLF001
        if response is None:
            return
        reactor = self._reactor
        if reactor is not None:
            reactor.send(conn_id, encode(request_no, response))

    # -- lifecycle -----------------------------------------------------------

    def shutdown(self) -> None:
        self._running = False
        if self._reactor is not None:
            self._reactor.shutdown()
        if self._dispatcher is not None:
            self._dispatcher.join(timeout=2.0)
        self._shutdown_client_half()
