"""The messaging plugin seam.

The port's own copy of ``rapid_tpu/messaging/base.py``. Reference: messaging/IMessagingClient.java:25-48, IMessagingServer.java:24-41,
IBroadcaster.java:24-29. This is one of the two seams Rapid exposes for
swapping transports (the other is the edge failure detector); the TCP
transport (``tcp.py``) and the gateway's routed client (``gateway.py``)
implement exactly these interfaces.
"""

from __future__ import annotations

from typing import List

from ..runtime.futures import Promise
from ..types import Endpoint, RapidMessage


class IMessagingClient:
    """Sends messages to remote nodes."""

    def send_message(self, remote: Endpoint, msg: RapidMessage) -> Promise:
        """Send with per-message-type timeouts and retries
        (IMessagingClient.java:25-37)."""
        raise NotImplementedError

    def send_message_best_effort(self, remote: Endpoint, msg: RapidMessage) -> Promise:
        """Single attempt, no retries (IMessagingClient.java:39-45)."""
        raise NotImplementedError

    def shutdown(self) -> None:
        raise NotImplementedError


class IMessagingServer:
    """Receives messages and hands them to a MembershipService."""

    def start(self) -> None:
        raise NotImplementedError

    def shutdown(self) -> None:
        raise NotImplementedError

    def set_membership_service(self, service) -> None:
        """Until this is called the server must not dispatch protocol messages
        (probes get a BOOTSTRAPPING answer instead, GrpcServer.java:77-96)."""
        raise NotImplementedError


class IBroadcaster:
    """Disseminates a message to all cluster members (IBroadcaster.java:24-29).

    Broadcast is deliberately not a transport primitive: the default
    implementation is best-effort unicast-to-all, but gossip/flooding
    alternatives can be plugged in.
    """

    def broadcast(self, msg: RapidMessage) -> List[Promise]:
        raise NotImplementedError

    def set_membership(self, recipients: List[Endpoint]) -> None:
        raise NotImplementedError
