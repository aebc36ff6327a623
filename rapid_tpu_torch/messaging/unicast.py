"""Default broadcaster: best-effort unicast to every member.

The port's own copy of ``rapid_tpu/messaging/unicast.py``.

Reference: UnicastToAllBroadcaster.java:46-63. Recipients are shuffled once per
configuration so the send order differs across nodes and spreads load.

With ``Settings.broadcast_flush_window_ms > 0`` the broadcaster coalesces:
per-recipient sends accumulate in a ``BatchingSink`` for one flush window and
leave as a single ``MessageBatch`` envelope per peer -- a churn wave's alerts
and votes ride one frame per peer instead of one each. The default window of
0 preserves the legacy send-per-message path (and exact virtual-time timing).
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional

from ..observability import (
    current_trace_context,
    stamp_trace_context,
    trace_context_of,
)
from ..runtime.futures import Promise
from ..runtime.lockdep import make_lock
from ..settings import Settings
from ..types import Endpoint, MessageBatch, RapidMessage
from .base import IBroadcaster, IMessagingClient


class BatchingSink:
    """Per-peer flush-window coalescer shared by the broadcasters: ``offer``
    queues one message for one recipient; the first offer of a quiet window
    schedules a flush ``window_ms`` later on the caller's scheduler (virtual
    or wall clock), and the flush sends each peer's accumulated messages as
    one ``MessageBatch`` envelope (or the bare message when only one
    accumulated -- an unbatched peer sees no format change on light
    traffic). Batched sends are fire-and-forget: the transport promises are
    dropped, exactly like the legacy best-effort broadcast promises."""

    def __init__(
        self,
        client: IMessagingClient,
        my_addr: Endpoint,
        scheduler,
        window_ms: int,
    ) -> None:
        self._client = client
        self._my_addr = my_addr
        self._scheduler = scheduler
        self._window_ms = window_ms
        self._lock = make_lock("BatchingSink._lock")
        self._pending: Dict[Endpoint, List[RapidMessage]] = {}  # guarded-by: _lock
        self._flush_scheduled = False  # guarded-by: _lock

    def offer(self, recipient: Endpoint, msg: RapidMessage) -> None:
        with self._lock:
            self._pending.setdefault(recipient, []).append(msg)
            schedule = not self._flush_scheduled
            if schedule:
                self._flush_scheduled = True
        if schedule:
            self._scheduler.schedule(self._window_ms, self.flush)

    def flush(self) -> None:
        with self._lock:
            pending, self._pending = self._pending, {}
            self._flush_scheduled = False
        metrics = getattr(self._client, "metrics", None)
        for recipient, msgs in pending.items():
            if len(msgs) == 1:
                self._client.send_message_best_effort(recipient, msgs[0])
                continue
            batch = MessageBatch(sender=self._my_addr, messages=tuple(msgs))
            # the native codec carries only the TOP-LEVEL trace context, so
            # the envelope wears the first inner stamp; the receiver
            # re-stamps any inner that lost its own (service.py)
            ctx = next(
                (c for c in map(trace_context_of, msgs) if c is not None),
                None,
            )
            if ctx is not None:
                stamp_trace_context(batch, ctx)
            if metrics is not None:
                metrics.incr("msg.batches_sent")
                metrics.incr("msg.batched_messages", len(msgs))
            self._client.send_message_best_effort(recipient, batch)


def make_batching_sink(
    client: IMessagingClient,
    my_addr: Optional[Endpoint],
    scheduler,
    settings: Optional[Settings],
) -> Optional[BatchingSink]:
    """A sink iff batching is configured AND the caller supplied the pieces
    it needs (address for the envelope sender, scheduler for the window)."""
    if (
        settings is None
        or settings.broadcast_flush_window_ms <= 0
        or scheduler is None
        or my_addr is None
    ):
        return None
    return BatchingSink(
        client, my_addr, scheduler, settings.broadcast_flush_window_ms
    )


class UnicastToAllBroadcaster(IBroadcaster):
    def __init__(
        self,
        client: IMessagingClient,
        rng: Optional[random.Random] = None,
        settings: Optional[Settings] = None,
        scheduler=None,
        my_addr: Optional[Endpoint] = None,
    ) -> None:
        self._client = client
        self._recipients: List[Endpoint] = []  # guarded-by: protocol-executor
        self._rng = rng if rng is not None else random.Random()
        self._sink = make_batching_sink(client, my_addr, scheduler, settings)

    def broadcast(self, msg: RapidMessage) -> List[Promise]:
        # trace injection at the send seam: keep an explicit stamp (the
        # service's churn context), else inherit the ambient span (e.g. a
        # consensus vote broadcast from inside an alert_batch span). One
        # stamp serves every recipient -- the same object fans out.
        if trace_context_of(msg) is None:
            stamp_trace_context(msg, current_trace_context())
        if self._sink is not None:
            for recipient in self._recipients:
                self._sink.offer(recipient, msg)
            return []  # fire-and-forget; flushed after the window
        return [
            self._client.send_message_best_effort(recipient, msg)
            for recipient in self._recipients
        ]

    def set_membership(self, recipients: List[Endpoint]) -> None:
        shuffled = list(recipients)
        self._rng.shuffle(shuffled)
        self._recipients = shuffled
