"""Cell-aware routing on the broadcaster seam + the leader's parent channel.

The port's own copy of ``rapid_tpu/hierarchy/routing.py``.

Two pieces, both hung on existing seams rather than new transports:

- :class:`CellRouter` wraps any :class:`~..messaging.base.IBroadcaster`
  (unicast-to-all or gossip alike) and narrows its membership to the
  local member's cell, so every protocol broadcast -- alerts, fast-round
  votes, classical Paxos rounds -- stays inside the cell. This is the
  whole O(members) -> O(cell) reduction: the cut detector and Fast Paxos
  are untouched, they just see a cell-sized cluster.
- :class:`ParentChannel` is the leader's high-fan-in fabric for parent
  traffic: cell digests to the other cells' leaders, composed global
  views back into the local cell. It reuses the broadcaster's flush-window
  discipline (:class:`~..messaging.unicast.BatchingSink`) so a churn
  wave's digests leave as one ``MessageBatch`` per peer leader; with
  ``hierarchy.parent_flush_ms == 0`` it degrades to bare best-effort
  sends (and exact virtual-time timing), mirroring the broadcaster's own
  window semantics.

Neither class knows how cells are assigned or who leads them -- the
:class:`~.plane.HierarchyPlane` computes both from the installed view and
feeds this module plain endpoint lists.
"""

from __future__ import annotations

from typing import List, Sequence

from ..runtime.futures import Promise
from ..types import Endpoint, RapidMessage
from ..messaging.base import IBroadcaster, IMessagingClient
from .cells import cell_of


class CellRouter(IBroadcaster):  # guarded-by: protocol-executor
    """Broadcaster decorator: same ``broadcast``, cell-filtered membership.

    ``set_membership`` receives the full ring-0 recipient list exactly as
    the flat path would, partitions it with the shared assignment function
    (:func:`~.cells.cell_of`), and forwards only the local cell's members
    to the wrapped broadcaster. The wrapped broadcaster keeps all its own
    behavior (shuffle, flush windows, gossip fan-out) -- it simply serves
    a smaller cluster."""

    def __init__(
        self,
        inner: IBroadcaster,
        my_addr: Endpoint,
        cells: int,
        topology=None,
        slots=None,
    ) -> None:
        self._inner = inner
        self._my_addr = my_addr
        self._cells = cells
        self._topology = topology
        self._slots = slots
        self._my_cell = cell_of(
            my_addr, cells, topology=topology, slots=slots
        )
        self._cell_recipients: List[Endpoint] = []

    @property
    def my_cell(self) -> int:
        return self._my_cell

    @property
    def cell_recipients(self) -> List[Endpoint]:
        """The current cell-local recipient list (ring-0 order)."""
        return list(self._cell_recipients)

    def broadcast(self, msg: RapidMessage) -> List[Promise]:
        return self._inner.broadcast(msg)

    def set_membership(self, recipients: List[Endpoint]) -> None:
        self._cell_recipients = [
            ep
            for ep in recipients
            if cell_of(
                ep, self._cells, topology=self._topology, slots=self._slots
            )
            == self._my_cell
        ]
        self._inner.set_membership(self._cell_recipients)


class ParentChannel:
    """The leader's fabric for cross-cell traffic.

    ``send_to_leaders`` fans a message out to peer leaders (parent plane);
    ``send_to_cell`` fans the composed global view back into the local
    cell. Both coalesce through one shared ``BatchingSink`` when
    ``parent_flush_ms > 0`` -- the high-fan-in case this exists for is a
    multi-cell churn wave, where a leader's digests to every peer leader
    ride one ``MessageBatch`` per peer per window."""

    def __init__(
        self,
        client: IMessagingClient,
        my_addr: Endpoint,
        scheduler=None,
        flush_ms: int = 0,
    ) -> None:
        self._client = client
        self._my_addr = my_addr
        self._sink = None
        if flush_ms > 0 and scheduler is not None:
            from ..messaging.unicast import BatchingSink

            self._sink = BatchingSink(client, my_addr, scheduler, flush_ms)

    def _send(self, recipient: Endpoint, msg: RapidMessage) -> None:
        if self._sink is not None:
            self._sink.offer(recipient, msg)
        else:
            self._client.send_message_best_effort(recipient, msg)

    def send_to_leaders(
        self, leaders: Sequence[Endpoint], msg: RapidMessage
    ) -> int:
        """Best-effort fan-out to every peer leader except self; returns
        the number of sends offered."""
        sent = 0
        for leader in leaders:
            if leader == self._my_addr:
                continue
            self._send(leader, msg)
            sent += 1
        return sent

    def send_to_cell(
        self, members: Sequence[Endpoint], msg: RapidMessage
    ) -> int:
        """Fan the composed view back into the local cell (skip self --
        the plane installs locally without a loopback hop)."""
        sent = 0
        for member in members:
            if member == self._my_addr:
                continue
            self._send(member, msg)
            sent += 1
        return sent

    def flush(self) -> None:
        """Force out any window-pending parent traffic (shutdown path)."""
        if self._sink is not None:
            self._sink.flush()
