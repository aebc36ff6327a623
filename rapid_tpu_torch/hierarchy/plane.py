"""HierarchyPlane: the per-node two-level composition engine.

The port's own copy of ``rapid_tpu/hierarchy/plane.py``.

Each cell is an ordinary Rapid cluster -- unchanged cut detector, unchanged
Fast Paxos -- whose local configuration id doubles as the cell's *epoch* in
the composed global view. This plane is everything above that: after every
intra-cell view install the node recomputes its cell's deterministic leader
set (parent.cell_leaders); if it leads, it announces the cell's row to the
other cells' leaders (CellDigestMessage, tag 26) and fans the composed
global view back into its own cell (GlobalViewMessage, tag 27) whenever the
composition moved. Followers just install what their leader announces.

Leader failover is a non-event by construction: a leader eviction is an
ordinary intra-cell view change, after which `cell_leaders` of the new view
simply names the next member in leader order -- no election protocol, no
parent-level churn beyond one digest with a higher epoch.

Whole-cell eviction is the one place liveness enters: a cell that lost every
member (leader included) can never announce its own departure. Each leader
keeps a parent-round counter, incremented at every announce edge, and stamps
each foreign cell's row with the round it last refreshed in; a row idle for
``eviction_rounds`` parent rounds is dropped from the composition -- O(1)
parent rounds after the loss, independent of member count. Rounds advance on
view-change edges and on the periodic leader heartbeat (``tick``, driven by
``hierarchy.parent_round_ms`` on the service's scheduler): the heartbeat
re-announces the leader's digest so peers' idle stamps stay fresh, which is
what lets survivors that see no churn of their own still evict a lost cell.
On the deterministic scheduler (harness/sim) heartbeats are virtual-time
events, so the whole discipline stays reproducible per seed.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..types import CellDigestMessage, Endpoint, GlobalViewMessage
from .cells import cell_of
from .parent import (
    CellState,
    GlobalView,
    cell_fingerprint,
    cell_leaders,
    parent_configuration_id,
)
from .routing import ParentChannel


class HierarchyPlane:  # guarded-by: protocol-executor
    """Drives the two-level composition for one node.

    Not thread-safe by itself: the service calls every entry point from
    its single protocol executor (the same guarded-by discipline as the
    cut detector), and the sim driver is single-threaded."""

    def __init__(
        self,
        my_addr: Endpoint,
        channel: Optional[ParentChannel] = None,
        cells: int = 0,
        leaders_per_cell: int = 1,
        topology=None,
        slots=None,
        eviction_rounds: int = 3,
    ) -> None:
        self._my_addr = my_addr
        self._channel = channel
        self._cells = cells
        self._leaders_per_cell = leaders_per_cell
        self._topology = topology
        self._slots = slots
        self._eviction_rounds = eviction_rounds
        self.my_cell = cell_of(my_addr, cells, topology=topology, slots=slots)
        self.global_view = GlobalView()
        self._cell_members: Tuple[Endpoint, ...] = ()
        self._leaders: Tuple[Endpoint, ...] = ()
        self._parent_round = 0
        # parent-round stamp each foreign cell's row last refreshed in
        self._last_seen: Dict[int, int] = {}
        # reorder gates: epochs are configuration-id hashes (unordered),
        # so stale frames are rejected by each SENDER's monotonic parent
        # round instead -- per-cell for digests, one for the global-view
        # stream from our own leader; a changed leader resets the gate
        # (leadership is recomputed deterministically from the new view)
        self._digest_gate: Dict[int, Tuple[str, int]] = {}
        self._view_gate: Tuple[str, int] = ("", -1)

    # ------------------------------------------------------------------ #
    # Derived state
    # ------------------------------------------------------------------ #

    @property
    def is_leader(self) -> bool:
        return self._my_addr in self._leaders

    @property
    def leaders(self) -> Tuple[Endpoint, ...]:
        return self._leaders

    @property
    def parent_round(self) -> int:
        return self._parent_round

    def parent_configuration_id(self) -> int:
        """Config id of the parent configuration: the fold over the sorted
        leader endpoints named by the composed view's rows."""
        return parent_configuration_id(
            Endpoint.from_string(leader)
            for leader in self.global_view.leaders()
        )

    def peer_leaders(self) -> List[Endpoint]:
        """Rank-0 leaders of every *other* cell the composition knows."""
        return [
            Endpoint.from_string(state.leader)
            for cell, state in sorted(self.global_view.cells.items())
            if cell != self.my_cell
        ]

    # ------------------------------------------------------------------ #
    # Entry points
    # ------------------------------------------------------------------ #

    def seed_parent(self, leaders: Sequence[Endpoint]) -> None:
        """Bootstrap hint: endpoints believed to lead other cells (the
        hierarchy's analogue of the join seed). Rows are installed at epoch
        0 with unknown size, so the first real digest from each replaces
        them; wrong hints age out like any dead cell."""
        hinted = []
        for leader in leaders:
            cell = cell_of(
                leader,
                self._cells,
                topology=self._topology,
                slots=self._slots,
            )
            if cell == self.my_cell:
                continue
            hinted.append(leader)
            self.global_view.install(
                CellState(cell=cell, epoch=0, size=0, leader=str(leader))
            )
            self._last_seen.setdefault(cell, self._parent_round)
        if (
            hinted
            and self.is_leader
            and self._channel is not None
            and self.my_cell in self.global_view.cells
        ):
            # introduce ourselves: the hint endpoints need not be their
            # cells' actual leaders -- a non-leader receiver relays one
            # hop to its own rank-0 leader (handle_digest), and the reply
            # carries the real rows back
            self._channel.send_to_leaders(hinted, self._own_digest())

    def on_view_installed(
        self, members: Sequence[Endpoint], configuration_id: int
    ) -> None:
        """The one hook the membership layer calls, right after an
        intra-cell view install: recompute leadership from the new view,
        refresh our own row, advance the parent round, age out dead cells,
        and (if leading) announce."""
        self._cell_members = tuple(members)
        self._leaders = cell_leaders(members, self._leaders_per_cell)
        own = CellState(
            cell=self.my_cell,
            epoch=configuration_id,
            size=len(members),
            leader=str(self._leaders[0]) if self._leaders else "",
            fingerprint=cell_fingerprint(members),
        )
        moved = self.global_view.install(own)
        if not self.is_leader:
            return
        self._parent_round += 1
        self._last_seen[self.my_cell] = self._parent_round
        evicted = self._age_out()
        if moved or evicted:
            self._announce()

    def tick(self) -> None:
        """Parent heartbeat (leaders only): advance the round, refresh our
        own stamp, age out idle cells, and re-announce our digest so peer
        leaders' stamps for us stay fresh. A quiet follower's rounds never
        advance -- eviction authority stays with leaders, and followers
        adopt removals from the fanned view."""
        if not self.is_leader or self.my_cell not in self.global_view.cells:
            return
        self._parent_round += 1
        self._last_seen[self.my_cell] = self._parent_round
        evicted = self._age_out()
        if self._channel is not None:
            self._channel.send_to_leaders(
                self.peer_leaders(), self._own_digest()
            )
            if evicted:
                self._fan_into_cell()

    def handle_message(self, msg) -> bool:
        """Dispatch seam for the service: returns True iff consumed."""
        if isinstance(msg, CellDigestMessage):
            self.handle_digest(msg)
            return True
        if isinstance(msg, GlobalViewMessage):
            self.handle_global_view(msg)
            return True
        return False

    def handle_digest(self, msg: CellDigestMessage) -> None:
        """A peer leader's announcement of its cell's row."""
        if msg.cell == self.my_cell:
            # our own cell's row is locally derived, never adopted from
            # the wire -- a partitioned stale leader cannot regress us
            return
        gate = self._digest_gate.get(msg.cell)
        if (
            gate is not None
            and gate[0] == msg.leader
            and msg.parent_round < gate[1]
        ):
            return  # reordered stale frame from the same leader
        self._digest_gate[msg.cell] = (msg.leader, msg.parent_round)
        first_contact = msg.cell not in self.global_view.cells
        moved = self.global_view.install(
            CellState(
                cell=msg.cell,
                epoch=msg.configuration_id,
                size=msg.membership_size,
                leader=msg.leader,
                fingerprint=msg.fingerprint,
            )
        )
        self._last_seen[msg.cell] = self._parent_round
        if not self.is_leader:
            # one-hop relay to our own rank-0 leader: parent traffic
            # addressed on a stale leader table (bootstrap hints, or a
            # sender that missed our leader failover) still reaches the
            # parent plane; leaders never relay, so no loops
            if self._channel is not None and self._leaders:
                self._channel.send_to_leaders([self._leaders[0]], msg)
            return
        if (moved or first_contact) and self._channel is not None:
            # symmetric introduction: the sender's row moved ours, so ours
            # (or its real leader) is likely news to the sender too --
            # reply with our own row; converges because install() is a
            # no-op once both sides agree
            self._channel.send_to_leaders([msg.sender], self._own_digest())
        if moved:
            self._fan_into_cell()

    def handle_global_view(self, msg: GlobalViewMessage) -> None:
        """Our own leader's composed view, fanned into the cell. Adopt
        every foreign row; our own cell's row stays locally derived.
        Reordered frames from the same leader are gated by its monotonic
        parent round."""
        sender = str(msg.sender)
        if sender == self._view_gate[0] and msg.parent_round < self._view_gate[1]:
            return
        self._view_gate = (sender, msg.parent_round)
        announced = set()
        for cell, epoch, size, leader, fingerprint in zip(
            msg.cells, msg.epochs, msg.sizes, msg.leaders, msg.fingerprints
        ):
            announced.add(cell)
            if cell == self.my_cell:
                continue
            if self.global_view.install(
                CellState(
                    cell=cell,
                    epoch=epoch,
                    size=size,
                    leader=leader,
                    fingerprint=fingerprint,
                )
            ):
                self._last_seen[cell] = self._parent_round
        # rows the leader no longer composes are evictions (e.g. a whole
        # cell aged out at the leader): adopt the removal too, or the
        # composed fingerprints would diverge leader-vs-followers forever
        for cell in list(self.global_view.cells):
            if cell != self.my_cell and cell not in announced:
                self.global_view.evict_cell(cell)
                self._last_seen.pop(cell, None)
                self._digest_gate.pop(cell, None)

    # ------------------------------------------------------------------ #
    # Announce path (leaders only)
    # ------------------------------------------------------------------ #

    def _own_digest(self) -> CellDigestMessage:
        own = self.global_view.cells[self.my_cell]
        return CellDigestMessage(
            sender=self._my_addr,
            cell=own.cell,
            configuration_id=own.epoch,
            membership_size=own.size,
            leader=own.leader,
            fingerprint=own.fingerprint,
            parent_round=self._parent_round,
        )

    def _announce(self) -> None:
        if self._channel is None:
            return
        self._channel.send_to_leaders(self.peer_leaders(), self._own_digest())
        self._fan_into_cell()

    def _fan_into_cell(self) -> None:
        if self._channel is None:
            return
        cells, epochs, sizes, leaders, fingerprints = self.global_view.digest()
        self._channel.send_to_cell(
            self._cell_members,
            GlobalViewMessage(
                sender=self._my_addr,
                parent_configuration_id=self.parent_configuration_id(),
                global_fingerprint=self.global_view.fingerprint(),
                cells=cells,
                epochs=epochs,
                sizes=sizes,
                leaders=leaders,
                fingerprints=fingerprints,
                parent_round=self._parent_round,
            ),
        )

    def _age_out(self) -> bool:
        """Drop foreign cells idle for ``eviction_rounds`` parent rounds.
        Only meaningful on leaders (followers' rounds don't advance)."""
        evicted = False
        for cell in list(self.global_view.cells):
            if cell == self.my_cell:
                continue
            seen = self._last_seen.get(cell, self._parent_round)
            if self._parent_round - seen >= self._eviction_rounds:
                self.global_view.evict_cell(cell)
                self._last_seen.pop(cell, None)
                self._digest_gate.pop(cell, None)
                evicted = True
        return evicted

    # ------------------------------------------------------------------ #
    # Status digest (cluster_status carriage)
    # ------------------------------------------------------------------ #

    def status_fields(self) -> Dict[str, object]:
        """The hierarchy fields of ClusterStatusResponse, ready to splat."""
        cells, epochs, sizes, leaders, _ = self.global_view.digest()
        return {
            "cell_id": self.my_cell,
            "cell_size": len(self._cell_members),
            "parent_configuration_id": self.parent_configuration_id(),
            "global_fingerprint": self.global_view.fingerprint(),
            "global_cells": cells,
            "global_epochs": epochs,
            "global_sizes": sizes,
            "global_leaders": leaders,
        }
