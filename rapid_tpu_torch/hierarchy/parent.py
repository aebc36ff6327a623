"""Parent configuration: leader election, per-cell epochs, composed view.

The port of ``rapid_tpu/hierarchy/parent.py``.

**Leader election is a pure function of the cell's view.** The leader set
of a cell is the first ``leaders_per_cell`` members of the cell in leader
order: ascending seeded endpoint hash (hashing.endpoint_hash with the
leader seed), endpoint as the tie-break. Any member that knows the cell's
membership knows its leaders; failover is a non-event by construction.

**The parent configuration** is the union of every cell's leader set. Its
configuration id is the chained ``h = h*37 + x`` fold (the
MembershipView.java:535-547 discipline, shared with
sim/topology.config_fold) over the sorted leader endpoints' hashes.

**The composed global view** is one row per cell -- (cell id, config-id
epoch, membership size, leader, membership fingerprint) -- folded into a
single global fingerprint with the same chained hash, so whole cluster
states compare as single integers.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, Sequence, Tuple

from ..hashing import endpoint_hash, xxh64, xxh64_long
from ..types import Endpoint

_MASK = (1 << 64) - 1
# seed for the leader ordering, disjoint from ring seeds and the cell
# rendezvous seeds so leader rank never correlates with either
_LEADER_SEED = 0x4C454144  # "LEAD"


def leader_key(endpoint: Endpoint) -> Tuple[int, bytes, int]:
    """Sort key of the deterministic leader order within a cell."""
    return (
        endpoint_hash(endpoint.hostname, endpoint.port, _LEADER_SEED),
        endpoint.hostname,
        endpoint.port,
    )


def cell_leaders(
    members: Sequence[Endpoint], leaders_per_cell: int = 1
) -> Tuple[Endpoint, ...]:
    """The cell's leader set: first ``leaders_per_cell`` members in leader
    order. Pure function of the membership -- no messages, no state."""
    ordered = sorted(members, key=leader_key)
    return tuple(ordered[: max(1, leaders_per_cell)])


def _fold(values: Iterable[int]) -> int:
    """Chained configuration fold (MembershipView.java:535-547): Java
    ``h = h * 37 + x`` over already-hashed 64-bit elements, returned as a
    signed 64-bit int (the configuration-id convention everywhere)."""
    h = 1
    for value in values:
        h = (h * 37 + (value & _MASK)) & _MASK
    return h - (1 << 64) if h >= (1 << 63) else h


def parent_configuration_id(leaders: Iterable[Endpoint]) -> int:
    """Configuration id of the parent (leader-set) configuration: the
    chained fold over the sorted leaders' endpoint hashes."""
    keys = sorted(
        endpoint_hash(ep.hostname, ep.port, 0) for ep in set(leaders)
    )
    return _fold(keys)


@dataclass(frozen=True)
class CellState:
    """One cell's row in the composed global view, as last reported by
    its leader (or derived locally for the member's own cell)."""

    cell: int
    epoch: int            # the cell's local configuration id
    size: int             # the cell's membership size
    leader: str           # "host:port" of the cell's rank-0 leader
    fingerprint: int = 0  # fold over the cell's sorted member hashes

    def row_hash(self) -> int:
        seed = self.cell & 0xFFFFFFFF
        return (
            xxh64_long(self.epoch, seed)
            ^ xxh64_long(self.size, seed + 1)
            ^ xxh64(self.leader.encode("utf-8"), seed + 2)
            ^ xxh64_long(self.fingerprint, seed + 3)
        )


def cell_fingerprint(members: Sequence[Endpoint]) -> int:
    """Fold over a cell's sorted member hashes -- the membership identity
    a digest carries so two leaders disagreeing about who is in the cell
    produce different composed fingerprints even at equal sizes."""
    return _fold(
        sorted(endpoint_hash(ep.hostname, ep.port, 0) for ep in members)
    )


def compose_fingerprint(rows: Iterable[CellState]) -> int:
    """The composed global fingerprint: chained fold over the per-cell
    row hashes in cell order. Single-integer equality == whole-cluster
    agreement on every cell's (epoch, size, leader, membership)."""
    ordered = sorted(rows, key=lambda r: r.cell)
    return _fold(r.row_hash() for r in ordered)


@dataclass
class GlobalView:  # guarded-by: protocol-executor
    """The composed two-level view: one CellState per known cell.

    Mutated only through :meth:`install`, which returns whether the
    composition actually moved -- the edge the plane uses to decide
    whether to re-announce to its cell."""

    cells: Dict[int, CellState] = field(default_factory=dict)

    def install(self, state: CellState) -> bool:
        """Adopt ``state`` for its cell; a row identical to the known one
        is a no-op (a leader restating the same view). Epochs are Rapid
        configuration ids -- chained hashes, NOT ordered -- so staleness
        cannot be judged here: the plane gates reordered frames by each
        sender's monotonic parent round before calling install
        (hierarchy/plane.py)."""
        known = self.cells.get(state.cell)
        if known == state:
            return False
        self.cells[state.cell] = state
        return True

    def evict_cell(self, cell: int) -> bool:
        """Drop a cell's row (the parent agreed the whole cell is gone)."""
        return self.cells.pop(cell, None) is not None

    def fingerprint(self) -> int:
        return compose_fingerprint(self.cells.values())

    def member_count(self) -> int:
        return sum(state.size for state in self.cells.values())

    def leaders(self) -> Tuple[str, ...]:
        return tuple(
            self.cells[cell].leader for cell in sorted(self.cells)
        )

    def rows(self) -> Tuple[CellState, ...]:
        return tuple(self.cells[cell] for cell in sorted(self.cells))

    def digest(self) -> Tuple[Tuple[int, ...], Tuple[int, ...],
                              Tuple[int, ...], Tuple[str, ...],
                              Tuple[int, ...]]:
        """Parallel (cells, epochs, sizes, leaders, fingerprints) arrays --
        the wire and statusz carriage shape."""
        rows = self.rows()
        return (
            tuple(r.cell for r in rows),
            tuple(r.epoch for r in rows),
            tuple(r.size for r in rows),
            tuple(r.leader for r in rows),
            tuple(r.fingerprint for r in rows),
        )
