"""Deterministic cell assignment: pure functions, no state, no RNG.

The port of ``rapid_tpu/hierarchy/cells.py``. Two disciplines, consulted in
this order:

- **Topology cells** -- when a :class:`~..sim.topology.LatencyTopology`
  places the member (``cell_of_slot``), the zone IS the cell. Simulator
  slots are topology indices already; the protocol plane maps endpoints to
  indices the same way the fault plane does (``FaultPlan.topology_slots``).
- **Rendezvous cells** -- topology-less clusters fall back to
  highest-random-weight hashing (``cell_of_endpoint``): each endpoint
  scores every cell with the seeded endpoint hash the rings already use
  (hashing.endpoint_hash) and joins the argmax, so growing the cell count
  moves only ~1/cells of the members.

Both are pure functions of (identity, cell count), so any two members
that agree on the member list agree on the whole cell partition -- the
property leader election (parent.py) builds on.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from ..hashing import endpoint_hash
from ..types import Endpoint

# seed base for rendezvous scoring, disjoint from the K ring seeds (which
# are small ring indices) so cell placement never correlates with ring
# adjacency
_CELL_SEED_BASE = 0x43454C4C  # "CELL"


def cell_of_endpoint(endpoint: Endpoint, cells: int) -> int:
    """Rendezvous (highest-random-weight) cell of ``endpoint`` among
    ``cells`` cells. Deterministic everywhere the endpoint is known."""
    if cells <= 1:
        return 0
    best_cell = 0
    best_score = -1
    for cell in range(cells):
        score = endpoint_hash(
            endpoint.hostname, endpoint.port, _CELL_SEED_BASE + cell
        )
        if score > best_score:
            best_score = score
            best_cell = cell
    return best_cell


def cell_of_slot(slot: int, topology) -> int:
    """Topology cell of device slot / topology index ``slot``: the zone
    (LatencyTopology.zone_of -- a pure function of the index)."""
    return topology.zone_of(int(slot))


def cell_count(cells: int, topology=None) -> int:
    """Resolve the configured cell count: an explicit ``cells > 0`` wins;
    otherwise the topology's zone count; otherwise one cell (which makes
    the hierarchy a flat cluster plus a trivial parent of one leader)."""
    if cells > 0:
        return int(cells)
    if topology is not None:
        return int(topology.zones)
    return 1


def cell_of(
    endpoint: Endpoint,
    cells: int,
    topology=None,
    slots: Optional[Dict[Endpoint, int]] = None,
) -> int:
    """The one assignment function every plane shares: topology zone when
    the endpoint is placed (``slots`` maps endpoints to topology indices),
    rendezvous hash otherwise."""
    if topology is not None and slots is not None:
        index = slots.get(endpoint)
        if index is not None:
            return cell_of_slot(index, topology)
    return cell_of_endpoint(endpoint, cell_count(cells, topology))


def cell_members(
    members: Iterable[Endpoint],
    cells: int,
    topology=None,
    slots: Optional[Dict[Endpoint, int]] = None,
) -> Dict[int, List[Endpoint]]:
    """Partition ``members`` into cells, preserving input order inside
    each cell (callers pass ring-0 order, so per-cell order is itself the
    ring order every member agrees on)."""
    resolved = cell_count(cells, topology)
    out: Dict[int, List[Endpoint]] = {}
    for member in members:
        out.setdefault(
            cell_of(member, resolved, topology=topology, slots=slots), []
        ).append(member)
    return out


def cell_sizes(
    members: Iterable[Endpoint],
    cells: int,
    topology=None,
    slots: Optional[Dict[Endpoint, int]] = None,
) -> Tuple[Tuple[int, int], ...]:
    """Sorted ``(cell, size)`` rows -- the statusz/bench digest shape."""
    grouped = cell_members(members, cells, topology=topology, slots=slots)
    return tuple((cell, len(grouped[cell])) for cell in sorted(grouped))
