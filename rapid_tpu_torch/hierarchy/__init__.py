"""Hierarchy plane: two-level cell-based membership.

- :mod:`.cells`  -- deterministic cell assignment (topology zones when a
  :class:`~..sim.topology.LatencyTopology` is attached, rendezvous hash
  otherwise), shared by the simulator and the fault plane's cell rules.
- :mod:`.parent` -- leader election as a pure function of the cell's view,
  per-cell config-id epochs, and the composed global fingerprint.

The live engine's ``plane.py`` and ``routing.py`` (cell-aware routing and
the leaders' parent channel) serve the protocol plane and are not ported
yet (ROADMAP.md, Queue 1).
"""

from .cells import cell_count, cell_members, cell_of_endpoint, cell_of_slot
from .parent import (
    CellState,
    GlobalView,
    cell_leaders,
    compose_fingerprint,
    parent_configuration_id,
)

__all__ = [
    "CellState",
    "GlobalView",
    "cell_count",
    "cell_leaders",
    "cell_members",
    "cell_of_endpoint",
    "cell_of_slot",
    "compose_fingerprint",
    "parent_configuration_id",
]
