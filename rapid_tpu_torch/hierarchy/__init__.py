"""Hierarchy plane: two-level cell-based membership.

- :mod:`.cells`  -- deterministic cell assignment (topology zones when a
  :class:`~..sim.topology.LatencyTopology` is attached, rendezvous hash
  otherwise), shared by the simulator and the fault plane's cell rules.
- :mod:`.parent` -- leader election as a pure function of the cell's view,
  per-cell config-id epochs, and the composed global fingerprint.
- :mod:`.routing` -- cell-aware routing on the broadcaster seam (intra-cell
  alerts never leave the cell) and the leader's batched parent channel.
- :mod:`.plane` -- the per-node engine MembershipService drives at view
  installs and message dispatch.

``Settings.hierarchy.enabled`` is the kill switch: off (the default)
attaches nothing and reproduces the exact flat-path wire bytes.
"""

from .cells import cell_count, cell_members, cell_of_endpoint, cell_of_slot
from .parent import (
    CellState,
    GlobalView,
    cell_leaders,
    compose_fingerprint,
    parent_configuration_id,
)
from .plane import HierarchyPlane
from .routing import CellRouter, ParentChannel

__all__ = [
    "CellRouter",
    "CellState",
    "GlobalView",
    "HierarchyPlane",
    "ParentChannel",
    "cell_count",
    "cell_leaders",
    "cell_members",
    "cell_of_endpoint",
    "cell_of_slot",
    "compose_fingerprint",
    "parent_configuration_id",
]
