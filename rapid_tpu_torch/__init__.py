"""PyTorch/CUDA port of rapid-tpu.

Mirrors the layout of ``rapid_tpu`` so each module's counterpart is found by
name. Two planes, as there:

- the *protocol plane* (this package root): ``Cluster`` / ``ClusterBuilder``,
  ``MembershipService``, K-ring views, cut detection, Fast and classic Paxos,
  the failure detectors and the in-process, unicast, gossip and TCP
  messaging, in pure Python (no torch on this path);
- the *simulation plane* (``sim``, ``shard``): the same protocol as tensor
  programs over up to millions of virtual members on a CUDA device, with the
  hand-written CUDA kernels of ``csrc/`` bound by ``sim.kernels``.

Imports torch and numpy only: nothing of JAX and nothing of ``rapid_tpu``.
The root exports every name of ``rapid_tpu.__all__``.
"""

from .cluster import Cluster, ClusterBuilder, JoinException, K, H, L
from .events import ClusterEvents, NodeStatusChange
from .membership import Configuration, MembershipView
from .cut_detector import MultiNodeCutDetector
from .handoff import (
    InMemoryPartitionStore,
    PartitionStore,
    TransferPlan,
    plan_transfers,
)
from .placement.engine import (
    PlacementConfig,
    PlacementDiff,
    PlacementMap,
    PlacementSubscriber,
)
from .settings import Settings
from .types import (
    EdgeStatus,
    Endpoint,
    JoinStatusCode,
    NodeId,
    NodeStatus,
)

__all__ = [
    "Cluster",
    "ClusterBuilder",
    "ClusterEvents",
    "Configuration",
    "EdgeStatus",
    "Endpoint",
    "InMemoryPartitionStore",
    "JoinException",
    "JoinStatusCode",
    "MembershipView",
    "MultiNodeCutDetector",
    "NodeId",
    "NodeStatus",
    "NodeStatusChange",
    "PartitionStore",
    "PlacementConfig",
    "PlacementDiff",
    "PlacementMap",
    "PlacementSubscriber",
    "Settings",
    "TransferPlan",
    "plan_transfers",
    "K",
    "H",
    "L",
]
