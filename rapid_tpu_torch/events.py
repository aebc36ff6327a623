"""Cluster event subscriptions: the port's copy of ``rapid_tpu/events.py``.

Reference: ClusterEvents.java:19-24, NodeStatusChange.java:24-52. Callbacks
receive (configuration_id, [NodeStatusChange]). The placement plane's
``PlacementSubscriber`` and the serving plane's ``RendezvousRouter`` consume
them.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Tuple

from .types import EdgeStatus, Endpoint


class ClusterEvents(enum.Enum):
    VIEW_CHANGE_PROPOSAL = "VIEW_CHANGE_PROPOSAL"
    VIEW_CHANGE = "VIEW_CHANGE"
    VIEW_CHANGE_ONE_STEP_FAILED = "VIEW_CHANGE_ONE_STEP_FAILED"
    KICKED = "KICKED"


@dataclass(frozen=True)
class NodeStatusChange:
    endpoint: Endpoint
    status: EdgeStatus
    metadata: Tuple[Tuple[str, bytes], ...] = ()

    def __str__(self) -> str:
        return f"{self.endpoint}:{self.status.name}:{dict(self.metadata)}"
