"""Handoff plane: partition state transfer driven by placement diffs.

The port's own copy of ``rapid_tpu/handoff/``. ``store.py`` is the
application seam (:class:`PartitionStore`), ``plan.py`` the pure
object-plane planner, ``device.py`` its vectorized mirror over the
simulator's assignment arrays, and ``engine.py`` the live session machinery
wired into service.py via ``ClusterBuilder.use_handoff``.
"""

from .engine import DEFAULT_CHUNK_SIZE, HandoffEngine
from .plan import TransferPlan, chunk_spans, content_fingerprint, plan_transfers, session_key
from .store import InMemoryPartitionStore, PartitionStore

__all__ = [
    "DEFAULT_CHUNK_SIZE",
    "HandoffEngine",
    "InMemoryPartitionStore",
    "PartitionStore",
    "TransferPlan",
    "chunk_spans",
    "content_fingerprint",
    "plan_transfers",
    "session_key",
]
