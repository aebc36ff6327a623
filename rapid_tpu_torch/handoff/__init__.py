"""Handoff plane: partition state transfer driven by placement diffs.

``store.py`` is the application seam (:class:`PartitionStore`), ``plan.py``
the pure object-plane planner, ``device.py`` its vectorized mirror over the
simulator's assignment arrays. The live session machinery
(``rapid_tpu/handoff/engine.py``) serves the protocol plane and is not
ported yet (ROADMAP.md, Queue 1).
"""

from .plan import TransferPlan, chunk_spans, content_fingerprint, plan_transfers, session_key
from .store import InMemoryPartitionStore, PartitionStore

__all__ = [
    "InMemoryPartitionStore",
    "PartitionStore",
    "TransferPlan",
    "chunk_spans",
    "content_fingerprint",
    "plan_transfers",
    "session_key",
]
