"""Durability plane: per-node write-ahead log + snapshot crash recovery.

The port's own copy of ``rapid_tpu/durability/``. Mounted under the
handoff :class:`~rapid_tpu_torch.handoff.store.PartitionStore` seam, so the serving/handoff planes gain durability without learning any
new interface: :class:`DurablePartitionStore` is a drop-in for the
in-memory reference store whose mutations survive the process.
"""

from .store import DurablePartitionStore
from .wal import (
    FSYNC_ALWAYS,
    FSYNC_BATCH,
    FSYNC_NEVER,
    WriteAheadLog,
    tear_wal_tail,
)

__all__ = [
    "DurablePartitionStore",
    "WriteAheadLog",
    "tear_wal_tail",
    "FSYNC_NEVER",
    "FSYNC_BATCH",
    "FSYNC_ALWAYS",
]
