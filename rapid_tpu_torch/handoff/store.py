"""The partition-store seam between the handoff plane and the application.

The port of ``rapid_tpu/handoff/store.py``. The handoff plane never
interprets partition content -- it moves opaque bytes and verifies their
xxh64 fingerprint. :class:`InMemoryPartitionStore` is the reference
implementation the simulator's handoff and serving planes use.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Dict, Optional, Tuple

from ..runtime.lockdep import make_lock
from .plan import content_fingerprint


class PartitionStore(ABC):
    """Opaque per-partition byte storage keyed by partition id.

    Implementations must be safe to call from transport callback threads;
    ``fingerprint`` must equal ``content_fingerprint(partition, get(...))``
    for stored partitions, since replicas cross-check it over the wire."""

    @abstractmethod
    def get(self, partition: int) -> Optional[bytes]:
        """Full content of ``partition``, or None if not stored here."""

    @abstractmethod
    def put(self, partition: int, data: bytes) -> None:
        """Store (replacing) the full content of ``partition``."""

    @abstractmethod
    def delete(self, partition: int) -> None:
        """Drop ``partition`` if present (no-op otherwise)."""

    @abstractmethod
    def partitions(self) -> Tuple[int, ...]:
        """Sorted ids of every partition stored here."""

    def fingerprint(self, partition: int) -> Optional[int]:
        """Signed xxh64 of the partition's content (None if not stored)."""
        data = self.get(partition)
        if data is None:
            return None
        return content_fingerprint(partition, data)


class InMemoryPartitionStore(PartitionStore):
    """Reference store: a locked dict of partition id -> bytes, with the
    fingerprint maintained on write so status digests are O(partitions)
    lookups rather than O(bytes) rehashes."""

    def __init__(self) -> None:
        self._lock = make_lock("InMemoryPartitionStore._lock")
        self._data: Dict[int, bytes] = {}
        self._fingerprints: Dict[int, int] = {}

    def get(self, partition: int) -> Optional[bytes]:
        with self._lock:
            return self._data.get(partition)

    def put(self, partition: int, data: bytes,
            fingerprint: Optional[int] = None) -> None:
        """Store ``data``; ``fingerprint``, when the caller already holds
        ``content_fingerprint(partition, data)``, saves hashing it again."""
        fp = (content_fingerprint(partition, data) if fingerprint is None
              else fingerprint)
        with self._lock:
            self._data[partition] = bytes(data)
            self._fingerprints[partition] = fp

    def delete(self, partition: int) -> None:
        with self._lock:
            self._data.pop(partition, None)
            self._fingerprints.pop(partition, None)

    def partitions(self) -> Tuple[int, ...]:
        with self._lock:
            return tuple(sorted(self._data))

    def fingerprint(self, partition: int) -> Optional[int]:
        with self._lock:
            return self._fingerprints.get(partition)

    def sizes(self) -> Dict[int, int]:
        """Partition id -> content length (planner input)."""
        with self._lock:
            return {p: len(d) for p, d in self._data.items()}

    def digest(self) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """Parallel (partition ids, fingerprints) arrays, id-sorted -- the
        shape ClusterStatusResponse carries for cross-replica checks."""
        with self._lock:
            ids = tuple(sorted(self._data))
            return ids, tuple(self._fingerprints[p] for p in ids)
