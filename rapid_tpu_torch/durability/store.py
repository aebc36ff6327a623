"""Durable :class:`PartitionStore`: WAL-over-snapshot crash recovery.

The port's own copy of ``rapid_tpu/durability/store.py``.

:class:`DurablePartitionStore` mirrors the in-memory reference store's
surface exactly (the handoff engine, placement planner, and statusz all
duck-type against it), but every mutation is appended to a per-node
write-ahead log before it lands in memory, and checkpoints serialize the
partition blobs -- the same xxh64-fingerprinted bytes handoff verifies
over the wire -- into an atomically renamed snapshot file. Recovery loads
the newest complete snapshot and replays the log from its marker, so a
restarted node resumes with exactly the state it acknowledged, and the
handoff fingerprint cross-check against its replica row comes for free.

The store also persists the node's membership identity (NodeId + last
installed configuration id) as META records: Rapid's strongly consistent
view makes identity-preserving rejoin safe, but only if the identity
actually survives the process.
"""

from __future__ import annotations

import os
import struct
import time
from typing import Callable, Dict, Optional, Tuple

from ..handoff.plan import content_fingerprint
from ..handoff.store import PartitionStore
from ..runtime.lockdep import make_lock
from ..types import NodeId
from . import wal as _wal

_NODE_ID = struct.Struct("<qq")
_CONFIG_ID = struct.Struct("<q")

_SNAP_PREFIX = "snap-"
_SNAP_SUFFIX = ".bin"

META_NODE_ID = "node_id"
META_CONFIG_ID = "config_id"
META_INCARNATION = "incarnation"


class DurablePartitionStore(PartitionStore):
    """Write-ahead-logged partition store with snapshot checkpoints.

    Construction *is* recovery: the newest complete snapshot is loaded,
    the log's torn tail (if any) is truncated at the first bad record, and
    surviving records after the snapshot marker are replayed into memory.
    """

    def __init__(self, directory: str, *, segment_bytes: int = 1 << 20,
                 fsync_policy: int = _wal.FSYNC_BATCH,
                 snapshot_every_records: int = 4096,
                 fsync_hook: Optional[Callable[[], None]] = None) -> None:
        self._lock = make_lock("DurablePartitionStore._lock")
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.snapshot_every_records = int(snapshot_every_records)
        self._data: Dict[int, bytes] = {}
        self._fingerprints: Dict[int, int] = {}
        self._meta: Dict[str, bytes] = {}
        self._crashed = False
        self._metrics = None
        self._recorder = None
        self._fsyncs_reported = 0
        self._records_since_snapshot = 0
        self._snapshot_version = 0
        self._replayed_records = 0
        self._recovery_ms = 0.0
        started = time.monotonic()
        snap_version, snap_data, snap_meta = self._load_newest_snapshot()
        self._wal = _wal.WriteAheadLog(
            directory, segment_bytes=segment_bytes, fsync_policy=fsync_policy,
            fsync_hook=fsync_hook,
        )
        self._recover(snap_version, snap_data, snap_meta)
        self._recovery_ms = (time.monotonic() - started) * 1000.0

    # -- recovery -------------------------------------------------------------

    def _snap_path(self, version: int) -> str:
        return os.path.join(
            self.directory, f"{_SNAP_PREFIX}{version:016d}{_SNAP_SUFFIX}"
        )

    def _snapshot_versions(self) -> Tuple[int, ...]:
        versions = []
        for name in os.listdir(self.directory):
            if name.startswith(_SNAP_PREFIX) and name.endswith(_SNAP_SUFFIX):
                try:
                    versions.append(int(name[len(_SNAP_PREFIX):-len(_SNAP_SUFFIX)]))
                except ValueError:
                    continue
        return tuple(sorted(versions))

    def _load_newest_snapshot(self):
        """Newest snapshot with a completeness witness; torn snapshot files
        read as absent, never as an empty store."""
        for version in reversed(self._snapshot_versions()):
            loaded = _wal.load_snapshot(self._snap_path(version))
            if loaded is not None:
                return version, loaded[0], loaded[1]
        return 0, {}, {}

    def _recover(self, snap_version: int, snap_data: Dict[int, bytes],
                 snap_meta: Dict[str, bytes]) -> None:
        for partition, data in snap_data.items():
            self._data[partition] = data
            self._fingerprints[partition] = content_fingerprint(partition, data)
        self._meta.update(snap_meta)
        self._snapshot_version = snap_version
        records = self._wal.recovered_records()
        # log-over-snapshot: skip records up to (and including) the marker
        # matching the loaded snapshot, replay everything after it. If the
        # marker is missing (retention raced a crash), replay the whole
        # retained log -- PUT records carry full content, so re-applying
        # pre-snapshot records is harmless, merely slower.
        start = 0
        if snap_version:
            for index, (_seq, payload) in enumerate(records):
                decoded = _wal.parse_record(payload)
                if decoded and decoded[0] == _wal.KIND_SNAPSHOT \
                        and decoded[1][0] == snap_version:
                    start = index + 1
                    break
        for _seq, payload in records[start:]:
            decoded = _wal.parse_record(payload)
            if decoded is None:
                continue  # unknown kind from a newer writer: skip, not fatal
            kind, args = decoded
            if kind == _wal.KIND_PUT:
                partition, data = args
                self._data[partition] = data
                self._fingerprints[partition] = content_fingerprint(
                    partition, data
                )
            elif kind == _wal.KIND_DELETE:
                self._data.pop(args[0], None)
                self._fingerprints.pop(args[0], None)
            elif kind == _wal.KIND_META:
                self._meta[args[0]] = args[1]
            elif kind == _wal.KIND_SNAPSHOT:
                continue  # stale marker inside the replay range
            self._replayed_records += 1
        self._records_since_snapshot = self._replayed_records

    # -- telemetry ------------------------------------------------------------

    def bind_telemetry(self, metrics, recorder=None) -> None:
        """Attach the node's metrics registry / flight recorder. Called
        after construction (the service owns both), so recovery's counters
        are emitted retroactively here."""
        self._metrics = metrics
        self._recorder = recorder
        if metrics is not None:
            if self._replayed_records:
                metrics.incr(
                    "durability.replayed_records", self._replayed_records
                )
            if self._wal.torn_truncations:
                metrics.incr(
                    "durability.torn_truncations", self._wal.torn_truncations
                )
            metrics.set_gauge(
                "durability.segments", float(len(self._wal.segment_seqs()))
            )
        if recorder is not None:
            recorder.record(
                "durability_recovered",
                snapshot_version=self._snapshot_version,
                replayed_records=self._replayed_records,
                torn_truncations=self._wal.torn_truncations,
                partitions=len(self._data),
            )

    def _note_io(self) -> None:
        """Fold the WAL's internal fsync counter into the metric stream."""
        if self._metrics is None:
            return
        delta = self._wal.fsyncs - self._fsyncs_reported
        if delta:
            self._metrics.incr("durability.fsyncs", delta)
            self._fsyncs_reported = self._wal.fsyncs

    # -- PartitionStore surface ----------------------------------------------

    def get(self, partition: int) -> Optional[bytes]:
        with self._lock:
            return self._data.get(partition)

    def put(self, partition: int, data: bytes) -> None:
        data = bytes(data)
        fp = content_fingerprint(partition, data)
        with self._lock:
            if self._crashed:
                return
            self._wal.append(_wal.put_record(partition, data))
            self._data[partition] = data
            self._fingerprints[partition] = fp
            self._bump_locked()
        if self._metrics is not None:
            self._metrics.incr("durability.appends")
            self._note_io()

    def delete(self, partition: int) -> None:
        with self._lock:
            if self._crashed:
                return
            if partition not in self._data:
                return
            self._wal.append(_wal.delete_record(partition))
            self._data.pop(partition, None)
            self._fingerprints.pop(partition, None)
            self._bump_locked()
        if self._metrics is not None:
            self._metrics.incr("durability.appends")
            self._note_io()

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

    # -- identity persistence -------------------------------------------------

    def set_identity(self, node_id: NodeId) -> None:
        self._set_meta(META_NODE_ID, _NODE_ID.pack(node_id.high, node_id.low))

    @property
    def node_id(self) -> Optional[NodeId]:
        raw = self._meta.get(META_NODE_ID)
        if raw is None or len(raw) != _NODE_ID.size:
            return None
        high, low = _NODE_ID.unpack(raw)
        return NodeId(high, low)

    def set_config_id(self, config_id: int) -> None:
        self._set_meta(META_CONFIG_ID, _CONFIG_ID.pack(config_id))

    @property
    def incarnation(self) -> int:
        """Boot count persisted in the WAL meta (0 before the first
        ``bump_incarnation``). The forensics HLC stamps it so a restarted
        member's fresh clock is never mistaken for a regression of its
        previous life (the incarnation-seq discipline)."""
        raw = self._meta.get(META_INCARNATION)
        if raw is None or len(raw) != _CONFIG_ID.size:
            return 0
        return int(_CONFIG_ID.unpack(raw)[0])

    def bump_incarnation(self) -> int:
        """Advance and persist the boot count; returns the new value."""
        nxt = self.incarnation + 1
        self._set_meta(META_INCARNATION, _CONFIG_ID.pack(nxt))
        return nxt

    @property
    def config_id(self) -> Optional[int]:
        raw = self._meta.get(META_CONFIG_ID)
        if raw is None or len(raw) != _CONFIG_ID.size:
            return None
        return _CONFIG_ID.unpack(raw)[0]

    def _set_meta(self, key: str, value: bytes) -> None:
        with self._lock:
            if self._crashed:
                return
            if self._meta.get(key) == value:
                return
            self._wal.append(_wal.meta_record(key, value))
            self._meta[key] = value
            # identity records must never outrun the ack that carries them:
            # the join/view path reads them back on the next boot
            self._wal.sync()
        self._note_io()

    # -- durability control plane ---------------------------------------------

    def _bump_locked(self) -> None:
        self._records_since_snapshot += 1
        if (
            self.snapshot_every_records > 0
            and self._records_since_snapshot >= self.snapshot_every_records
        ):
            self._checkpoint_locked()

    def sync(self) -> None:
        """Durability barrier: every accepted mutation survives a crash."""
        with self._lock:
            if self._crashed:
                return
            self._wal.sync()
        self._note_io()

    def checkpoint(self) -> None:
        """Snapshot + marker + retention: a graceful stop leaves a log that
        recovers with zero replayed records."""
        with self._lock:
            if self._crashed:
                return
            self._checkpoint_locked()
        self._note_io()

    def _checkpoint_locked(self) -> None:
        version = self._snapshot_version = self._next_version_locked()
        _wal.write_snapshot(
            self._snap_path(version), dict(self._data), dict(self._meta)
        )
        self._wal.mark_snapshot(version)
        for old in self._snapshot_versions():
            if old < version:
                os.remove(self._snap_path(old))
        self._records_since_snapshot = 0
        if self._metrics is not None:
            self._metrics.incr("durability.snapshots")
            self._metrics.set_gauge(
                "durability.segments", float(len(self._wal.segment_seqs()))
            )
        if self._recorder is not None:
            self._recorder.record(
                "durability_checkpoint", snapshot_version=version,
                partitions=len(self._data),
            )

    def _next_version_locked(self) -> int:
        versions = self._snapshot_versions()
        return max(versions[-1] if versions else 0, self._snapshot_version) + 1

    def close(self) -> None:
        with self._lock:
            if not self._crashed:
                self._wal.close()
                self._crashed = True

    def crash(self) -> None:
        """Simulate process death: close handles without any barrier and
        refuse all further mutation, so a harness's graceful ``shutdown``
        path cannot quietly rescue state the crash should have stranded."""
        with self._lock:
            self._wal.crash()
            self._crashed = True

    # -- introspection ---------------------------------------------------------

    def durability_stats(self) -> Dict[str, int]:
        """The status-RPC digest: segment count, last snapshot version, and
        how many log records the last recovery replayed."""
        with self._lock:
            return {
                "segments": len(self._wal.segment_seqs()),
                "snapshot_version": self._snapshot_version,
                "replayed_records": self._replayed_records,
                "appends": self._wal.appends,
                "fsyncs": self._wal.fsyncs,
                "torn_truncations": self._wal.torn_truncations,
                "recovery_ms": self._recovery_ms,
            }
