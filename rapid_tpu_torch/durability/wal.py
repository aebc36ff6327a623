"""Append-only write-ahead log: fsync'd segments with CRC'd length framing.

The port's own copy of ``rapid_tpu/durability/wal.py``. The on-disk format
is the JAX package's byte for byte: a directory either package writes
opens in the other to the same content.

Every record is ``[u32 length][u32 crc32][payload]`` (little-endian), the
same self-describing discipline as the wire schema: a reader that trusts
the frame never trusts the bytes inside it, and a payload whose first byte
names an unknown record kind is skipped rather than fatal, so old replayers
tolerate frames appended by newer writers. A torn tail -- a short header, a
short payload, or a CRC mismatch from a crash mid-append -- truncates the
log at the first bad record: everything before it was durable, everything
after it was never acknowledged.

Segments are ``wal-<seq>.log`` files rotated at a size threshold; rotation
happens immediately *before* a snapshot marker is appended, so the marker
is always the first record of its segment and retention can simply delete
every segment numbered below it.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Callable, Dict, List, Optional, Tuple

_HEADER = struct.Struct("<II")  # payload length, crc32(payload)
_PART = struct.Struct("<I")
_VERSION = struct.Struct("<q")
_KEYLEN = struct.Struct("<H")

# Record kinds (first payload byte). Unknown kinds are skipped on replay --
# the old-frame-tolerance seam mirroring the codec's "__"-key stripping.
KIND_PUT = 1  # u32 partition + content bytes (full replacement)
KIND_DELETE = 2  # u32 partition
KIND_SNAPSHOT = 3  # i64 snapshot version (marker: state below is on disk)
KIND_META = 4  # u16 key length + utf-8 key + value bytes

# fsync policies (int-coded so the settings catalog can bound them)
FSYNC_NEVER = 0  # leave durability to the OS page cache
FSYNC_BATCH = 1  # fsync on explicit sync()/checkpoint barriers
FSYNC_ALWAYS = 2  # fsync after every append

_SEGMENT_PREFIX = "wal-"
_SEGMENT_SUFFIX = ".log"


def frame(payload: bytes) -> bytes:
    """Wrap ``payload`` in the length+CRC header."""
    return _HEADER.pack(len(payload), zlib.crc32(payload) & 0xFFFFFFFF) + payload


def iter_frames(blob: bytes):
    """Yield ``(payload, end_offset)`` for every intact frame in ``blob``.

    Stops at the first short or corrupt frame; the last yielded
    ``end_offset`` is the byte length of the trustworthy prefix.
    """
    offset = 0
    total = len(blob)
    while offset + _HEADER.size <= total:
        length, crc = _HEADER.unpack_from(blob, offset)
        start = offset + _HEADER.size
        end = start + length
        if end > total:
            return  # short payload: torn mid-append
        payload = blob[start:end]
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            return  # corrupt record: torn or bit-flipped
        yield payload, end
        offset = end


def put_record(partition: int, data: bytes) -> bytes:
    return bytes([KIND_PUT]) + _PART.pack(partition) + data


def delete_record(partition: int) -> bytes:
    return bytes([KIND_DELETE]) + _PART.pack(partition)


def snapshot_record(version: int) -> bytes:
    return bytes([KIND_SNAPSHOT]) + _VERSION.pack(version)


def meta_record(key: str, value: bytes) -> bytes:
    encoded = key.encode("utf-8")
    return bytes([KIND_META]) + _KEYLEN.pack(len(encoded)) + encoded + value


def parse_record(payload: bytes) -> Optional[Tuple[int, tuple]]:
    """Decode one record payload to ``(kind, args)``; None for unknown or
    malformed kinds (skipped on replay, never fatal)."""
    if not payload:
        return None
    kind = payload[0]
    body = payload[1:]
    try:
        if kind == KIND_PUT:
            (partition,) = _PART.unpack_from(body)
            return kind, (partition, body[_PART.size:])
        if kind == KIND_DELETE:
            (partition,) = _PART.unpack_from(body)
            return kind, (partition,)
        if kind == KIND_SNAPSHOT:
            (version,) = _VERSION.unpack_from(body)
            return kind, (version,)
        if kind == KIND_META:
            (key_len,) = _KEYLEN.unpack_from(body)
            key = body[_KEYLEN.size:_KEYLEN.size + key_len].decode("utf-8")
            return kind, (key, body[_KEYLEN.size + key_len:])
    except (struct.error, UnicodeDecodeError):
        return None
    return None  # unknown kind: a newer writer's record, skip it


class WriteAheadLog:
    """Segmented append-only log under one directory.

    Construction scans existing segments in order, truncates the torn tail
    (if any) at the first bad record, and exposes the surviving payloads as
    :meth:`recovered_records`; the handle then reopens the last segment for
    appending so the log continues where the previous process stopped.
    """

    def __init__(self, directory: str, *, segment_bytes: int = 1 << 20,
                 fsync_policy: int = FSYNC_BATCH,
                 fsync_hook: Optional[Callable[[], None]] = None) -> None:
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.segment_bytes = max(int(segment_bytes), _HEADER.size + 1)
        self.fsync_policy = int(fsync_policy)
        # test/bench seam for disk_stall fault injection: called before every
        # physical fsync so the harness can bill or sleep the stall
        self.fsync_hook = fsync_hook
        self.appends = 0
        self.fsyncs = 0
        self.torn_truncations = 0
        self._dirty = False
        self._records: List[Tuple[int, bytes]] = []
        self._scan_and_truncate()
        seqs = self.segment_seqs()
        self._seq = seqs[-1] if seqs else 0
        path = self._path(self._seq)
        self._fh = open(path, "ab", buffering=0)
        self._size = os.path.getsize(path)

    # -- layout ---------------------------------------------------------------

    def _path(self, seq: int) -> str:
        return os.path.join(
            self.directory, f"{_SEGMENT_PREFIX}{seq:08d}{_SEGMENT_SUFFIX}"
        )

    def segment_seqs(self) -> List[int]:
        seqs = []
        for name in os.listdir(self.directory):
            if name.startswith(_SEGMENT_PREFIX) and name.endswith(_SEGMENT_SUFFIX):
                try:
                    seqs.append(int(name[len(_SEGMENT_PREFIX):-len(_SEGMENT_SUFFIX)]))
                except ValueError:
                    continue
        return sorted(seqs)

    # -- recovery -------------------------------------------------------------

    def _scan_and_truncate(self) -> None:
        """Collect every intact record across segments in seq order; the
        first torn record truncates its file and discards all later
        segments (a tear is only ever at the active tail)."""
        seqs = self.segment_seqs()
        for index, seq in enumerate(seqs):
            path = self._path(seq)
            with open(path, "rb") as fh:
                blob = fh.read()
            good = 0
            for payload, end in iter_frames(blob):
                self._records.append((seq, payload))
                good = end
            if good < len(blob):
                self.torn_truncations += 1
                with open(path, "r+b") as fh:
                    fh.truncate(good)
                for later in seqs[index + 1:]:
                    os.remove(self._path(later))
                return

    def recovered_records(self) -> List[Tuple[int, bytes]]:
        """``(segment seq, payload)`` for every record that survived the
        tail truncation, in append order."""
        return list(self._records)

    # -- append path ----------------------------------------------------------

    def append(self, payload: bytes) -> None:
        record = frame(payload)
        if self._size and self._size + len(record) > self.segment_bytes:
            self.rotate()
        self._fh.write(record)
        self._size += len(record)
        self.appends += 1
        if self.fsync_policy >= FSYNC_ALWAYS:
            self._fsync()
        else:
            self._dirty = True

    def _fsync(self) -> None:
        if self.fsync_hook is not None:
            self.fsync_hook()
        if self.fsync_policy > FSYNC_NEVER:
            os.fsync(self._fh.fileno())
            self.fsyncs += 1
        self._dirty = False

    def sync(self) -> None:
        """Durability barrier: everything appended so far survives a crash
        (no-op under FSYNC_NEVER beyond the OS page cache)."""
        if self._dirty:
            self._fsync()

    def rotate(self) -> int:
        """Close the active segment and open the next one; returns the new
        segment's seq."""
        self.sync()
        self._fh.close()
        self._seq += 1
        self._fh = open(self._path(self._seq), "ab", buffering=0)
        self._size = 0
        return self._seq

    def mark_snapshot(self, version: int) -> int:
        """Rotate, then write the snapshot marker as the *first* record of
        the fresh segment (always fsync'd -- the marker gates retention),
        then delete every segment below it. Returns the marker's seq."""
        seq = self.rotate()
        self._fh.write(frame(snapshot_record(version)))
        self._size += _HEADER.size + 1 + _VERSION.size
        self.appends += 1
        if self.fsync_hook is not None:
            self.fsync_hook()
        os.fsync(self._fh.fileno())
        self.fsyncs += 1
        self._dirty = False
        for old in self.segment_seqs():
            if old < seq:
                os.remove(self._path(old))
        return seq

    def close(self) -> None:
        if self._fh is not None and not self._fh.closed:
            self.sync()
            self._fh.close()

    def crash(self) -> None:
        """Abrupt close: no barrier, whatever the OS buffered is whatever
        survives -- the test seam for process-death simulation."""
        if self._fh is not None and not self._fh.closed:
            self._fh.close()


def tear_wal_tail(directory: str, drop_bytes: int = 3,
                  corrupt: bool = False) -> Optional[int]:
    """Damage the last WAL segment in ``directory``: truncate ``drop_bytes``
    off its end, or (``corrupt=True``) flip a byte inside its final record
    so the CRC fails. Returns the damaged segment's seq, or None if there
    was nothing to tear. Test/nemesis helper for the ``torn_write`` family.
    """
    seqs = []
    for name in os.listdir(directory):
        if name.startswith(_SEGMENT_PREFIX) and name.endswith(_SEGMENT_SUFFIX):
            seqs.append(int(name[len(_SEGMENT_PREFIX):-len(_SEGMENT_SUFFIX)]))
    for seq in sorted(seqs, reverse=True):
        path = os.path.join(
            directory, f"{_SEGMENT_PREFIX}{seq:08d}{_SEGMENT_SUFFIX}"
        )
        size = os.path.getsize(path)
        if size == 0:
            continue
        if corrupt:
            with open(path, "r+b") as fh:
                fh.seek(size - 1)
                last = fh.read(1)
                fh.seek(size - 1)
                fh.write(bytes([last[0] ^ 0xFF]))
        else:
            with open(path, "r+b") as fh:
                fh.truncate(max(0, size - drop_bytes))
        return seq
    return None


def load_snapshot(path: str) -> Optional[Tuple[Dict[int, bytes], Dict[str, bytes]]]:
    """Parse a snapshot file written by :func:`write_snapshot`.

    Returns ``(partition data, meta)`` or None when the file is torn or
    missing its completeness witness (an interrupted snapshot write that
    never got renamed into place should be impossible, but a truncated one
    must read as absent, not as an empty store).
    """
    try:
        with open(path, "rb") as fh:
            blob = fh.read()
    except OSError:
        return None
    data: Dict[int, bytes] = {}
    meta: Dict[str, bytes] = {}
    complete = False
    good = 0
    for payload, end in iter_frames(blob):
        good = end
        decoded = parse_record(payload)
        if decoded is None:
            continue
        kind, args = decoded
        if kind == KIND_PUT:
            data[args[0]] = args[1]
        elif kind == KIND_META:
            if args[0] == "complete":
                complete = True
            else:
                meta[args[0]] = args[1]
    if not complete or good < len(blob):
        return None
    return data, meta


def write_snapshot(path: str, data: Dict[int, bytes],
                   meta: Dict[str, bytes]) -> None:
    """Write a snapshot atomically: framed PUT records, framed META records,
    and a terminal ``complete`` witness, to a temp file renamed into place.
    """
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        for partition in sorted(data):
            fh.write(frame(put_record(partition, data[partition])))
        for key in sorted(meta):
            fh.write(frame(meta_record(key, meta[key])))
        fh.write(frame(meta_record("complete", b"")))
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
