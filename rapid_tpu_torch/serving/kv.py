"""Key space and on-store format of the serving plane: the port of
``rapid_tpu/serving/kv.py``.

The serving plane stores a replicated key/value map *inside* the handoff
plane's :class:`~..handoff.store.PartitionStore`: every partition's live
keys are serialized to one deterministic blob, so the view-change state
transfer that already moves and fingerprint-verifies partition bytes moves
the KV data for free, and replicas holding the same keys at the same
versions agree byte for byte on the store fingerprint.

``encode_kv`` sorts keys and fixes the encoding: the bytes of
``msgpack.packb(..., use_bin_type=True)``, written by the port's own
MessagePack subset (``messaging/msgpack_wire.py``), since the card's
machine has no msgpack.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from ..hashing import xxh64
from ..messaging.msgpack_wire import packb, unpackb

# Fixed hash seed for key -> partition routing. Distinct from placement's
# rendezvous seeds (which hash partitions onto members); every client and
# every member must agree on it or keys route to different leaders.
SERVING_SEED = 0x5E41


def partition_of(key: bytes, partitions: int) -> int:
    """The partition a key lives in: xxh64 under the fixed serving seed.

    Pure function of (key, partition count), so clients route without any
    metadata beyond the placement map's partition count."""
    if partitions <= 0:
        raise ValueError(f"partitions must be positive: {partitions}")
    return xxh64(key, SERVING_SEED) % partitions


def encode_kv(kv: Dict[bytes, Tuple[int, bytes]]) -> bytes:
    """Serialize one partition's ``key -> (version, value)`` map.

    Sorted by key with a canonical MessagePack encoding (keys and values as
    bin): replicas holding the same logical content emit identical bytes."""
    return packb(
        [[key, version, value] for key, (version, value) in sorted(kv.items())]
    )


def decode_kv(blob: Optional[bytes]) -> Dict[bytes, Tuple[int, bytes]]:
    """Inverse of :func:`encode_kv`; ``None``/empty decodes to an empty map
    (a partition nobody has written to has no blob in the store yet)."""
    if not blob:
        return {}
    return {
        bytes(key): (int(version), bytes(value))
        for key, version, value in unpackb(blob)
    }
