"""Pure transfer planning: PlacementDiff semantics -> per-partition sessions.

The port of ``rapid_tpu/handoff/plan.py``. Everything here is a
deterministic function of two placement maps plus the partition sizes, with
no I/O. The vectorized mirror in ``handoff/device.py`` reproduces these
plans from the device plane's assignment arrays.

Source-selection rule (mirrors ``engine.diff_maps`` pairing): for each moved
partition, departing old replicas (donors) are paired positionally with the
arriving new replicas (recipients); a recipient beyond the donor list pulls
from the partition's first surviving replica. The session's failover chain
is the paired donor (if it is still a member of the new map -- a crashed
donor is gone from the view and pointless to dial) followed by every
surviving replica in old-row order.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Tuple

from ..hashing import to_signed, xxh64
from ..placement.engine import PlacementMap, node_key64
from ..types import Endpoint

_MASK64 = (1 << 64) - 1

__all__ = [
    "TransferPlan",
    "chunk_spans",
    "content_fingerprint",
    "plan_transfers",
    "session_key",
]


def content_fingerprint(partition: int, data: bytes) -> int:
    """Signed xxh64 of a partition's content, seeded by the partition id so
    identical bytes in different partitions fingerprint differently."""
    return to_signed(xxh64(data, partition & 0x7FFFFFFF))


def session_key(new_version: int, partition: int, recipient_key64: int,
                seed: int) -> int:
    """Deterministic session id: signed xxh64 over (new map version,
    partition, recipient node key). Every member -- and the device plane --
    derives the same id without coordination, which is what makes duplicate
    session launches and duplicate chunk deliveries idempotent."""
    blob = struct.pack(
        "<QQQ", new_version & _MASK64, partition & _MASK64,
        recipient_key64 & _MASK64,
    )
    return to_signed(xxh64(blob, seed))


def chunk_spans(size: int, chunk_size: int) -> Tuple[Tuple[int, int], ...]:
    """The (offset, length) schedule for a partition of ``size`` bytes.
    Empty content needs no chunks -- the session completes on the first
    (metadata-only) chunk reply."""
    if chunk_size <= 0:
        raise ValueError(f"chunk_size must be positive: {chunk_size}")
    return tuple(
        (offset, min(chunk_size, size - offset))
        for offset in range(0, size, chunk_size)
    )


@dataclass(frozen=True)
class TransferPlan:
    """One partition's planned movement to one new replica.

    ``sources`` is the failover chain in preference order; ``chunks`` the
    (offset, length) pull schedule for the planned ``size`` (the live engine
    re-derives it from the source-reported size, same arithmetic)."""

    partition: int
    recipient: Endpoint
    sources: Tuple[Endpoint, ...]
    size: int
    chunks: Tuple[Tuple[int, int], ...]
    session_id: int


def plan_transfers(
    old_map: PlacementMap,
    new_map: PlacementMap,
    sizes: Optional[Mapping[int, int]] = None,
    chunk_size: int = 1 << 16,
) -> Tuple[TransferPlan, ...]:
    """Every transfer implied by the old->new map change, in (partition,
    new-row recipient order). Must stay in lockstep with
    ``placement.engine.diff_maps`` -- same moved set, same donor/recipient
    pairing -- and with ``handoff.device.device_transfer_plans``."""
    if old_map.config != new_map.config:
        raise ValueError("cannot plan across different placement configs")
    sizes = sizes if sizes is not None else {}
    members = set(new_map.members)
    seed = new_map.config.seed
    key_cache: Dict[Endpoint, int] = {}
    plans: List[TransferPlan] = []
    for p, (old_row, new_row) in enumerate(
        zip(old_map.assignments, new_map.assignments)
    ):
        if old_row == new_row:
            continue
        donors = [node for node in old_row if node not in new_row]
        recipients = [node for node in new_row if node not in old_row]
        survivors = [node for node in old_row if node in new_row]
        for i, recipient in enumerate(recipients):
            donor: Optional[Endpoint] = (
                donors[i] if i < len(donors)
                else (survivors[0] if survivors else None)
            )
            sources: List[Endpoint] = []
            if donor is not None and donor in members:
                sources.append(donor)
            for node in survivors:
                if node not in sources:
                    sources.append(node)
            size = int(sizes.get(p, 0))
            rkey = key_cache.get(recipient)
            if rkey is None:
                rkey = key_cache[recipient] = node_key64(recipient, seed)
            plans.append(TransferPlan(
                partition=p,
                recipient=recipient,
                sources=tuple(sources),
                size=size,
                chunks=chunk_spans(size, chunk_size),
                session_id=session_key(new_map.version, p, rkey, seed),
            ))
    return tuple(plans)
