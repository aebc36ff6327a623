"""Vectorized transfer planning: the device-plane mirror of handoff/plan.py.

The port of ``rapid_tpu/handoff/device.py``: it plans transfers from the
device plane's ``[P, R]`` assignment arrays (host copies, fetched once a
view change by ``placement.device``), and lands on the same output as
``plan.plan_transfers`` for the same inputs. The moved-row mask, the
row-wise old/new membership masks and the batched session-id hashes are
numpy over the whole map at once; only the per-moved-row donor/recipient
pairing walks Python, exactly like the engine's own diff loop walks only
moved partitions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ..hashing import xxh64_batch_auto
from .plan import chunk_spans

__all__ = ["DeviceTransferPlan", "device_transfer_plans", "session_keys_batch"]

_MASK64 = (1 << 64) - 1


@dataclass(frozen=True)
class DeviceTransferPlan:
    """Slot-index form of :class:`~.plan.TransferPlan`: ``recipient`` and
    ``sources`` are candidate-slot indices into the device placement's
    universe instead of endpoints."""

    partition: int
    recipient: int
    sources: Tuple[int, ...]
    size: int
    chunks: Tuple[Tuple[int, int], ...]
    session_id: int


def session_keys_batch(
    new_version: int,
    partitions: np.ndarray,
    recipient_keys64: np.ndarray,
    seed: int,
) -> np.ndarray:
    """plan.session_key for many (partition, recipient) pairs at once:
    batched xxh64 over the packed 24-byte ``<QQQ`` blobs. Returns signed
    int64, bit-identical to the scalar path."""
    n = int(partitions.shape[0])
    blob = np.zeros((n, 24), dtype=np.uint8)
    version = np.full(n, new_version & _MASK64, dtype=np.uint64)
    shifts = (8 * np.arange(8, dtype=np.uint64))[None, :]
    blob[:, 0:8] = ((version[:, None] >> shifts) & np.uint64(0xFF)).astype(np.uint8)
    parts = partitions.astype(np.uint64)
    blob[:, 8:16] = ((parts[:, None] >> shifts) & np.uint64(0xFF)).astype(np.uint8)
    keys = recipient_keys64.astype(np.uint64)
    blob[:, 16:24] = ((keys[:, None] >> shifts) & np.uint64(0xFF)).astype(np.uint8)
    lengths = np.full(n, 24, dtype=np.int64)
    h = xxh64_batch_auto(blob, lengths, seed)
    return h.astype(np.uint64).view(np.int64)


def device_transfer_plans(
    old_assign: np.ndarray,
    new_assign: np.ndarray,
    new_active: np.ndarray,
    keys64: np.ndarray,
    new_version: int,
    seed: int,
    sizes: np.ndarray,
    chunk_size: int = 1 << 16,
) -> List[DeviceTransferPlan]:
    """Every transfer implied by old_assign -> new_assign, in the same
    (partition, new-row recipient) order as ``plan.plan_transfers``.

    ``old_assign`` / ``new_assign`` are ``[P, R]`` int32 slot ids (-1 for
    empty), ``new_active`` the new map's membership mask over the slot
    universe, ``sizes`` an int64[P] of partition byte sizes."""
    if old_assign.shape != new_assign.shape:
        raise ValueError("assignment shapes differ")
    # row-wise membership masks in one broadcast each: old slot i of row p
    # survives iff it appears anywhere in the new row, and vice versa
    valid_old = old_assign >= 0
    valid_new = new_assign >= 0
    eq = old_assign[:, :, None] == new_assign[:, None, :]  # [P, R, R]
    eq &= valid_old[:, :, None] & valid_new[:, None, :]
    old_in_new = eq.any(axis=2)
    new_in_old = eq.any(axis=1)
    moved_rows = np.flatnonzero((old_assign != new_assign).any(axis=1))

    # first pass: collect (partition, recipient slot) pairs so the session
    # ids hash in one batch, then assemble plans in the same order
    partitions: List[int] = []
    recipients: List[int] = []
    sources_per: List[Tuple[int, ...]] = []
    for p in moved_rows:
        p = int(p)
        donors = [
            int(s)
            for i, s in enumerate(old_assign[p])
            if s >= 0 and not old_in_new[p, i]
        ]
        row_recipients = [
            int(s)
            for j, s in enumerate(new_assign[p])
            if s >= 0 and not new_in_old[p, j]
        ]
        survivors = [
            int(s)
            for i, s in enumerate(old_assign[p])
            if s >= 0 and old_in_new[p, i]
        ]
        for i, recipient in enumerate(row_recipients):
            if i < len(donors):
                donor = donors[i]
            elif survivors:
                donor = survivors[0]
            else:
                donor = -1
            sources: List[int] = []
            if donor >= 0 and bool(new_active[donor]):
                sources.append(donor)
            for s in survivors:
                if s not in sources:
                    sources.append(s)
            partitions.append(p)
            recipients.append(recipient)
            sources_per.append(tuple(sources))
    if not partitions:
        return []
    part_arr = np.asarray(partitions, dtype=np.int64)
    rec_arr = np.asarray(recipients, dtype=np.int64)
    session_ids = session_keys_batch(
        new_version, part_arr, keys64[rec_arr], seed
    )
    plans: List[DeviceTransferPlan] = []
    for idx, (p, recipient, sources) in enumerate(
        zip(partitions, recipients, sources_per)
    ):
        size = int(sizes[p])
        plans.append(DeviceTransferPlan(
            partition=p,
            recipient=recipient,
            sources=sources,
            size=size,
            chunks=chunk_spans(size, chunk_size),
            session_id=int(session_ids[idx]),
        ))
    return plans
