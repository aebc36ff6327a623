"""The serving plane: a replicated Get/Put KV store over placement + handoff.

The port's own copy of ``rapid_tpu/serving/engine.py``. One :class:`ServingEngine` per member, wired by service.py next to the
handoff engine and fed the same placement maps. The engine is every role of
the protocol at once:

- *router* (``client_get``/``client_put``): hashes the key to a partition
  (kv.py), sends to that partition's leader -- the first replica in
  placement order, which is live by construction since placement rows only
  contain current members -- and follows NOT_LEADER hints / retries RETRY
  answers with a bounded budget, so requests sent mid-churn converge on
  the post-view leader instead of failing.
- *leader*: assigns each key's next monotonic version, applies locally,
  fans replication Puts to the other replicas and acks the client once a
  majority of the replica row (itself included) applied. Reads are served
  from local state (leader reads) except while the partition is *churned*
  (this member was just promoted and has not finished its snapshot sync),
  when they fall back to quorum reads: fan a quorum Get over the
  partition's PREVIOUS row and take the max-version answer among a
  majority of it -- which must intersect any acked write's majority,
  preserving read-your-writes through leader failover.
- *replica*: applies replication Puts idempotently (only if the version is
  newer than what it holds -- duplicated/reordered replication is a no-op)
  and answers quorum Gets and partition-snapshot Gets from local state.

Promotion protocol: when a new map makes this member leader of a partition
it did not lead before, the partition is flagged churned and the engine
pulls whole-partition snapshots (``Get.quorum == 2``) from the replicas of
the partition's *previous* row -- the row whose majority acked every
pre-view write -- merging per-key max-versions into its own state. Once a
majority of the OLD row (self included, if it was a member) contributed,
every write acked under the old leader is present by quorum intersection,
and the flag clears. Pulling from the new row would be unsound: a replica
that just acquired the partition holds nothing (or a single-source handoff
copy) and its empty answer must not count toward the majority. Members
that dropped the partition in the new map keep their final blob for one
view (``_retired``) so they can still answer these probes after the
handoff ack releases the store entry; members whose own acquisition is
still in flight answer RETRY instead of an empty snapshot. Writes during
the window answer RETRY (the sync is one round trip); reads take the
quorum-read fallback, which fans over the same old row with the same
old-majority count for the same intersection argument.

Map-install skew: replicas reject replication Puts stamped with a map
version other than their installed one, so a deposed leader that has not
yet installed the new map cannot assemble a quorum for writes the new
row would never inherit -- it answers RETRY to its client instead of a
false OK. (Versions are fingerprints, so equality is the only comparison;
a leader ahead of a lagging replica also collects RETRYs until the
replica installs, which client retries absorb.)

Known limitation: the merge makes the NEW LEADER complete, but does not
re-replicate the merged state across the new row. A sequence of view
changes that replaces a row's membership faster than writes refresh it
can leave pre-merge writes on fewer than a majority of the latest row;
the placement plane's incremental rendezvous moves make this window
narrow, and the statusz fingerprint cross-check surfaces divergence, but
a full reconfiguration protocol is the real fix.

Durability rides the handoff plane: every mutation re-serializes the
partition's KV map into the shared :class:`~..handoff.store.PartitionStore`
via the canonical encoding in kv.py, so view-change state transfer moves
serving data through the existing verified handoff sessions and replica
fingerprints stay comparable across members.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Dict, List, Optional, Set, Tuple

from ..observability import (
    SERVING_LATENCY_BUCKETS_MS,
    Metrics,
    NullMetrics,
)
from ..runtime.futures import Promise
from ..runtime.lockdep import make_rlock
from ..types import Endpoint, Get, Put, PutAck
from .kv import decode_kv, encode_kv, partition_of

DEFAULT_RETRY_LIMIT = 8
DEFAULT_RETRY_DELAY_MS = 10


def _bug_newrow_sync() -> bool:
    """Deliberately reintroduce the old sync-target bug when
    RAPID_BUG_NEWROW_SYNC=1: the promote-time sync pulls its quorum from
    the NEW row, counting just-acquired replicas whose handoff copy may
    descend from a stale survivor. This is the known-bug target the
    nemesis search must find, shrink, and pin; read at call time so tests can monkeypatch the environment."""
    import os

    return os.environ.get("RAPID_BUG_NEWROW_SYNC", "") == "1"


class ServingEngine:
    """Router, leader and replica halves of the serving protocol.
    Thread-safe: handlers run on the protocol executor while replication
    and routing promises complete on transport threads."""

    def __init__(
        self,
        store,
        address: Endpoint,
        client,
        scheduler,
        *,
        metrics: Optional[Metrics] = None,
        tracer=None,
        recorder=None,
        retry_limit: int = DEFAULT_RETRY_LIMIT,
        retry_delay_ms: int = DEFAULT_RETRY_DELAY_MS,
    ) -> None:
        if retry_limit <= 0:
            raise ValueError(f"retry_limit must be positive: {retry_limit}")
        self.store = store
        self.address = address
        self._client = client
        self._scheduler = scheduler
        self.metrics = metrics if metrics is not None else NullMetrics()
        self._tracer = tracer
        self._recorder = recorder
        self.retry_limit = retry_limit
        self.retry_delay_ms = retry_delay_ms
        # reentrant: in-process transports complete send promises on the
        # calling thread, so a reply callback can land while the issuing
        # frame still holds the lock
        self._lock = make_rlock("ServingEngine._lock")
        self._map = None  # latest PlacementMap (None until first install)
        # guarded-by: _lock -- decoded per-partition KV caches; the store
        # blob stays authoritative (rewritten on every mutation)
        self._kv: Dict[int, Dict[bytes, Tuple[int, bytes]]] = {}
        # guarded-by: _lock -- partitions this member leads but has not
        # finished promote-time snapshot sync for, mapped to the sync
        # quorum: (old-row members to pull from, answers required)
        self._churned: Dict[int, Tuple[Tuple[Endpoint, ...], int]] = {}
        # guarded-by: _lock -- final blobs of partitions this member
        # dropped at the current map, kept one view so peers promoted over
        # the old row can still pull them after the handoff ack releases
        # the store entry: partition -> (map version at retirement, blob)
        self._retired: Dict[int, Tuple[int, bytes]] = {}
        # guarded-by: _lock -- partitions acquired at the current map whose
        # handoff delivery may still be in flight; until the store holds
        # bytes for them, this member has nothing authoritative to answer
        self._acquired: Set[int] = set()
        # guarded-by: _lock -- partitions acquired mid-stream (the row
        # existed before this member joined it): the handoff copy may
        # descend from ANY old-row survivor, stale ones included, so until
        # a majority of the pre-join row is merged in (the join-time pull)
        # this member abstains from snapshot and quorum answers. Counting
        # such a copy toward a peer's sync quorum is the chained-view
        # staleness the nemesis search pinned: partition -> (pre-join row
        # members to pull from, answers required)
        self._grafted: Dict[int, Tuple[Tuple[Endpoint, ...], int]] = {}
        self._next_request_id = 1
        self._gets = 0
        self._puts = 0
        self._put_acks = 0

    # -- introspection ---------------------------------------------------- #

    def status(self) -> Tuple[int, int, int]:
        """(gets served, puts served, replication acks received)."""
        with self._lock:
            return self._gets, self._puts, self._put_acks

    def leader_digest(self) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
        """Parallel (partition id, leader "host:port") arrays over the
        partitions this member replicates -- the statusz cross-check input:
        every member must name the same leader for a shared partition."""
        with self._lock:
            pmap = self._map
            if pmap is None:
                return (), ()
            partitions: List[int] = []
            leaders: List[str] = []
            for p, row in enumerate(pmap.assignments):
                if row and self.address in row:
                    partitions.append(p)
                    leaders.append(str(row[0]))
            return tuple(partitions), tuple(leaders)

    def churned_partitions(self) -> Tuple[int, ...]:
        with self._lock:
            return tuple(sorted(self._churned))

    def _now(self) -> Optional[int]:
        if self._scheduler is None:
            return None
        return self._scheduler.now_ms()

    # -- placement tracking ----------------------------------------------- #

    def update_map(self, pmap) -> None:
        """Adopt a just-installed placement map: recompute leadership,
        invalidate KV caches for partitions the handoff plane is about to
        (re)deliver, and launch promote-time snapshot syncs for partitions
        this member now leads. Runs on the protocol executor inside the
        view-change path, after the handoff sessions launch."""
        to_sync: List[Tuple[int, Tuple[Endpoint, ...], int, int]] = []
        to_graft: List[int] = []
        changes = 0
        with self._lock:
            old = self._map
            self._map = pmap
            # retired blobs outlive their partition by exactly one view:
            # entries saved at the map we are now replacing may still feed
            # peers whose promote-time sync runs against that map
            if old is not None:
                self._retired = {
                    q: entry for q, entry in self._retired.items()
                    if entry[0] == old.version
                }
            for p, row in enumerate(pmap.assignments):
                old_row: Tuple[Endpoint, ...] = ()
                if old is not None and p < len(old.assignments):
                    old_row = old.assignments[p]
                old_leader = old_row[0] if old_row else None
                if not row or self.address not in row:
                    if self.address in old_row and p not in self._grafted:
                        # retiring replica: the handoff ack path will
                        # release the store blob; keep the bytes one view
                        # so syncs against the old row can still pull them.
                        # A still-grafted leaver retires nothing: its copy
                        # was never reconciled, so it must not feed a
                        # peer's old-row majority
                        blob = self.store.get(p)
                        self._retired[p] = (
                            pmap.version, blob if blob is not None else b""
                        )
                    self._kv.pop(p, None)
                    self._churned.pop(p, None)
                    self._acquired.discard(p)
                    self._grafted.pop(p, None)
                    continue
                self._retired.pop(p, None)
                if old is None or self.address not in old_row:
                    # newly acquired replica: the bytes arrive via a
                    # verified handoff session into the store -- a stale
                    # decoded cache would shadow them, and until they land
                    # this member has nothing authoritative to answer
                    self._kv.pop(p, None)
                    self._acquired.add(p)
                    if old_row and not _bug_newrow_sync():
                        # mid-stream join: abstain until a majority of the
                        # pre-join row is merged in. If we were also just
                        # promoted, the promote-time sync below runs with
                        # the same (others, need) and clears the graft on
                        # completion; otherwise the join-time pull does.
                        self._grafted[p] = (
                            tuple(n for n in old_row if n != self.address),
                            len(old_row) // 2 + 1,
                        )
                        if row[0] != self.address:
                            to_graft.append(p)
                else:
                    self._acquired.discard(p)
                leader = row[0]
                if old is not None and old_leader != leader:
                    changes += 1
                if leader == self.address and (
                    old_leader != self.address or p in self._churned
                ):
                    # promoted (or still mid-sync from the previous
                    # promotion, whose pull this map just superseded):
                    # sync against the OLD row, whose majority acked every
                    # pre-view write. Pulling from the new row would count
                    # empty just-acquired replicas toward the quorum.
                    if old_row and not _bug_newrow_sync():
                        others = tuple(
                            n for n in old_row if n != self.address
                        )
                        # a grafted self does not count toward the old-row
                        # majority: its own copy is the unreconciled bytes
                        # the graft discipline exists to quarantine
                        need = (len(old_row) // 2 + 1) - (
                            1 if (
                                self.address in old_row
                                and p not in self._grafted
                            ) else 0
                        )
                    else:
                        # first map this member sees: the old row is
                        # unknowable, so best-effort sync against the new
                        # row -- responders still answer RETRY until their
                        # own acquisition lands, so empty co-acquirers
                        # cannot satisfy the count. (_bug_newrow_sync
                        # forces this branch even with an old row: a
                        # just-acquired replica then answers from its
                        # handoff copy, which may descend from a stale
                        # survivor -- the pinned-corpus regression)
                        others = tuple(n for n in row if n != self.address)
                        need = (len(row) // 2 + 1) - 1
                    if need <= 0 or not others:
                        self._churned.pop(p, None)
                        continue  # sole replica holds every acked write
                    self._churned[p] = (others, need)
                    to_sync.append((p, others, need, pmap.version))
                elif leader != self.address:
                    self._churned.pop(p, None)
        if changes:
            self.metrics.incr("serving.leader_changes", changes)
            if self._tracer is not None:
                self._tracer.event(
                    "serving_leader_change", virtual_ms=self._now(),
                    partitions=changes, version=pmap.version,
                )
            if self._recorder is not None:
                self._recorder.record(
                    "serving_leader_change", partitions=changes,
                    version=pmap.version, churned=len(to_sync),
                )
        # sends outside the lock: in-process transports complete inline
        for p, others, need, version in to_sync:
            self._start_sync(p, others, need, version)
        for p in to_graft:
            self._start_graft(p)

    def _start_sync(self, p: int, others: Tuple[Endpoint, ...], need: int,
                    version: int) -> None:
        """Pull whole-partition snapshots from the other replicas and merge
        per-key max-versions; the churn flag clears once a majority of the
        row (self included) contributed."""
        with self._lock:
            if (
                self._map is None or self._map.version != version
                or p not in self._churned
            ):
                return  # superseded by a newer map (its own sync runs)
        probe = Get(
            sender=self.address, key=p.to_bytes(8, "little"), quorum=2,
            map_version=version,
        )
        state = {"snaps": [], "replies": 0, "done": False}
        for node in others:
            promise = self._client.send_message(node, probe)
            promise.add_callback(
                lambda reply: self._on_snapshot(
                    p, others, need, version, state, reply
                )
            )

    def _on_snapshot(self, p: int, others: Tuple[Endpoint, ...], need: int,
                     version: int, state: dict, promise) -> None:
        exc = promise.exception()
        reply = None if exc is not None else promise._result  # noqa: SLF001
        retry = False
        with self._lock:
            if state["done"]:
                return
            if (
                self._map is None or self._map.version != version
                or p not in self._churned
            ):
                state["done"] = True
                return
            state["replies"] += 1
            if (
                exc is None and isinstance(reply, PutAck)
                and reply.status == PutAck.STATUS_OK
            ):
                state["snaps"].append(decode_kv(reply.value))
            if len(state["snaps"]) >= need:
                state["done"] = True
                kv = self._load_locked(p)
                for snap in state["snaps"]:
                    for key, (ver, val) in snap.items():
                        if ver > kv.get(key, (0, b""))[0]:
                            kv[key] = (ver, val)
                self._persist_locked(p)
                self._churned.pop(p, None)
                # the promote-time merge covers the join-time obligation:
                # when this member was grafted, need was a full old-row
                # majority (self uncounted), the same quorum the pull wants
                self._grafted.pop(p, None)
                if self._recorder is not None:
                    self._recorder.record(
                        "serving_sync", partition=p, version=version,
                        snapshots=len(state["snaps"]),
                    )
            elif state["replies"] >= len(others):
                # not enough live snapshot answers this round; re-pull
                # until a newer map supersedes this promotion
                state["done"] = True
                retry = True
        if retry:
            if self._scheduler is not None:
                self._scheduler.schedule(
                    self.retry_delay_ms,
                    lambda: self._start_sync(p, others, need, version),
                )
            else:
                # no scheduler to defer to: retry inline (mirroring
                # _on_routed_reply), otherwise the partition would stay
                # churned forever and every Put would answer RETRY
                self._start_sync(p, others, need, version)

    def _start_graft(self, p: int) -> None:
        """Join-time pull for a mid-stream acquirer (follower half of the
        graft discipline): merge a majority of the pre-join row, then
        start answering. The pull outlives map changes -- the obligation
        is about writes acked before this member joined, and the target
        row is fixed at join time -- and retries until it completes, the
        partition moves away, or a promotion's own sync subsumes it."""
        with self._lock:
            entry = self._grafted.get(p)
            pmap = self._map
            if entry is None or pmap is None:
                return
            others, need = entry
            version = pmap.version
        probe = Get(
            sender=self.address, key=p.to_bytes(8, "little"), quorum=2,
            map_version=version,
        )
        state = {"snaps": [], "replies": 0, "done": False}
        for node in others:
            promise = self._client.send_message(node, probe)
            promise.add_callback(
                lambda reply: self._on_graft_snapshot(
                    p, others, need, state, reply
                )
            )

    def _on_graft_snapshot(self, p: int, others: Tuple[Endpoint, ...],
                           need: int, state: dict, promise) -> None:
        exc = promise.exception()
        reply = None if exc is not None else promise._result  # noqa: SLF001
        retry = False
        with self._lock:
            if state["done"]:
                return
            if p not in self._grafted:
                state["done"] = True
                return
            state["replies"] += 1
            if (
                exc is None and isinstance(reply, PutAck)
                and reply.status == PutAck.STATUS_OK
            ):
                state["snaps"].append(decode_kv(reply.value))
            if len(state["snaps"]) >= need:
                state["done"] = True
                kv = self._kv.get(p)
                if kv is None:
                    blob = self.store.get(p)
                    kv = decode_kv(blob) if blob is not None else {}
                    self._kv[p] = kv
                for snap in state["snaps"]:
                    for key, (ver, val) in snap.items():
                        if ver > kv.get(key, (0, b""))[0]:
                            kv[key] = (ver, val)
                self._persist_locked(p)
                self._grafted.pop(p, None)
                self.metrics.incr("serving.reconciled_replicas")
                if self._recorder is not None:
                    self._recorder.record(
                        "serving_sync", partition=p, graft=True,
                        snapshots=len(state["snaps"]),
                    )
            elif state["replies"] >= len(others):
                state["done"] = True
                retry = True
        if retry and self._scheduler is not None:
            self._scheduler.schedule(
                self.retry_delay_ms, lambda: self._start_graft(p)
            )
        # without a scheduler a stuck graft just stays open: this member
        # keeps abstaining (safe), and a later promotion's sync or a map
        # move clears it -- unlike _on_snapshot there is no availability
        # cliff forcing an inline retry, and an inline loop could never
        # terminate against a RETRY-answering in-process peer

    # -- local state ------------------------------------------------------ #

    def _load_locked(self, p: int) -> Dict[bytes, Tuple[int, bytes]]:
        kv = self._kv.get(p)
        if kv is None:
            kv = decode_kv(self.store.get(p))
            self._kv[p] = kv
        return kv

    def _persist_locked(self, p: int) -> None:
        # every mutation re-serializes canonically so replica fingerprints
        # stay comparable and handoff always moves current bytes
        self.store.put(p, encode_kv(self._kv[p]))

    def _snapshot_blob_locked(self, p: int) -> Optional[bytes]:
        """Bytes this member may contribute to a peer's promote-time sync,
        or None when it has nothing authoritative: it never replicated the
        partition, or its own handoff acquisition is still in flight (an
        empty answer must not count toward the peer's old-row majority)."""
        pmap = self._map
        if pmap is None or not 0 <= p < len(pmap.assignments):
            return None
        row = pmap.assignments[p]
        if row and self.address in row:
            if p in self._acquired and self.store.get(p) is None:
                return None
            if p in self._grafted:
                return None  # handoff copy not yet reconciled (see graft)
            return encode_kv(self._load_locked(p))
        entry = self._retired.get(p)
        return entry[1] if entry is not None else None

    def _authoritative_kv_locked(
        self, p: int
    ) -> Optional[Dict[bytes, Tuple[int, bytes]]]:
        """Decoded state for quorum-read answers, under the same rules as
        _snapshot_blob_locked; retired state is decoded without caching
        (this member no longer owns the partition)."""
        pmap = self._map
        if pmap is None or not 0 <= p < len(pmap.assignments):
            return None
        row = pmap.assignments[p]
        if row and self.address in row:
            if p in self._acquired and self.store.get(p) is None:
                return None
            if p in self._grafted:
                return None  # handoff copy not yet reconciled (see graft)
            return self._load_locked(p)
        entry = self._retired.get(p)
        return decode_kv(entry[1]) if entry is not None else None

    # -- server half: Get ------------------------------------------------- #

    def handle_get(self, msg: Get) -> Promise:
        quorum_read: Optional[Tuple[int, Tuple[Endpoint, ...], int]] = None
        with self._lock:
            self._gets += 1
            self.metrics.incr("serving.gets")
            pmap = self._map
            if pmap is None:
                return Promise.completed(self._retry_ack(msg.key, 0))
            if msg.quorum == 2:
                # whole-partition snapshot (promote-time sync source half):
                # the key carries the partition id as 8 LE bytes. Answer
                # only what we are authoritative for -- bounds-checked,
                # replicated here (or just retired here), and not awaiting
                # our own handoff delivery -- so a stale or malformed probe
                # neither pollutes the KV cache nor contributes an empty
                # snapshot to a peer's old-row majority.
                if len(msg.key) < 8:
                    return Promise.completed(self._retry_ack(msg.key, 0))
                p = int.from_bytes(msg.key[:8], "little")
                blob = self._snapshot_blob_locked(p)
                if blob is None:
                    return Promise.completed(self._retry_ack(msg.key, 0))
                return Promise.completed(PutAck(
                    sender=self.address, status=PutAck.STATUS_OK,
                    key=msg.key, value=blob, map_version=pmap.version,
                ))
            p = partition_of(msg.key, pmap.config.partitions)
            if msg.quorum == 1:
                # quorum-read member half: answer from local state, but
                # only when authoritative (same gate as the snapshot path;
                # a churned leader's read quorum runs over the OLD row, so
                # retired state answers and in-flight acquirers abstain)
                akv = self._authoritative_kv_locked(p)
                if akv is None:
                    return Promise.completed(self._retry_ack(msg.key, 0))
                version, value = akv.get(msg.key, (0, b""))
                return Promise.completed(PutAck(
                    sender=self.address,
                    status=(PutAck.STATUS_OK if msg.key in akv
                            else PutAck.STATUS_NOT_FOUND),
                    key=msg.key, value=value, version=version,
                    map_version=pmap.version,
                ))
            row = pmap.assignments[p] if p < len(pmap.assignments) else ()
            if not row or row[0] != self.address:
                self.metrics.incr("serving.not_leader_redirects")
                return Promise.completed(PutAck(
                    sender=self.address, status=PutAck.STATUS_NOT_LEADER,
                    key=msg.key, leader=row[0] if row else None,
                    map_version=pmap.version,
                ))
            kv = self._load_locked(p)
            version, value = kv.get(msg.key, (0, b""))
            found = msg.key in kv
            if p in self._churned:
                # just promoted, snapshot sync still in flight: a local
                # answer could miss writes acked by the previous leader --
                # fall back to a quorum read over the same old row the
                # sync pulls from (the row whose majority acked them)
                others, need = self._churned[p]
                quorum_read = (p, others, need)
            else:
                self.metrics.incr("serving.leader_reads")
                return Promise.completed(PutAck(
                    sender=self.address,
                    status=(PutAck.STATUS_OK if found
                            else PutAck.STATUS_NOT_FOUND),
                    key=msg.key, value=value, version=version,
                    map_version=pmap.version,
                ))
        p, others, need = quorum_read
        return self._quorum_read(msg.key, others, need, version, value, found)

    def _quorum_read(self, key: bytes, others: Tuple[Endpoint, ...],
                     need: int, version: int, value: bytes,
                     found: bool) -> Promise:
        """Fan a quorum Get over the churned partition's old row; answer
        with the max-version value once a majority of that row (local
        answer included when this member was in it) responded. Any acked
        write's majority lives in the old row and intersects ours, so the
        max-version answer observes it. Responders answer only when
        authoritative (retired state counts; in-flight acquirers abstain
        with RETRY, which is not counted)."""
        self.metrics.incr("serving.quorum_reads")
        done: Promise = Promise()
        if need <= 0 or not others:
            done.set_result(self._read_ack(key, version, value, found))
            return done
        state = {
            "version": version, "value": value, "found": found,
            "answers": 0, "replies": 0, "done": False,
        }
        probe = Get(sender=self.address, key=key, quorum=1)
        for node in others:
            promise = self._client.send_message(node, probe)
            promise.add_callback(
                lambda reply: self._on_quorum_answer(
                    key, need, len(others), state, done, reply
                )
            )
        return done

    def _on_quorum_answer(self, key: bytes, need: int, total: int,
                          state: dict, done: Promise, promise) -> None:
        exc = promise.exception()
        reply = None if exc is not None else promise._result  # noqa: SLF001
        ack: Optional[PutAck] = None
        with self._lock:
            if state["done"]:
                return
            state["replies"] += 1
            if exc is None and isinstance(reply, PutAck) and reply.status in (
                PutAck.STATUS_OK, PutAck.STATUS_NOT_FOUND,
            ):
                state["answers"] += 1
                if (
                    reply.status == PutAck.STATUS_OK
                    and reply.version > state["version"]
                ):
                    state["version"] = reply.version
                    state["value"] = reply.value
                    state["found"] = True
            if state["answers"] >= need:
                state["done"] = True
                ack = self._read_ack(
                    key, state["version"], state["value"], state["found"]
                )
            elif state["replies"] >= total:
                # not enough replica answers for a majority: the client
                # retries against the (soon-synced) leader
                state["done"] = True
                ack = self._retry_ack(key, 0)
        if ack is not None:
            done.try_set_result(ack)

    def _read_ack(self, key: bytes, version: int, value: bytes,
                  found: bool) -> PutAck:
        return PutAck(
            sender=self.address,
            status=PutAck.STATUS_OK if found else PutAck.STATUS_NOT_FOUND,
            key=key, value=value, version=version,
            map_version=self._map.version if self._map is not None else 0,
        )

    def _retry_ack(self, key: bytes, request_id: int) -> PutAck:
        return PutAck(
            sender=self.address, status=PutAck.STATUS_RETRY, key=key,
            request_id=request_id,
            map_version=self._map.version if self._map is not None else 0,
        )

    # -- server half: Put ------------------------------------------------- #

    def handle_put(self, msg: Put) -> Promise:
        with self._lock:
            self._puts += 1
            self.metrics.incr("serving.puts")
            if msg.replicate:
                return Promise.completed(self._apply_replica_locked(msg))
            pmap = self._map
            if pmap is None:
                return Promise.completed(
                    self._retry_ack(msg.key, msg.request_id)
                )
            p = partition_of(msg.key, pmap.config.partitions)
            row = pmap.assignments[p] if p < len(pmap.assignments) else ()
            if not row or row[0] != self.address:
                self.metrics.incr("serving.not_leader_redirects")
                return Promise.completed(PutAck(
                    sender=self.address, status=PutAck.STATUS_NOT_LEADER,
                    key=msg.key, request_id=msg.request_id,
                    leader=row[0] if row else None,
                    map_version=pmap.version,
                ))
            if p in self._churned:
                # promote sync in flight: accepting the write now could
                # assign a version the previous leader already used
                return Promise.completed(
                    self._retry_ack(msg.key, msg.request_id)
                )
            kv = self._load_locked(p)
            version = kv.get(msg.key, (0, b""))[0] + 1
            kv[msg.key] = (version, msg.value)
            self._persist_locked(p)
            others = tuple(n for n in row if n != self.address)
            need = (len(row) // 2 + 1) - 1  # majority minus self-ack
            ack = PutAck(
                sender=self.address, status=PutAck.STATUS_OK, key=msg.key,
                version=version, request_id=msg.request_id,
                map_version=pmap.version,
            )
        if need <= 0:
            return Promise.completed(ack)
        done: Promise = Promise()
        state = {"acks": 0, "replies": 0, "done": False}
        replica_put = Put(
            sender=self.address, key=msg.key, value=msg.value,
            request_id=msg.request_id, replicate=1, version=ack.version,
            map_version=ack.map_version,
        )
        # sends outside the lock; replies can complete inline
        for node in others:
            self.metrics.incr("serving.replication_writes")
            promise = self._client.send_message(node, replica_put)
            promise.add_callback(
                lambda reply: self._on_replica_ack(
                    need, len(others), state, done, ack, reply
                )
            )
        return done

    def _apply_replica_locked(self, msg: Put) -> PutAck:
        """Replica half: apply iff the replicated version is newer than
        what we hold -- duplicated, reordered or nemesis-replayed
        replication converges to the same state.

        Applies only under the sender's exact installed map (versions are
        fingerprints; equality is the only comparison) and only for
        partitions this member replicates. A deposed leader racing a map
        install therefore cannot assemble a quorum here -- it collects
        RETRYs and reports RETRY to its client instead of acking a write
        the new row would never inherit -- and a delayed or duplicated
        replication Put cannot re-create a blob for a partition this
        member already dropped."""
        pmap = self._map
        if pmap is None or msg.map_version != pmap.version:
            return self._retry_ack(msg.key, msg.request_id)
        p = partition_of(msg.key, pmap.config.partitions)
        row = pmap.assignments[p] if p < len(pmap.assignments) else ()
        if not row or self.address not in row:
            return self._retry_ack(msg.key, msg.request_id)
        kv = self._load_locked(p)
        if msg.version > kv.get(msg.key, (0, b""))[0]:
            kv[msg.key] = (msg.version, msg.value)
            self._persist_locked(p)
        return PutAck(
            sender=self.address, status=PutAck.STATUS_OK, key=msg.key,
            version=msg.version, request_id=msg.request_id,
            map_version=pmap.version,
        )

    def _on_replica_ack(self, need: int, total: int, state: dict,
                        done: Promise, ack: PutAck, promise) -> None:
        exc = promise.exception()
        reply = None if exc is not None else promise._result  # noqa: SLF001
        final: Optional[PutAck] = None
        with self._lock:
            if state["done"]:
                return
            state["replies"] += 1
            if (
                exc is None and isinstance(reply, PutAck)
                and reply.status == PutAck.STATUS_OK
            ):
                state["acks"] += 1
                self._put_acks += 1
                self.metrics.incr("serving.put_acks")
            if state["acks"] >= need:
                state["done"] = True
                final = ack
            elif state["replies"] >= total:
                # quorum unreachable: the local apply stands but is not
                # acknowledged -- the client must send it again (PutAck docs)
                state["done"] = True
                self.metrics.incr("serving.put_retries")
                final = replace(ack, status=PutAck.STATUS_RETRY)
        if final is not None:
            done.try_set_result(final)

    # -- router half ------------------------------------------------------ #

    def client_put(self, key: bytes, value: bytes) -> Promise:
        """Write ``key`` through the partition leader; completes with the
        final PutAck after routing redirects and bounded retries."""
        return self._routed("put", key, value)

    def client_get(self, key: bytes) -> Promise:
        """Read ``key`` from the partition leader (quorum-read fallback is
        the leader's, not the client's, decision)."""
        return self._routed("get", key, b"")

    def _routed(self, op: str, key: bytes, value: bytes) -> Promise:
        with self._lock:
            request_id = self._next_request_id
            self._next_request_id += 1
        done: Promise = Promise()
        t0 = self._now()
        span = None
        if self._tracer is not None:
            span = self._tracer.begin(
                "serving_request", virtual_ms=t0, op=op,
            )
        self._attempt(op, key, value, request_id, 0, None, done, span, t0)
        return done

    def _attempt(self, op: str, key: bytes, value: bytes, request_id: int,
                 attempt: int, hint: Optional[Endpoint], done: Promise,
                 span, t0: Optional[int]) -> None:
        with self._lock:
            pmap = self._map
            leader = hint
            map_version = pmap.version if pmap is not None else 0
            if leader is None and pmap is not None:
                p = partition_of(key, pmap.config.partitions)
                row = pmap.assignments[p] if p < len(pmap.assignments) else ()
                leader = row[0] if row else None
        if leader is None:
            self._finish(done, span, t0, self._retry_ack(key, request_id))
            return
        if op == "put":
            msg = Put(
                sender=self.address, key=key, value=value,
                request_id=request_id, map_version=map_version,
            )
        else:
            msg = Get(
                sender=self.address, key=key, quorum=0,
                map_version=map_version,
            )
        if leader == self.address:
            promise = (
                self.handle_put(msg) if op == "put" else self.handle_get(msg)
            )
        else:
            promise = self._client.send_message(leader, msg)
        promise.add_callback(
            lambda reply: self._on_routed_reply(
                op, key, value, request_id, attempt, done, span, t0, reply
            )
        )

    def _on_routed_reply(self, op: str, key: bytes, value: bytes,
                         request_id: int, attempt: int, done: Promise,
                         span, t0: Optional[int], promise) -> None:
        exc = promise.exception()
        reply = None if exc is not None else promise._result  # noqa: SLF001
        hint: Optional[Endpoint] = None
        retryable = (
            exc is not None
            or not isinstance(reply, PutAck)
            or reply.status in (
                PutAck.STATUS_NOT_LEADER, PutAck.STATUS_RETRY,
            )
        )
        if retryable and attempt + 1 < self.retry_limit:
            if (
                isinstance(reply, PutAck)
                and reply.status == PutAck.STATUS_NOT_LEADER
            ):
                hint = reply.leader  # follow once; next retry recomputes
            if op == "put":
                self.metrics.incr("serving.put_retries")
            retry = lambda: self._attempt(  # noqa: E731
                op, key, value, request_id, attempt + 1, hint, done, span, t0
            )
            if self._scheduler is not None:
                self._scheduler.schedule(self.retry_delay_ms, retry)
            else:
                retry()
            return
        final = (
            reply if isinstance(reply, PutAck)
            else self._retry_ack(key, request_id)
        )
        self._finish(done, span, t0, final)

    def _finish(self, done: Promise, span, t0: Optional[int],
                ack: PutAck) -> None:
        now = self._now()
        if t0 is not None and now is not None:
            self.metrics.observe(
                "serving.request_ms", max(0, now - t0),
                buckets=SERVING_LATENCY_BUCKETS_MS,
            )
        if self._tracer is not None and span is not None:
            span.attrs["status"] = ack.status
            self._tracer.end(span, virtual_ms=now)
        done.try_set_result(ack)
