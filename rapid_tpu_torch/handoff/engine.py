"""Live handoff sessions: the recipient-driven pull machinery.

The port's own copy of ``rapid_tpu/handoff/engine.py``. One :class:`HandoffEngine` per member, wired by service.py. The engine is
both halves of the protocol:

- *source half*: answers ``HandoffRequest`` with a ``HandoffChunk`` sliced
  from the local :class:`~.store.PartitionStore` (stateless per request --
  resume costs the source nothing), and releases a partition on a verified
  ``HandoffAck`` once the new map no longer assigns it a replica.
- *recipient half*: ``start_sessions`` turns a placement diff into sessions
  (one per partition this member must acquire) and pulls chunks with a
  bounded in-flight window. Duplicate deliveries are dropped by offset
  (idempotent), a failed source advances to the next surviving replica with
  the already-received offsets kept (resumable), and completion is gated on
  the assembled content's xxh64 fingerprint matching the source's -- a
  corrupt transfer re-pulls instead of acking.

Transport-level retry/backoff/deadline discipline rides the messaging
clients themselves (messaging/retries.py: the nemesis decorator wraps
``send_message`` in ``call_with_retries`` with ``Settings.deadline_for``),
so by the time a promise fails here the retry budget for that source is
spent and failover is the right response.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..runtime.lockdep import make_rlock
from ..observability import (
    HANDOFF_BYTES_BUCKETS,
    HANDOFF_CHUNKS_BUCKETS,
    Metrics,
    NullMetrics,
)
from ..placement.engine import node_key64
from ..types import Endpoint, HandoffAck, HandoffChunk, HandoffRequest
from .plan import (
    TransferPlan,
    chunk_spans,
    content_fingerprint,
    plan_transfers,
    session_key,
)
from .store import PartitionStore

DEFAULT_CHUNK_SIZE = 1 << 16
DEFAULT_MAX_INFLIGHT = 4
DEFAULT_VERIFY_ATTEMPTS = 3


class _Session:
    """One partition's in-progress pull. All mutation happens under the
    engine lock; ``done`` flips exactly once."""

    __slots__ = (
        "plan", "map_version", "source_idx", "received", "inflight",
        "total_size", "expected_fp", "schedule", "verify_attempts",
        "not_found_sources", "done", "failed", "span",
    )

    def __init__(self, plan: TransferPlan, map_version: int, span) -> None:
        self.plan = plan
        self.map_version = map_version
        self.source_idx = 0
        self.received: Dict[int, bytes] = {}
        self.inflight: set = set()
        self.total_size: Optional[int] = None
        self.expected_fp: Optional[int] = None
        self.schedule: Optional[Tuple[Tuple[int, int], ...]] = None
        self.verify_attempts = 0
        self.not_found_sources = 0
        self.done = False
        self.failed = False
        self.span = span

    def source(self) -> Endpoint:
        return self.plan.sources[self.source_idx]

    def reset_progress(self) -> None:
        """Drop assembled state for a fresh pull (verify retry / failover
        after a metadata conflict). In-flight offsets stay tracked; their
        late replies are reconciled against the new metadata on arrival."""
        self.received.clear()
        self.total_size = None
        self.expected_fp = None
        self.schedule = None


class HandoffEngine:
    """Session bookkeeping plus both protocol halves. Thread-safe: chunk
    promises complete on transport threads."""

    def __init__(
        self,
        store: PartitionStore,
        address: Endpoint,
        client,
        scheduler,
        *,
        metrics: Optional[Metrics] = None,
        tracer=None,
        recorder=None,
        chunk_size: int = DEFAULT_CHUNK_SIZE,
        max_inflight: int = DEFAULT_MAX_INFLIGHT,
        verify_attempts: int = DEFAULT_VERIFY_ATTEMPTS,
    ) -> None:
        if chunk_size <= 0:
            raise ValueError(f"chunk_size must be positive: {chunk_size}")
        if max_inflight <= 0:
            raise ValueError(f"max_inflight must be positive: {max_inflight}")
        self.store = store
        self.address = address
        self._client = client
        self._scheduler = scheduler
        self.metrics = metrics if metrics is not None else NullMetrics()
        self._tracer = tracer
        self._recorder = recorder
        self.chunk_size = chunk_size
        self.max_inflight = max_inflight
        self.verify_attempts = verify_attempts
        self._lock = make_rlock("HandoffEngine._lock")
        self._sessions: Dict[int, _Session] = {}
        self._completed = 0
        self._failed = 0

    # -- introspection ---------------------------------------------------- #

    def status(self) -> Tuple[int, int, int]:
        """(in-flight, completed, failed) session counts."""
        with self._lock:
            in_flight = sum(1 for s in self._sessions.values() if not s.done)
            return in_flight, self._completed, self._failed

    def idle(self) -> bool:
        with self._lock:
            return all(s.done for s in self._sessions.values())

    # -- source half ------------------------------------------------------ #

    def handle_request(self, msg: HandoffRequest) -> HandoffChunk:
        """Slice one chunk out of the local store. Stateless: the recipient
        owns all session state, so duplicated or replayed requests are
        answered identically (idempotent by construction)."""
        data = self.store.get(msg.partition)
        if data is None:
            return HandoffChunk(
                sender=self.address, session_id=msg.session_id,
                partition=msg.partition, offset=msg.offset,
                status=HandoffChunk.STATUS_NOT_FOUND,
            )
        fingerprint = self.store.fingerprint(msg.partition)
        if fingerprint is None:
            fingerprint = content_fingerprint(msg.partition, data)
        chunk = data[msg.offset : msg.offset + max(0, msg.length)]
        self.metrics.incr("handoff.chunks_sent")
        return HandoffChunk(
            sender=self.address, session_id=msg.session_id,
            partition=msg.partition, offset=msg.offset, data=chunk,
            total_size=len(data), fingerprint=fingerprint,
            status=HandoffChunk.STATUS_OK,
        )

    def handle_ack(self, msg: HandoffAck, still_replica: bool) -> None:
        """A recipient verified its copy. If the current map no longer
        assigns this member a replica of the partition, release the local
        copy -- completing the ownership move."""
        if still_replica:
            return
        if self.store.get(msg.partition) is None:
            return
        # Durability barrier BEFORE the release: the source copy is the
        # last line of defense for this partition until the recipient's
        # copy is stable, so a durable store must not discard it while its
        # own WAL still holds unfsynced records -- a crash straight after
        # the delete would otherwise recover to a state that neither holds
        # the partition nor can prove who does (pinned in
        # tests/test_advice_regressions.py). Duck-typed: the in-memory
        # store has no sync() and is untouched.
        sync = getattr(self.store, "sync", None)
        if sync is not None:
            sync()
        self.store.delete(msg.partition)
        self.metrics.incr("handoff.releases")
        if self._recorder is not None:
            self._recorder.record(
                "handoff_release", virtual_ms=self._now(),
                partition=msg.partition, session=msg.session_id,
                to=str(msg.sender),
            )

    # -- recipient half --------------------------------------------------- #

    def start_sessions(self, old_map, new_map) -> int:
        """Launch a session for every plan that names this member as the
        recipient. Duplicate launches for the same (map version, partition)
        are no-ops -- the deterministic session id dedups them."""
        plans = plan_transfers(old_map, new_map, chunk_size=self.chunk_size)
        return self._launch(
            [p for p in plans if p.recipient == self.address],
            new_map.version,
        )

    def bootstrap_sessions(self, new_map) -> int:
        """Launch pulls for every partition the map assigns this member but
        the local store lacks. This is the joiner path: a fresh member's
        first map has no predecessor, so it never sees the diff that names
        it the recipient -- yet pull-based transfer means only the recipient
        can launch. The failover chain is the partition's other current
        replicas (the likely holders) followed by every remaining member,
        so a row whose old replicas all rotated out still finds the bytes;
        if genuinely nobody holds the partition the session completes
        vacuously. Session ids match what the survivors' diffs would have
        planned for this recipient, keeping launches idempotent."""
        seed = new_map.config.seed
        rkey = node_key64(self.address, seed)
        plans: List[TransferPlan] = []
        for p, row in enumerate(new_map.assignments):
            if self.address not in row:
                continue
            if self.store.get(p) is not None:
                continue
            sources = [node for node in row if node != self.address]
            for node in new_map.members:
                if node != self.address and node not in sources:
                    sources.append(node)
            if not sources:
                continue
            plans.append(TransferPlan(
                partition=p, recipient=self.address,
                sources=tuple(sources), size=0, chunks=(),
                session_id=session_key(new_map.version, p, rkey, seed),
            ))
        return self._launch(plans, new_map.version)

    def _launch(self, plans: List[TransferPlan], map_version: int) -> int:
        started: List[_Session] = []
        with self._lock:
            for plan in plans:
                if plan.session_id in self._sessions:
                    continue
                span = None
                if self._tracer is not None:
                    span = self._tracer.begin(
                        "handoff_session", virtual_ms=self._now(),
                        partition=plan.partition, session=plan.session_id,
                        sources=len(plan.sources),
                    )
                session = _Session(plan, map_version, span)
                self._sessions[plan.session_id] = session
                started.append(session)
                self.metrics.incr("handoff.sessions_started")
        for session in started:
            if not session.plan.sources:
                with self._lock:
                    self._fail_locked(session)
            else:
                self._pump(session)
        return len(started)

    # -- session machinery ------------------------------------------------ #

    def _now(self) -> Optional[int]:
        if self._scheduler is None:
            return None
        return self._scheduler.now_ms()

    def _pump(self, session: _Session) -> None:
        """Send chunk requests up to the in-flight window. Sends happen
        outside the lock: in-process transports can complete the promise on
        the calling thread, re-entering the engine."""
        to_send: List[Tuple[int, int]] = []
        with self._lock:
            if session.done:
                return
            if session.schedule is None:
                # size/fingerprint unknown (fresh session, or a failover
                # dropped the dead source's metadata): a single probe pull
                # for the first chunk carries the metadata on its reply
                if not session.inflight:
                    session.inflight.add(0)
                    to_send.append((0, self.chunk_size))
            else:
                for offset, length in session.schedule:
                    if len(session.inflight) >= self.max_inflight:
                        break
                    if offset in session.received or offset in session.inflight:
                        continue
                    session.inflight.add(offset)
                    to_send.append((offset, length))
                if (
                    not to_send and not session.inflight
                    and self._assembled_locked(session)
                ):
                    self._verify_locked(session)
                    return
        for offset, length in to_send:
            self._fetch(session, offset, length)

    def _fetch(self, session: _Session, offset: int, length: int) -> None:
        with self._lock:
            if session.done:
                session.inflight.discard(offset)
                return
            source = session.source()
            source_idx = session.source_idx
        request = HandoffRequest(
            sender=self.address, session_id=session.plan.session_id,
            partition=session.plan.partition, offset=offset, length=length,
            map_version=session.map_version,
        )
        promise = self._client.send_message(source, request)
        promise.add_callback(
            lambda p: self._on_reply(session, offset, source_idx, p)
        )

    def _on_reply(self, session: _Session, offset: int, source_idx: int,
                  promise) -> None:
        exc = promise.exception()
        reply = None if exc is not None else promise._result  # noqa: SLF001
        with self._lock:
            if session.done:
                return
            session.inflight.discard(offset)
            if exc is not None or not isinstance(reply, HandoffChunk):
                self._failover_locked(session, source_idx, not_found=False)
                return
            if reply.status != HandoffChunk.STATUS_OK:
                self._failover_locked(session, source_idx, not_found=True)
                return
            self.metrics.incr("handoff.chunks_received")
            self.metrics.incr("handoff.bytes_moved", len(reply.data))
            if session.expected_fp is None:
                session.expected_fp = reply.fingerprint
                session.total_size = reply.total_size
                session.schedule = chunk_spans(
                    reply.total_size, self.chunk_size
                )
            elif (
                reply.fingerprint != session.expected_fp
                or reply.total_size != session.total_size
            ):
                # the source's content changed under us (or a failover
                # landed on a replica with different bytes): what we have
                # assembled so far is unverifiable -- restart the pull
                # against the newly reported content
                self.metrics.incr("handoff.retries")
                session.reset_progress()
                session.expected_fp = reply.fingerprint
                session.total_size = reply.total_size
                session.schedule = chunk_spans(
                    reply.total_size, self.chunk_size
                )
            if offset in session.received:
                self.metrics.incr("handoff.chunks_duplicate")
            elif any(offset == o for o, _ in session.schedule):
                session.received[offset] = bytes(reply.data)
            if self._assembled_locked(session) and not session.inflight:
                self._verify_locked(session)
                return
        self._pump(session)

    def _assembled_locked(self, session: _Session) -> bool:
        return session.schedule is not None and all(
            offset in session.received for offset, _ in session.schedule
        )

    def _verify_locked(self, session: _Session) -> None:
        plan = session.plan
        data = b"".join(
            session.received[offset] for offset, _ in session.schedule
        )
        fingerprint = content_fingerprint(plan.partition, data)
        if fingerprint != session.expected_fp:
            self.metrics.incr("handoff.fingerprint_mismatches")
            session.verify_attempts += 1
            if session.verify_attempts >= self.verify_attempts:
                session.verify_attempts = 0
                self._failover_locked(
                    session, session.source_idx, not_found=False
                )
                return
            self.metrics.incr("handoff.retries")
            session.reset_progress()
            self._schedule_pump(session)
            return
        self.store.put(plan.partition, data)
        session.done = True
        self._completed += 1
        self.metrics.incr("handoff.sessions_completed")
        self.metrics.observe(
            "handoff.session_bytes", len(data), buckets=HANDOFF_BYTES_BUCKETS
        )
        self.metrics.observe(
            "handoff.session_chunks", len(session.schedule),
            buckets=HANDOFF_CHUNKS_BUCKETS,
        )
        if self._recorder is not None:
            self._recorder.record(
                "handoff_complete", virtual_ms=self._now(),
                partition=plan.partition, session=plan.session_id,
                bytes=len(data), source=str(session.source()),
            )
        if self._tracer is not None and session.span is not None:
            session.span.attrs["bytes"] = len(data)
            self._tracer.end(session.span, virtual_ms=self._now())
        # the ack below authorizes the source to discard its copy, so this
        # recipient's copy must be durable before the ack leaves: sync the
        # store (no-op on the in-memory reference store) ahead of the send
        sync = getattr(self.store, "sync", None)
        if sync is not None:
            sync()
        ack = HandoffAck(
            sender=self.address, session_id=plan.session_id,
            partition=plan.partition, fingerprint=fingerprint,
            map_version=session.map_version,
        )
        source = session.source()
        # best-effort: a lost ack only delays the source's release until
        # the next rebalance touches the partition
        self._client.send_message_best_effort(source, ack)

    def _failover_locked(self, session: _Session, source_idx: int,
                         not_found: bool) -> None:
        if session.done or source_idx != session.source_idx:
            # a stale failure from a source we already abandoned; the
            # offset was returned to the pool, just keep pulling
            self._schedule_pump(session)
            return
        if not_found:
            session.not_found_sources += 1
        session.source_idx += 1
        if session.source_idx >= len(session.plan.sources):
            if (
                session.not_found_sources == len(session.plan.sources)
                and len(session.plan.sources) > 0
            ):
                # every source is alive and none holds the partition:
                # there is genuinely no state to move
                session.done = True
                self._completed += 1
                self.metrics.incr("handoff.sessions_completed")
                if self._tracer is not None and session.span is not None:
                    session.span.attrs["empty"] = True
                    self._tracer.end(session.span, virtual_ms=self._now())
                return
            self._fail_locked(session)
            return
        self.metrics.incr("handoff.failovers")
        # the new source may hold different bytes than the dead one
        # reported; drop unverifiable metadata but KEEP received chunks --
        # replicas are normally identical, so the pull resumes from the
        # offsets already landed, and the metadata reconciliation in
        # _on_reply restarts it if the new source disagrees
        session.expected_fp = None
        session.total_size = None
        session.schedule = None
        self._schedule_pump(session)

    def _fail_locked(self, session: _Session) -> None:
        session.done = True
        session.failed = True
        self._failed += 1
        self.metrics.incr("handoff.sessions_failed")
        if self._recorder is not None:
            self._recorder.record(
                "handoff_failed", virtual_ms=self._now(),
                partition=session.plan.partition,
                session=session.plan.session_id,
                sources=len(session.plan.sources),
            )
        if self._tracer is not None and session.span is not None:
            session.span.attrs["failed"] = True
            self._tracer.end(session.span, virtual_ms=self._now())

    def _schedule_pump(self, session: _Session) -> None:
        """Re-enter _pump off the current stack: failovers can fire from a
        promise callback while _pump's send loop is still on the stack."""
        if self._scheduler is not None:
            self._scheduler.schedule(0, lambda: self._pump(session))
        else:
            self._pump(session)
