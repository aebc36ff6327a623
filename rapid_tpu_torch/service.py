"""The membership protocol engine.

The port's own copy of ``rapid_tpu/service.py``, with the flat protocol
plane and every plane the port has (placement, SLO, profiling history,
forensics). The handoff, serving, durability and hierarchy planes, whose
live engines come with ROADMAP.md Queue 1 item 12, are refused: a member
asked for one raises ``NotImplementedError`` before it starts.

Reference: MembershipService.java -- the single dispatch point for all protocol
messages (:171-193), join gatekeeping (:200-286), alert batching (:602-626),
cut-detector driving (:297-348), view-change application (:379-433), failure
detector lifecycle (:686-703) and event subscriptions.

Threading model: every handler body hops onto the node's serialized protocol
executor, exactly like the reference's single-threaded protocolExecutor
(SharedResources.java:53, MembershipService.java:68-72). Under the virtual-time
scheduler this additionally makes whole-cluster runs deterministic.
"""

from __future__ import annotations

import logging
import random
from typing import Callable, Dict, List, Optional, Set, Tuple

from .cut_detector import MultiNodeCutDetector
from .events import ClusterEvents, NodeStatusChange
from .fast_paxos import FastPaxos
from .forensics.bundle import build_bundle, capture_local_evidence
from .forensics.hlc import HlcClock, hlc_of, stamp_hlc
from .handoff.store import PartitionStore
from .hashing import address_comparator_key
from .membership import MembershipView
from .messaging.base import IBroadcaster, IMessagingClient
from .messaging.unicast import UnicastToAllBroadcaster
from .metadata import FrozenMetadata, MetadataManager
from .monitoring.base import IEdgeFailureDetectorFactory
from .observability import (
    DEFAULT_JOURNAL_CAPACITY,
    PARTITIONS_MOVED_BUCKETS,
    FlightRecorder,
    Metrics,
    MetricsHistory,
    StableViewTimer,
    TraceContext,
    Tracer,
    global_metrics,
    global_tracer,
    stamp_trace_context,
    trace_context_of,
)
from .placement.engine import (
    PlacementConfig,
    PlacementDiff,
    PlacementEngine,
    PlacementMap,
    weight_of,
)
from .runtime.futures import Promise, successful_as_list
from .runtime.lockdep import make_lock
from .runtime.resources import SharedResources
from .runtime.scheduler import ScheduledTask
from .settings import Settings
from .slo.burn import SloPlane
from .types import (
    AlertMessage,
    BatchedAlertMessage,
    CONSENSUS_MESSAGE_TYPES,
    CellDigestMessage,
    ClusterStatusRequest,
    ClusterStatusResponse,
    ConsensusResponse,
    EdgeStatus,
    Endpoint,
    FastRoundVoteBatch,
    Get,
    GlobalViewMessage,
    GossipEnvelope,
    HandoffAck,
    HandoffRequest,
    JoinMessage,
    JoinResponse,
    JoinStatusCode,
    LeaveMessage,
    MessageBatch,
    NodeId,
    PreJoinMessage,
    ProbeMessage,
    ProbeResponse,
    Put,
    PutAck,
    RapidMessage,
    Response,
)

LOG = logging.getLogger(__name__)

SubscriptionCallback = Callable[[int, List[NodeStatusChange]], None]


def refuse_waiting_plane(plane: str) -> None:
    """Raise for a plane whose live engine the port does not have yet: the
    handoff, serving, durability and hierarchy planes of a member come with
    ROADMAP.md Queue 1 item 12. A member asked for one refuses to start
    rather than run without it."""
    raise NotImplementedError(
        f"the {plane} plane of a protocol-plane member is not ported to "
        "rapid_tpu_torch yet (ROADMAP.md Queue 1 item 12); build the member "
        "without it"
    )


def _chain_promise(inner: Promise, outer: Promise) -> None:
    """Propagate a completed inner promise (result or exception) onto the
    outer one the transport is watching."""
    exc = inner.exception()
    if exc is not None:
        outer.try_set_exception(exc)
    else:
        outer.try_set_result(inner._result)  # noqa: SLF001


class MembershipService:
    def __init__(
        self,
        my_addr: Endpoint,
        cut_detector: MultiNodeCutDetector,
        membership_view: MembershipView,
        resources: SharedResources,
        settings: Settings,
        client: IMessagingClient,
        edge_failure_detector: IEdgeFailureDetectorFactory,
        metadata_map: Optional[Dict[Endpoint, FrozenMetadata]] = None,
        subscriptions: Optional[Dict[ClusterEvents, List[SubscriptionCallback]]] = None,
        rng: Optional[random.Random] = None,
        broadcaster: Optional[IBroadcaster] = None,
        metrics: Optional[Metrics] = None,
        tracer: Optional[Tracer] = None,
        recorder: Optional[FlightRecorder] = None,
        placement: Optional[PlacementConfig] = None,
        handoff_store: Optional[PartitionStore] = None,
        serving: bool = False,
        hlc: Optional[HlcClock] = None,
    ) -> None:
        self._my_addr = my_addr
        self._cut_detection = cut_detector
        self._view = membership_view
        self._resources = resources
        self._scheduler = resources.scheduler
        self._settings = settings
        self._client = client
        self._fd_factory = edge_failure_detector
        self._rng = rng if rng is not None else random.Random()
        self._metadata_manager = MetadataManager()
        if metadata_map:
            self._metadata_manager.add_metadata(metadata_map)
        self._broadcaster = (
            broadcaster
            if broadcaster is not None
            else UnicastToAllBroadcaster(
                client, rng=self._rng, settings=settings,
                scheduler=resources.scheduler, my_addr=my_addr,
            )
        )
        # Hierarchy plane (settings.hierarchy is the kill switch): its
        # engine is not ported, so a member asked for it refuses to start
        # rather than run the flat protocol under a hierarchical config
        if settings.hierarchy.enabled:
            refuse_waiting_plane("hierarchy")
        # Handoff and serving planes: not ported either (refused the same
        # way; ClusterBuilder refuses them before any resource is built)
        if handoff_store is not None:
            refuse_waiting_plane("handoff")
        if serving:
            refuse_waiting_plane("serving")
        self._subscriptions: Dict[ClusterEvents, List[SubscriptionCallback]] = {
            event: [] for event in ClusterEvents
        }
        if subscriptions:
            for event, callbacks in subscriptions.items():
                self._subscriptions[event].extend(callbacks)

        # Per-node registry/tracer attached (weakly) to the process-global
        # plane so exporters see every node merged while per-instance
        # snapshot()/get() stay isolated (telemetry plane, ARCHITECTURE.md).
        self.metrics = (
            metrics
            if metrics is not None
            else Metrics(parent=global_metrics(), plane="protocol",
                         node=str(my_addr))
        )
        self.tracer = (
            tracer
            if tracer is not None
            else Tracer(parent=global_tracer(), plane="protocol",
                        track=str(my_addr))
        )
        # detection -> decision -> view-installed latency on the scheduler
        # clock (virtual ms under the test harness, wall ms on real deploys)
        self._stable_view = StableViewTimer(
            self.metrics, "protocol", clock=self._scheduler.now_ms
        )
        # forensics plane: this node's hybrid logical clock (None keeps the
        # pre-forensics path byte-for-byte; outbound stamping happens in the
        # HlcStampingClient wrapper the builder installs, inbound merging in
        # handle_message below)
        self._hlc = hlc
        # the latest evidence bundle captured by an automatic trigger
        # (slo_burn today); Cluster.capture_bundle / agent --bundle-out
        # read it so an operator can fetch what the alert pinned
        self.last_bundle: Optional[Dict[str, object]] = None
        # bounded black-box journal of membership-relevant events, served
        # via the status RPC and dumpable on crash/exit; journal entries are
        # HLC-stamped when the forensics plane is on
        self.recorder = (
            recorder
            if recorder is not None
            else FlightRecorder(
                node=str(my_addr), clock=self._scheduler.now_ms,
                capacity=(settings.forensics.journal_capacity
                          if settings.forensics.enabled
                          else DEFAULT_JOURNAL_CAPACITY),
                hlc=hlc, metrics=self.metrics,
            )
        )
        # profiling plane: a metric history ring over this node's registry,
        # snapshotted opportunistically from the status RPC and served as
        # ClusterStatusResponse.history (settings.profiling is the kill
        # switch; None keeps the response field empty for old goldens)
        self._history: Optional[MetricsHistory] = None
        if settings.profiling.enabled:
            self._history = MetricsHistory(
                self.metrics,
                interval_s=settings.profiling.history_interval_ms / 1000.0,
                capacity=settings.profiling.history_capacity,
            )
        # SLO plane: online SLIs + multi-window burn-rate alerts over the
        # serving path, fed from _handle_serving on the scheduler clock and
        # digested into the status RPC (settings.slo is the kill switch;
        # None reproduces the exact pre-SLO path)
        self._slo: Optional[SloPlane] = None
        if settings.slo.enabled:
            self._slo = SloPlane(
                settings.slo, metrics=self.metrics, recorder=self.recorder
            )
            if settings.forensics.enabled:
                # forensics trigger: a burn alert firing pins a local-only
                # evidence bundle at the moment of the transition
                self._slo.on_transition = self._on_slo_transitions
        # the trace context of the churn this node is currently working on:
        # minted by the local fd_signal root or adopted from the first
        # traced alert/vote, carried onto outgoing alerts and the eventual
        # view_change span, cleared when the view installs. One Optional --
        # duplicated or reordered deliveries re-adopt idempotently (same
        # trace id) and can never grow state.
        self._churn_ctx: Optional[TraceContext] = None
        self._cut_detection.bind_telemetry(self.metrics, self.tracer)
        self._joiners_to_respond_to: Dict[Endpoint, List[Promise]] = {}
        self._joiner_uuid: Dict[Endpoint, NodeId] = {}
        self._joiner_metadata: Dict[Endpoint, FrozenMetadata] = {}
        self._announced_proposal = False
        # a decided proposal refused for missing joiner identities (the UP
        # alerts lost a race against the quorum of votes); retried when the
        # alerts land -- see _decide_view_change / _handle_batched_alerts
        self._pending_decision: Optional[List[Endpoint]] = None
        self._alert_send_queue: List[AlertMessage] = []
        self._last_enqueue_ms = -1
        self._failure_detector_jobs: List[ScheduledTask] = []
        self._shut_down = False

        self._alert_batcher_job = self._scheduler.schedule_at_fixed_rate(
            0, settings.batching_window_ms, self._alert_batcher_tick
        )
        self._broadcaster.set_membership(self._view.get_ring(0))
        self._fast_paxos = self._new_fast_paxos()
        self._create_failure_detectors()

        # Placement plane: a deterministic shard map recomputed at every
        # view install from (config id, sorted view, metadata weights, seed)
        # -- pure function of state every member agrees on, so no messages.
        self._placement = PlacementEngine(placement) if placement else None

        # Initial VIEW_CHANGE callbacks: start/join completed
        # (MembershipService.java:162-165)
        configuration_id = self._view.get_current_configuration_id()
        initial = [
            NodeStatusChange(node, EdgeStatus.UP, self._metadata_manager.get(node))
            for node in self._view.get_ring(0)
        ]
        self._fire(ClusterEvents.VIEW_CHANGE, configuration_id, initial)
        self._update_placement(configuration_id)

    # ------------------------------------------------------------------ #
    # Message dispatch (MembershipService.java:171-193)
    # ------------------------------------------------------------------ #

    def handle_message(self, msg: RapidMessage) -> Promise:
        name = type(msg).__name__
        if isinstance(msg, GossipEnvelope) and msg.kind != GossipEnvelope.KIND_PAYLOAD:
            # payload-free anti-entropy control frames (IHAVE/PULL) are
            # counted apart: the redundancy measurement in
            # experiments/message_load.py compares payload receptions
            name += ".control"
        self.metrics.incr(f"messages.{name}")
        if self._hlc is not None:
            # HLC receive rule: fold the sender's stamp into the local clock
            # before any handler records journal events for this message, so
            # effects are always HLC-after their cause across nodes
            stamp = hlc_of(msg)
            if stamp is not None:
                self._hlc.merge(stamp)
        if isinstance(msg, PreJoinMessage):
            return self._handle_pre_join(msg)
        if isinstance(msg, JoinMessage):
            return self._handle_join(msg)
        if isinstance(msg, BatchedAlertMessage):
            return self._handle_batched_alerts(msg)
        if isinstance(msg, ProbeMessage):
            return Promise.completed(ProbeResponse())
        if isinstance(msg, CONSENSUS_MESSAGE_TYPES):
            return self._handle_consensus(msg)
        if isinstance(msg, FastRoundVoteBatch):
            return self._handle_vote_batch(msg)
        if isinstance(msg, LeaveMessage):
            self._edge_failure_notification(
                msg.sender, self._view.get_current_configuration_id()
            )
            return Promise.completed(Response())
        if isinstance(msg, ClusterStatusRequest):
            return self._handle_cluster_status(msg)
        if isinstance(msg, GossipEnvelope):
            return self._handle_gossip(msg)
        if isinstance(msg, HandoffRequest):
            return self._handle_handoff_request(msg)
        if isinstance(msg, HandoffAck):
            return self._handle_handoff_ack(msg)
        if isinstance(msg, (Get, Put)):
            return self._handle_serving(msg)
        if isinstance(msg, (CellDigestMessage, GlobalViewMessage)):
            return self._handle_hierarchy(msg)
        if isinstance(msg, MessageBatch):
            return self._handle_message_batch(msg)
        raise TypeError(f"unidentified request type {type(msg).__name__}")

    def _handle_hierarchy(self, msg: RapidMessage) -> Promise:
        """Hierarchy-plane traffic (a peer leader's cell digest, or a
        leader's composed global view). A member without the plane -- every
        port member -- acks and drops it, so a hierarchical peer's stray
        frame cannot poison dispatch."""
        return Promise.completed(Response())

    def _handle_message_batch(self, batch: MessageBatch) -> Promise:
        """Unpack a transport batch envelope (a broadcaster's flush window,
        messaging/unicast.py BatchingSink): dispatch each inner message
        exactly as if it had arrived alone, ack the envelope. Inner
        responses are dropped -- batched sends are fire-and-forget
        broadcasts. The native codec carries only the envelope's trace
        context, so inners that lost their own stamp adopt it (the gossip
        receive() discipline)."""
        ctx = trace_context_of(batch)
        hlc_stamp = hlc_of(batch)
        for inner in batch.messages:
            if ctx is not None and trace_context_of(inner) is None:
                stamp_trace_context(inner, ctx)
            if hlc_stamp is not None and hlc_of(inner) is None:
                # the native codec carries only the envelope's HLC stamp;
                # inners adopt it exactly like the trace context above
                stamp_hlc(inner, hlc_stamp)
            try:
                self.handle_message(inner)
            except Exception:  # noqa: BLE001 -- one poisoned inner message
                # must not sink the rest of the batch (the unbatched
                # equivalent fails one frame, not a window's traffic)
                LOG.exception("batched message dispatch failed")
        return Promise.completed(Response())

    def _handle_serving(self, msg: RapidMessage) -> Promise:
        """Serving-plane Get/Put. A member without the serving plane --
        every port member -- tells the client to retry elsewhere rather
        than hang its request."""
        key = getattr(msg, "key", b"")
        return Promise.completed(PutAck(
            sender=self._my_addr, status=PutAck.STATUS_RETRY, key=key,
            request_id=getattr(msg, "request_id", 0),
        ))

    def _handle_handoff_request(self, msg: HandoffRequest) -> Promise:
        """A pulling new owner's chunk request. A member without the handoff
        plane answers an empty Response, so the puller fails over to its
        next source rather than hang."""
        return Promise.completed(Response())

    def _handle_handoff_ack(self, msg: HandoffAck) -> Promise:
        """A new owner's verified-copy ack: with no handoff plane there is
        no copy to release; acked on the protocol executor, as the plane
        would."""
        future: Promise = Promise()
        self._resources.protocol_executor.execute(
            lambda: future.set_result(Response())
        )
        return future

    def _handle_cluster_status(self, msg: ClusterStatusRequest) -> Promise:
        """Introspection RPC: snapshot protocol state on the protocol
        executor (the one thread that mutates it), so the answer is a
        consistent cut even while consensus is in flight."""
        future: Promise = Promise()

        def task() -> None:
            self.recorder.record("status_served", requester=str(msg.sender))
            future.set_result(
                self.cluster_status(include_history=msg.include_history)
            )

        self._resources.protocol_executor.execute(task)
        return future

    def cluster_status(self, include_history: int = 0) -> ClusterStatusResponse:
        """The local introspection snapshot (also reachable without the RPC:
        Cluster.get_cluster_status). Only call on the protocol executor or
        from a quiesced cluster. ``include_history`` bounds how many metric
        history-ring snapshots ride along (0 = none)."""
        occupancy = self._cut_detection.occupancy()
        digest = sorted(self.metrics.snapshot().items())
        # transport-plane digest (per-peer outbound queue depths) rides the
        # same metric_names/metric_values streams, so statusz renders it
        # with zero schema changes
        transport_digest = getattr(self._client, "transport_digest", None)
        if transport_digest is not None:
            digest.extend(sorted(transport_digest().items()))
        pmap = self.placement_map()
        # the handoff, durability, serving and hierarchy digests stay at
        # their zero/empty defaults: no port member runs those planes.
        # Failure-detector plane: per-edge RTT/suspicion digest (worst
        # first) and, when the adaptive factory is active, the derived
        # per-tier parameters. Integer micro/milli units: the wire schema
        # has no float scalar.
        fd_subjects: Tuple[str, ...] = ()
        fd_rtt_micros: Tuple[int, ...] = ()
        fd_suspicion_milli: Tuple[int, ...] = ()
        fd_tiers: Tuple[str, ...] = ()
        fd_tier_interval_ms: Tuple[int, ...] = ()
        fd_tier_threshold: Tuple[int, ...] = ()
        fd_tier_flush_ms: Tuple[int, ...] = ()
        edge_digest = getattr(self._fd_factory, "edge_digest", None)
        if edge_digest is not None:
            rows = edge_digest()
            fd_subjects = tuple(r[0] for r in rows)
            fd_rtt_micros = tuple(
                int(round((r[1] if r[1] is not None else 0.0) * 1000))
                for r in rows
            )
            fd_suspicion_milli = tuple(
                int(round(r[2] * 1000)) for r in rows
            )
        # profiling plane: every status call opportunistically ticks the
        # history ring (scrape cadence IS the snapshot cadence, rate-limited
        # by the ring's own interval), then ships the requested tail
        history: Tuple[str, ...] = ()
        if self._history is not None:
            self._history.maybe_snapshot(self._scheduler.now_ms() / 1000.0)
            if include_history > 0:
                history = self._history.to_wire(include_history)
        tier_params = getattr(self._fd_factory, "tier_params", None)
        if tier_params is not None:
            tiers = tier_params()
            fd_tiers = tuple(t[0] for t in tiers)
            fd_tier_interval_ms = tuple(int(t[1]) for t in tiers)
            fd_tier_threshold = tuple(int(t[2]) for t in tiers)
            fd_tier_flush_ms = tuple(int(t[3]) for t in tiers)
        # SLO plane digest: the status scrape doubles as an alert-evaluation
        # tick (forced past the rate limit so a quiet node still clears),
        # and firing alerts are attributed against this node's own journal
        slo_names: Tuple[str, ...] = ()
        slo_burn_milli: Tuple[int, ...] = ()
        slo_firing: Tuple[int, ...] = ()
        slo_attributed_trace: Tuple[int, ...] = ()
        if self._slo is not None:
            self._slo.tick(self._scheduler.now_ms(), force=True)
            self._slo.attribute(self.recorder.tail(64))
            (slo_names, slo_burn_milli, slo_firing,
             slo_attributed_trace) = self._slo.status_digest()
        # forensics plane: journal truncation counters plus this node's
        # current HLC coordinate (all zero pre-forensics -- old peers and
        # goldens see their exact old shape)
        hlc_physical_ms = hlc_logical = hlc_incarnation = 0
        if self._hlc is not None:
            hlc_stamp = self._hlc.peek()
            hlc_physical_ms = hlc_stamp.physical_ms
            hlc_logical = hlc_stamp.logical
            hlc_incarnation = hlc_stamp.incarnation
        return ClusterStatusResponse(
            sender=self._my_addr,
            configuration_id=self._view.get_current_configuration_id(),
            membership_size=self._view.membership_size,
            reports_tracked=occupancy["reports_tracked"],
            pre_proposal_size=occupancy["pre_proposal_size"],
            proposal_size=occupancy["proposal_size"],
            updates_in_progress=occupancy["updates_in_progress"],
            consensus_decided=self._fast_paxos.decided,
            consensus_votes=self._fast_paxos.votes_received,
            metric_names=tuple(name for name, _ in digest),
            metric_values=tuple(value for _, value in digest),
            journal=self.recorder.to_wire(32),
            placement_version=pmap.version if pmap is not None else 0,
            placement_partitions=(
                pmap.config.partitions if pmap is not None else 0
            ),
            placement_owned=(
                len(pmap.owned(self._my_addr)) if pmap is not None else 0
            ),
            fd_subjects=fd_subjects,
            fd_rtt_micros=fd_rtt_micros,
            fd_suspicion_milli=fd_suspicion_milli,
            fd_tiers=fd_tiers,
            fd_tier_interval_ms=fd_tier_interval_ms,
            fd_tier_threshold=fd_tier_threshold,
            fd_tier_flush_ms=fd_tier_flush_ms,
            history=history,
            slo_names=slo_names,
            slo_burn_milli=slo_burn_milli,
            slo_firing=slo_firing,
            slo_attributed_trace=slo_attributed_trace,
            journal_dropped=int(getattr(self.recorder, "dropped", 0)),
            journal_capacity=int(getattr(self.recorder, "capacity", 0)),
            hlc_physical_ms=hlc_physical_ms,
            hlc_logical=hlc_logical,
            hlc_incarnation=hlc_incarnation,
        )

    @property
    def hierarchy(self) -> None:
        """The hierarchy plane: always None on a port member (the plane is
        refused at construction until it is ported)."""
        return None

    # ------------------------------------------------------------------ #
    # Forensics plane (forensics/, tools/forensics.py)
    # ------------------------------------------------------------------ #

    def _local_record(self) -> Dict[str, object]:
        """This node's member record, assembled straight from the plane
        objects -- never via the status RPC, so a capture triggered from
        inside the SLO/status path cannot recurse. Safe on any thread (the
        recorder locks; everything else is a snapshot read)."""
        return capture_local_evidence(
            node=str(self._my_addr),
            recorder=self.recorder,
            metrics=self.metrics,
            tracer=self.tracer,
            slo=self._slo,
            hlc=self._hlc,
            configuration_id=self._view.get_current_configuration_id(),
            membership_size=self._view.membership_size,
            durability=None,  # no durable store on a port member
            history=self._history,
            journal_tail=self._settings.forensics.bundle_journal_tail,
            history_tail=self._settings.forensics.bundle_history_tail,
        )

    def local_evidence(self, trigger: str = "explicit",
                       detail: Optional[Dict[str, object]] = None,
                       ) -> Dict[str, object]:
        """A local-only evidence bundle (the automatic-trigger form)."""
        return build_bundle(trigger, self._local_record(), detail=detail)

    def capture_cluster_bundle_async(
        self, trigger: str = "explicit",
        detail: Optional[Dict[str, object]] = None,
    ) -> Promise:
        """Cluster-wide evidence capture: the local record plus a status-RPC
        sweep of every other member. A callback state machine (never blocks,
        so it works under virtual time exactly like ``join_async``): the
        bundle completes when every member answered or the scheduler-clock
        deadline (``forensics.bundle_member_timeout_ms``) fires, whichever
        is first -- members still pending at the deadline are recorded as
        unreachable, so a partitioned cluster still yields a bundle naming
        who was missing."""
        from .forensics.bundle import status_to_record, unreachable_record

        local = self._local_record()
        result: Promise = Promise()
        futures: List[Tuple[Endpoint, Promise]] = []
        for member in self._view.get_ring(0):
            if member == self._my_addr:
                continue
            request = ClusterStatusRequest(
                sender=self._my_addr,
                include_history=self._settings.forensics.bundle_history_tail,
            )
            futures.append(
                (member, self._client.send_message(member, request))
            )
        state = {"remaining": len(futures), "finished": False}
        lock = make_lock("MembershipService.capture_bundle.lock")

        def finish() -> None:
            members: List[Dict[str, object]] = []
            for member, future in futures:
                if not future.done():
                    members.append(unreachable_record(
                        str(member), "status deadline exceeded"
                    ))
                elif future.exception() is not None:
                    members.append(unreachable_record(
                        str(member), str(future.exception())
                    ))
                else:
                    status = future.peek()
                    if isinstance(status, ClusterStatusResponse):
                        members.append(status_to_record(status))
                    else:
                        members.append(unreachable_record(
                            str(member),
                            f"unexpected response {type(status).__name__}",
                        ))
            bundle = build_bundle(
                trigger, local, members=members, detail=detail
            )
            self.last_bundle = bundle
            self.recorder.record(
                "bundle_captured", trigger=trigger,
                fingerprint=str(bundle["manifest"]["fingerprint"])[:12],  # type: ignore[index]
                events=int(bundle["manifest"]["events"]),  # type: ignore[index]
            )
            result.set_result(bundle)

        def maybe_finish(last: bool) -> None:
            with lock:
                if state["finished"]:
                    return
                if last:
                    state["remaining"] -= 1
                    if state["remaining"] > 0:
                        return
                state["finished"] = True
            finish()

        for _member, future in futures:
            future.add_callback(lambda _p: maybe_finish(True))
        self._scheduler.schedule(
            self._settings.forensics.bundle_member_timeout_ms,
            lambda: maybe_finish(False),
        )
        if not futures:
            maybe_finish(False)
        return result

    def capture_cluster_bundle(self, trigger: str = "explicit",
                               detail: Optional[Dict[str, object]] = None,
                               timeout: float = 60.0) -> Dict[str, object]:
        """Blocking wrapper for real-time mode (virtual-time callers drive
        the async form). Never call on the protocol executor: the member
        responses complete there."""
        return self.capture_cluster_bundle_async(trigger, detail).result(
            timeout
        )

    def _on_slo_transitions(self, transitions) -> None:
        """Burn-alert forensics trigger: the first "fired" transition in a
        tick captures a local-only bundle and journals the capture, so the
        evidence window is pinned at the moment the alert fired rather than
        whenever an operator notices."""
        fired = [alert for kind, alert in transitions if kind == "fired"]
        if not fired:
            return
        bundle = self.local_evidence(
            "slo_burn", detail={"alerts": [a.name for a in fired]},
        )
        self.last_bundle = bundle
        self.recorder.record(
            "bundle_captured", trigger="slo_burn",
            fingerprint=str(bundle["manifest"]["fingerprint"])[:12],  # type: ignore[index]
            events=int(bundle["manifest"]["events"]),  # type: ignore[index]
        )

    # ------------------------------------------------------------------ #
    # Placement plane (placement/engine.py)
    # ------------------------------------------------------------------ #

    def placement_map(self) -> Optional[PlacementMap]:
        """The current deterministic shard map (None unless placement was
        configured); identical on every member of a configuration."""
        return self._placement.map if self._placement is not None else None

    def placement_diff(self) -> Optional[PlacementDiff]:
        """The rebalance plan produced by the latest view change."""
        return self._placement.last_diff if self._placement is not None else None

    def handoff_engine(self) -> None:
        """The live handoff engine: None on a port member (refused)."""
        return None

    def serving_engine(self) -> None:
        """The live serving engine: None on a port member (refused)."""
        return None

    def serving_put(self, key: bytes, value: bytes) -> Promise:
        """Write through the serving plane, which no port member runs."""
        raise RuntimeError("serving is not enabled on this member")

    def serving_get(self, key: bytes) -> Promise:
        """Read through the serving plane, which no port member runs."""
        raise RuntimeError("serving is not enabled on this member")

    def _update_placement(self, configuration_id: int) -> None:
        """Recompute the shard map for the just-installed configuration.

        Runs on the protocol executor inside the view-change path (and once
        at construction), so the map versions advance in lockstep with
        configuration ids on every member. The rebalance span parents under
        the ambient view_change span and therefore joins the churn trace."""
        if self._placement is None:
            return
        members = self._view.get_ring(0)
        cfg = self._placement.config
        weights = {
            node: weight_of(
                self._metadata_manager.get(node), cfg.weight_key,
                cfg.default_weight,
            )
            for node in members
        }
        old_map = self._placement.map
        with self.tracer.span(
            "placement_rebalance", virtual_ms=self._scheduler.now_ms(),
            size=len(members),
        ) as span:
            pmap, diff = self._placement.update(
                configuration_id, members, weights
            )
            span.attrs["version"] = pmap.version
            if diff is not None:
                span.attrs["moved"] = diff.moved
        self.metrics.incr("placement.rebuilds")
        self.metrics.set_gauge("placement.imbalance", pmap.imbalance())
        self.metrics.set_gauge(
            "placement.partitions_owned", len(pmap.owned(self._my_addr))
        )
        if diff is not None:
            self.metrics.observe(
                "placement.partitions_moved", diff.moved,
                buckets=PARTITIONS_MOVED_BUCKETS,
            )
            self.recorder.record(
                "placement_rebalance", configuration_id=configuration_id,
                moved=diff.moved, version=pmap.version,
                handoffs=len(diff.handoffs),
            )

    def _handle_gossip(self, env: GossipEnvelope) -> Promise:
        """Epidemic relay plane: hand the envelope to a gossip-aware
        broadcaster (dedup + re-relay), then dispatch a first-seen payload
        like any directly-received message. Nodes running a non-gossip
        broadcaster acknowledge and drop -- mixed clusters degrade to the
        origin's direct fanout. Serialized on the protocol executor like
        every other substantive handler: the broadcaster's sighting counter
        and rng are not thread-safe, and transport threads deliver
        concurrently."""
        receive = getattr(self._broadcaster, "receive", None)
        if receive is None:
            return Promise.completed(Response())
        future: Promise = Promise()

        def task() -> None:
            payload = receive(env)
            if payload is not None:
                self.handle_message(payload)
            future.set_result(Response())

        self._resources.protocol_executor.execute(task)
        return future

    # ------------------------------------------------------------------ #
    # Join protocol, server side
    # ------------------------------------------------------------------ #

    def _handle_pre_join(self, msg: PreJoinMessage) -> Promise:
        """Phase-1 gatekeeping at a seed (MembershipService.java:200-221)."""
        future: Promise = Promise()

        def task() -> None:
            status = self._view.is_safe_to_join(msg.sender, msg.node_id)
            endpoints: Tuple[Endpoint, ...] = ()
            if status in (
                JoinStatusCode.SAFE_TO_JOIN,
                JoinStatusCode.HOSTNAME_ALREADY_IN_RING,
            ):
                endpoints = tuple(self._view.get_expected_observers_of(msg.sender))
            future.set_result(
                JoinResponse(
                    sender=self._my_addr,
                    status_code=status,
                    configuration_id=self._view.get_current_configuration_id(),
                    endpoints=endpoints,
                )
            )

        self._resources.protocol_executor.execute(task)
        return future

    def _handle_join(self, msg: JoinMessage) -> Promise:
        """Phase-2 at an observer: park the response until the view change
        commits (MembershipService.java:229-286)."""
        future: Promise = Promise()

        def task() -> None:
            current_configuration = self._view.get_current_configuration_id()
            if current_configuration == msg.configuration_id:
                self._joiners_to_respond_to.setdefault(msg.sender, []).append(future)
                alert = AlertMessage(
                    edge_src=self._my_addr,
                    edge_dst=msg.sender,
                    edge_status=EdgeStatus.UP,
                    configuration_id=current_configuration,
                    ring_numbers=msg.ring_numbers,
                    node_id=msg.node_id,
                    metadata=msg.metadata,
                )
                self._enqueue_alert(alert)
            else:
                # Configuration changed between join phases 1 and 2.
                config = self._view.get_configuration()
                if self._view.is_host_present(msg.sender) and self._view.is_identifier_present(
                    msg.node_id
                ):
                    # The cut already admitted this joiner; stream the config.
                    future.set_result(self._make_join_response(JoinStatusCode.SAFE_TO_JOIN))
                else:
                    future.set_result(
                        JoinResponse(
                            sender=self._my_addr,
                            status_code=JoinStatusCode.CONFIG_CHANGED,
                            configuration_id=config.configuration_id,
                        )
                    )

        self._resources.protocol_executor.execute(task)
        return future

    def _make_join_response(self, status: JoinStatusCode) -> JoinResponse:
        config = self._view.get_configuration()
        return JoinResponse(
            sender=self._my_addr,
            status_code=status,
            configuration_id=config.configuration_id,
            endpoints=config.endpoints,
            identifiers=config.node_ids,
            metadata=tuple(self._metadata_manager.get_all_metadata().items()),
        )

    # ------------------------------------------------------------------ #
    # Alerts -> cut detection -> consensus (MembershipService.java:297-348)
    # ------------------------------------------------------------------ #

    def _handle_batched_alerts(self, batch: BatchedAlertMessage) -> Promise:
        future: Promise = Promise()
        ctx = trace_context_of(batch)

        def task() -> None:
            if (
                ctx is not None
                and self._churn_ctx is None
                and any(
                    m.configuration_id
                    == self._view.get_current_configuration_id()
                    for m in batch.messages
                )
            ):
                # adopt the sender's churn trace so this node's own alerts,
                # votes, and eventual view_change carry the same trace id.
                # Idempotent under nemesis duplication/reordering, and gated
                # on a current-configuration alert so a stale duplicate
                # delivered AFTER the install cannot re-arm a completed
                # trace onto the next churn.
                self._churn_ctx = ctx
            self.recorder.record(
                "alert_in", sender=str(batch.sender),
                alerts=len(batch.messages),
            )
            with self.tracer.remote_span(
                "alert_batch", ctx=ctx, virtual_ms=self._scheduler.now_ms(),
                alerts=len(batch.messages),
            ):
                self._handle_batched_alerts_task(batch)
            future.set_result(Response())

        self._resources.protocol_executor.execute(task)
        return future

    def _handle_batched_alerts_task(self, batch: BatchedAlertMessage) -> None:
        current_configuration_id = self._view.get_current_configuration_id()
        membership_size = self._view.membership_size
        valid_alerts = [
            self._extract_joiner_details(msg)
            for msg in batch.messages
            if self._filter_alert(msg, membership_size, current_configuration_id)
        ]
        if valid_alerts:
            # first admissible evidence of membership churn in this
            # configuration starts the time-to-stable-view clock
            self._stable_view.detection()
        pending = self._pending_decision
        if pending is not None and all(
            self._view.is_host_present(node) or node in self._joiner_uuid
            for node in pending
        ):
            # the refused decision's missing joiner identities have now
            # arrived: apply the parked view change
            LOG.info(
                "%s: joiner identities arrived; applying the parked "
                "view change", self._my_addr,
            )
            self._pending_decision = None
            self._decide_view_change(pending)
            return
        if self._announced_proposal:
            # We already initiated consensus and cannot go back on it.
            return
        proposal: Set[Endpoint] = set()
        for alert in valid_alerts:
            proposal.update(self._cut_detection.aggregate_for_proposal(alert))
        proposal.update(self._cut_detection.invalidate_failing_edges(self._view))
        if proposal:
            self._announced_proposal = True
            self.metrics.incr("proposals")
            self.tracer.event(
                "proposal", virtual_ms=self._scheduler.now_ms(),
                size=len(proposal),
                configuration_id=current_configuration_id,
            )
            self.recorder.record(
                "proposal", size=len(proposal),
                configuration_id=current_configuration_id,
            )
            changes = self._node_status_changes(proposal)
            self._fire(
                ClusterEvents.VIEW_CHANGE_PROPOSAL, current_configuration_id, changes
            )
            self._fast_paxos.propose(sorted(proposal, key=address_comparator_key))

    def _filter_alert(
        self, alert: AlertMessage, membership_size: int, current_configuration_id: int
    ) -> bool:
        """Drop stale/invariant-violating alerts (MembershipService.java:633-664)."""
        if alert.configuration_id != current_configuration_id:
            if alert.edge_status == EdgeStatus.UP:
                LOG.debug(
                    "%s: dropping stale UP alert for %s (alert config %d, "
                    "current %d)",
                    self._my_addr, alert.edge_dst, alert.configuration_id,
                    current_configuration_id,
                )
            return False
        if alert.edge_status == EdgeStatus.UP and self._view.is_host_present(alert.edge_dst):
            LOG.debug(
                "%s: dropping UP alert for already-present %s",
                self._my_addr, alert.edge_dst,
            )
            return False
        if alert.edge_status == EdgeStatus.DOWN and not self._view.is_host_present(
            alert.edge_dst
        ):
            return False
        return True

    def _extract_joiner_details(self, alert: AlertMessage) -> AlertMessage:
        """Stash joiner UUID/metadata for the eventual ringAdd
        (MembershipService.java:666-674)."""
        if alert.edge_status == EdgeStatus.UP:
            assert alert.node_id is not None
            self._joiner_uuid[alert.edge_dst] = alert.node_id
            self._joiner_metadata[alert.edge_dst] = alert.metadata
        return alert

    def _adopt_churn_ctx(self, msg: RapidMessage) -> None:
        """Adopt an incoming message's trace context as this node's churn
        trace if it has none yet (a node can learn of churn from a quorum of
        votes before -- or instead of -- any alert). Messages from another
        configuration never adopt: a reordered or duplicated vote surfacing
        after the install must not tag the next churn with a finished
        trace."""
        if self._churn_ctx is None:
            config = getattr(
                msg, "configuration_id",
                self._view.get_current_configuration_id(),
            )
            if config != self._view.get_current_configuration_id():
                return
            ctx = trace_context_of(msg)
            if ctx is not None:
                self._churn_ctx = ctx

    def _handle_consensus(self, msg: RapidMessage) -> Promise:
        future: Promise = Promise()

        def task() -> None:
            self._adopt_churn_ctx(msg)
            future.set_result(self._fast_paxos.handle_messages(msg))

        self._resources.protocol_executor.execute(task)
        return future

    def _handle_vote_batch(self, batch: FastRoundVoteBatch) -> Promise:
        """Tally a transport-batched quorum of identical-value votes in ONE
        protocol task (posting thousands of single-vote tasks would
        serialize through the executor queue); ``FastPaxos.handle_vote_batch``
        gives what one vote at a time would."""
        future: Promise = Promise()

        def task() -> None:
            self._adopt_churn_ctx(batch)
            self._fast_paxos.handle_vote_batch(batch)
            future.set_result(ConsensusResponse())

        self._resources.protocol_executor.execute(task)
        return future

    # ------------------------------------------------------------------ #
    # View-change application (MembershipService.java:379-433)
    # ------------------------------------------------------------------ #

    def _decide_view_change(self, proposal: List[Endpoint]) -> None:
        self.recorder.record("decision", size=len(proposal))
        # the view_change span joins the churn's cross-node trace: same
        # trace id as the fd_signal on whichever node detected the failure
        # (ctx=None -- untraced churn -- degrades to a local root span)
        with self.tracer.remote_span(
            "view_change", ctx=self._churn_ctx,
            virtual_ms=self._scheduler.now_ms(),
            size=len(proposal),
        ):
            self._decide_view_change_locked(proposal)

    def _decide_view_change_locked(self, proposal: List[Endpoint]) -> None:
        self._stable_view.decision()
        # A decided proposal can reference a joiner whose UUID-carrying UP
        # alerts this node never processed (every alert delivery is
        # best-effort; the quorum of votes can arrive anyway). Applying a
        # partial view change would silently fork this node's configuration
        # id; the reference would NPE here (its assert at
        # MembershipService.java:396 is disabled at runtime and
        # joinerUuid.remove returns null). Instead: refuse the whole view
        # change and stay on the current configuration -- Rapid's answer to
        # a node that falls behind is removal and rejoin, and the stale
        # traffic this node keeps emitting triggers exactly that repair.
        missing = [
            node for node in proposal
            if not self._view.is_host_present(node)
            and node not in self._joiner_uuid
        ]
        if missing:
            self.metrics.incr("view_changes_refused_missing_identity")
            self.recorder.record(
                "view_refused", missing=[str(node) for node in missing],
            )
            LOG.error(
                "%s: refusing view change at config %d: no joiner identity "
                "for %s (UP alerts lost); parked until the alerts land, "
                "else removal+rejoin",
                self._my_addr, self._view.get_current_configuration_id(),
                [str(node) for node in missing],
            )
            # park, don't drop: this configuration's FastPaxos has decided
            # and will never re-fire, so if the UUID-carrying alerts arrive
            # a moment after the quorum of votes (every delivery is
            # best-effort and independently ordered), only this parked
            # proposal can still apply the view change
            # (_handle_batched_alerts retries it once identities are known)
            self._pending_decision = list(proposal)
            return
        self._pending_decision = None
        self._cancel_failure_detectors()
        status_changes: List[NodeStatusChange] = []
        for node in proposal:
            if self._view.is_host_present(node):
                self._view.ring_delete(node)
                status_changes.append(
                    NodeStatusChange(node, EdgeStatus.DOWN, self._metadata_manager.get(node))
                )
                self._metadata_manager.remove_node(node)
            else:
                node_id = self._joiner_uuid.pop(node)
                self._view.ring_add(node, node_id)
                metadata = self._joiner_metadata.pop(node, ())
                if metadata:
                    self._metadata_manager.add_metadata({node: metadata})
                status_changes.append(NodeStatusChange(node, EdgeStatus.UP, metadata))

        configuration_id = self._view.get_current_configuration_id()
        self.metrics.incr("view_changes")
        self.recorder.record(
            "view_install", configuration_id=configuration_id,
            size=self._view.membership_size,
        )
        self._fire(ClusterEvents.VIEW_CHANGE, configuration_id, status_changes)
        self._update_placement(configuration_id)
        self._stable_view.view_installed()

        self._cut_detection.clear()
        self._announced_proposal = False
        self._churn_ctx = None  # this churn's trace is complete
        self._fast_paxos = self._new_fast_paxos()
        self._broadcaster.set_membership(self._view.get_ring(0))

        if self._view.is_host_present(self._my_addr):
            self._create_failure_detectors()
        else:
            # We were removed: gracefully self-evict.
            self.recorder.record("kicked", configuration_id=configuration_id)
            self._fire(ClusterEvents.KICKED, configuration_id, status_changes)

        self._respond_to_joiners(proposal)

    def _new_fast_paxos(self) -> FastPaxos:
        return FastPaxos(
            self._my_addr,
            self._view.get_current_configuration_id(),
            self._view.membership_size,
            self._client,
            self._broadcaster,
            self._scheduler,
            self._on_consensus_decide,
            consensus_fallback_base_delay_ms=self._settings.consensus_fallback_base_delay_ms,
            rng=self._rng,
            metrics=self.metrics,
            tracer=self.tracer,
            serialize=self._resources.protocol_executor.execute,
        )

    def _on_consensus_decide(self, proposal: List[Endpoint]) -> None:
        # Decisions may surface from within a protocol task (message handling)
        # -- re-serialize onto the protocol executor.
        self._resources.protocol_executor.execute(
            lambda: self._decide_view_change(proposal)
        )

    def _respond_to_joiners(self, proposal: List[Endpoint]) -> None:
        """Unblock parked phase-2 join futures with the new configuration
        (MembershipService.java:708-733)."""
        response = self._make_join_response(JoinStatusCode.SAFE_TO_JOIN)
        for node in proposal:
            futures = self._joiners_to_respond_to.pop(node, None)
            if futures:
                for future in futures:
                    self._scheduler.execute(
                        lambda f=future: f.try_set_result(response)
                    )

    # ------------------------------------------------------------------ #
    # Failure detection (MembershipService.java:461-484, 686-703)
    # ------------------------------------------------------------------ #

    def _edge_failure_notification(self, subject: Endpoint, configuration_id: int) -> None:
        def task() -> None:
            if configuration_id != self._view.get_current_configuration_id():
                return  # stale notification from an old configuration
            if not self._view.is_host_present(subject):
                return
            self.metrics.incr("fd.edge_failures")
            signal = self.tracer.event(
                "fd_signal", virtual_ms=self._scheduler.now_ms(),
                subject=str(subject),
            )
            self.recorder.record("fd_signal", subject=str(subject))
            if self._churn_ctx is None:
                # this node detected the churn: its fd_signal roots the
                # cross-node trace every downstream alert/vote/view_change
                # will carry
                self._churn_ctx = TraceContext(
                    trace_id=signal.trace_id or signal.span_id,
                    parent_span_id=signal.span_id,
                    origin=str(self._my_addr),
                )
            self._stable_view.detection()
            alert = AlertMessage(
                edge_src=self._my_addr,
                edge_dst=subject,
                edge_status=EdgeStatus.DOWN,
                configuration_id=configuration_id,
                ring_numbers=tuple(self._view.get_ring_numbers(self._my_addr, subject)),
            )
            self._enqueue_alert(alert)

        self._resources.protocol_executor.execute(task)

    def _create_failure_detectors(self) -> None:
        try:
            subjects = self._view.get_subjects_of(self._my_addr)
        except Exception:  # not in the ring (shouldn't happen; be safe)
            subjects = []
        begin = getattr(self._fd_factory, "begin_configuration", None)
        if begin is not None:
            begin(tuple(subjects))
        interval_for = getattr(self._fd_factory, "interval_ms_for", None)
        for subject in subjects:
            config_id = self._view.get_current_configuration_id()
            notifier = (
                lambda s=subject, c=config_id: self._edge_failure_notification(s, c)
            )
            runnable = self._fd_factory.create_instance(subject, notifier)
            interval_ms = self._settings.failure_detector_interval_ms
            if interval_for is not None:
                # adaptive factories probe per-tier: LAN edges faster than
                # the static default, WAN edges slower (monitoring/adaptive)
                interval_ms = interval_for(subject, interval_ms)
            job = self._scheduler.schedule_at_fixed_rate(
                0, interval_ms, runnable
            )
            self._failure_detector_jobs.append(job)

    def _cancel_failure_detectors(self) -> None:
        for job in self._failure_detector_jobs:
            job.cancel()
        self._failure_detector_jobs.clear()

    # ------------------------------------------------------------------ #
    # Alert batching (MembershipService.java:561-626)
    # ------------------------------------------------------------------ #

    def _enqueue_alert(self, msg: AlertMessage) -> None:
        self.metrics.incr("alerts_enqueued")
        self._last_enqueue_ms = self._scheduler.now_ms()
        self.tracer.event(
            "alert_enqueued", virtual_ms=self._last_enqueue_ms,
            dst=str(msg.edge_dst), status=msg.edge_status.name,
        )
        stamp_trace_context(msg, self._churn_ctx)
        self._alert_send_queue.append(msg)

    def _alert_batcher_tick(self) -> None:
        """Quiescence-based flush: only send once a full batching window has
        passed since the last enqueue (MembershipService.java:602-626).

        The tick fires on the scheduler's timer thread in real deployments
        while _enqueue_alert appends on the protocol executor; the
        check-and-flush body hops onto the executor so the queue is only
        ever touched from one context."""
        self._resources.protocol_executor.execute(self._alert_batcher_flush)

    def _alert_batcher_flush(self) -> None:
        if not self._alert_send_queue or self._last_enqueue_ms < 0:
            return
        window_ms = self._settings.batching_window_ms
        flush_for = getattr(self._fd_factory, "flush_window_ms", None)
        if flush_for is not None:
            # adaptive factories shrink the window while a gray alert is
            # pending so the cut detector hears about it promptly
            window_ms = flush_for(window_ms)
        if self._scheduler.now_ms() - self._last_enqueue_ms <= window_ms:
            return
        messages = tuple(self._alert_send_queue)
        self._alert_send_queue.clear()
        batch = BatchedAlertMessage(sender=self._my_addr, messages=messages)
        # the flush runs on a timer tick with no ambient span, so the batch
        # carries the churn trace explicitly (falling back to whatever the
        # first traced alert carried)
        ctx = self._churn_ctx
        if ctx is None:
            ctx = next(
                (c for c in map(trace_context_of, messages) if c is not None),
                None,
            )
        stamp_trace_context(batch, ctx)
        self.recorder.record("alert_out", alerts=len(messages))
        self._broadcaster.broadcast(batch)

    # ------------------------------------------------------------------ #
    # Public surface
    # ------------------------------------------------------------------ #

    def get_membership_view(self) -> List[Endpoint]:
        return self._view.get_ring(0)

    @property
    def membership_size(self) -> int:
        return self._view.membership_size

    def get_metadata(self) -> Dict[Endpoint, FrozenMetadata]:
        return self._metadata_manager.get_all_metadata()

    def get_current_configuration_id(self) -> int:
        return self._view.get_current_configuration_id()

    def register_subscription(
        self, event: ClusterEvents, callback: SubscriptionCallback
    ) -> None:
        self._subscriptions[event].append(callback)

    def leave_async(self) -> Promise:
        """Proactively trigger DOWN alerts at our observers
        (MembershipService.java:534-554); completes when observers answered
        or the leave timeout passed."""
        done: Promise = Promise()
        try:
            observers = self._view.get_observers_of(self._my_addr)
        except Exception:  # already removed: nothing to announce
            done.set_result(None)
            return done
        leave = LeaveMessage(sender=self._my_addr)
        responses = successful_as_list(
            [self._client.send_message_best_effort(obs, leave) for obs in observers]
        )
        responses.add_callback(lambda _: done.try_set_result(None))
        self._scheduler.schedule(
            self._settings.leave_message_timeout_ms,
            lambda: done.try_set_result(None),
        )
        return done

    def shutdown(self) -> None:
        if self._shut_down:
            return
        self._shut_down = True
        self._alert_batcher_job.cancel()
        # _failure_detector_jobs is only ever touched on the protocol
        # executor (_create_failure_detectors runs there); keep shutdown's
        # cancel on the same context instead of racing it from the caller's
        # thread. SharedResources.shutdown drains the executor afterwards.
        self._resources.protocol_executor.execute(self._cancel_failure_detectors)
        self._client.shutdown()

    # ------------------------------------------------------------------ #

    def _node_status_changes(self, proposal) -> List[NodeStatusChange]:
        return [
            NodeStatusChange(
                node,
                EdgeStatus.DOWN if self._view.is_host_present(node) else EdgeStatus.UP,
                self._metadata_manager.get(node),
            )
            for node in sorted(proposal, key=address_comparator_key)
        ]

    def _fire(
        self, event: ClusterEvents, configuration_id: int, changes: List[NodeStatusChange]
    ) -> None:
        for callback in self._subscriptions[event]:
            callback(configuration_id, changes)
