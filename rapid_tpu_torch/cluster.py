"""The public API: build, start, or join a cluster node.

The port's own copy of ``rapid_tpu/cluster.py``, with every plane the JAX
member has: placement, handoff, durability, serving, hierarchy, SLO,
profiling history and forensics.

Reference: Cluster.java. ``Cluster.Builder(addr).start()`` bootstraps a seed;
``.join(seed)`` runs the two-phase join protocol with up to RETRIES attempts
(Cluster.java:303-344): phase 1 asks a seed for the configuration and the K
expected observers; phase 2 asks those observers to vouch for the joiner, and
the response arrives only after the resulting view change commits.

Protocol constants K=10, H=9, L=4, RETRIES=5 (Cluster.java:72-75).

The join client is a callback state machine (``join_async``) so the same code
drives both the real-time scheduler and the deterministic virtual-time one;
``join`` is the blocking wrapper for real-time mode.
"""

from __future__ import annotations

import random
from typing import Callable, Dict, List, Optional, Tuple

from .cut_detector import MultiNodeCutDetector
from .events import ClusterEvents
from .forensics.bundle import install_exit_hooks, write_bundle
from .forensics.hlc import HlcClock, HlcStampingClient
from .handoff.store import PartitionStore
from .membership import MembershipView
from .messaging.base import IMessagingClient, IMessagingServer
from .metadata import FrozenMetadata
from .monitoring.base import IEdgeFailureDetectorFactory
from .monitoring.pingpong import PingPongFailureDetectorFactory
from .observability import FlightRecorder, Metrics, Tracer, global_metrics
from .placement.engine import DEFAULT_WEIGHT_KEY, PlacementConfig
from .runtime.futures import Promise, successful_as_list
from .runtime.lockdep import make_lock
from .runtime.resources import SharedResources
from .runtime.scheduler import Scheduler
from .service import MembershipService, SubscriptionCallback
from .settings import Settings
from .types import (
    Endpoint,
    JoinMessage,
    JoinResponse,
    JoinStatusCode,
    NodeId,
    PreJoinMessage,
)

K = 10
H = 9
L = 4
RETRIES = 5

# Join-health counters (regression guard for seed starvation: a seed that
# answers phase 1 within the deadline keeps ``join.phase1_no_response`` at
# zero; ``join.exhausted`` counts joins that burned all RETRIES attempts).
# Protocol-legal retries -- CONFIG_CHANGED, UUID redraws, phase-2 races --
# are deliberately NOT counted here. Promoted onto the telemetry plane: a
# builder with an injected registry (``use_metrics``) counts there (so tests
# stop leaking state into each other); otherwise counts land on the
# process-global registry, which this module-level alias re-exports for
# existing importers.
JOIN_METRICS = global_metrics()


class JoinException(RuntimeError):
    pass


class Cluster:
    def __init__(
        self,
        server: IMessagingServer,
        membership_service: MembershipService,
        resources: SharedResources,
        listen_address: Endpoint,
    ) -> None:
        self._server = server
        self._membership_service = membership_service
        self._resources = resources
        self._listen_address = listen_address
        self._shutdown_lock = make_lock("Cluster._shutdown_lock")
        self._has_shutdown = False  # guarded-by: _shutdown_lock

    @property
    def listen_address(self) -> Endpoint:
        return self._listen_address

    def get_memberlist(self) -> List[Endpoint]:
        self._check_running()
        return self._membership_service.get_membership_view()

    def get_membership_size(self) -> int:
        self._check_running()
        return self._membership_service.membership_size

    def get_cluster_metadata(self) -> Dict[Endpoint, FrozenMetadata]:
        self._check_running()
        return self._membership_service.get_metadata()

    def get_current_configuration_id(self) -> int:
        self._check_running()
        return self._membership_service.get_current_configuration_id()

    def get_cluster_status(self):
        """Local introspection snapshot (same shape the ClusterStatusRequest
        RPC returns): config id, view size, cut-detector watermark occupancy,
        consensus round state, metrics digest, and the journal tail."""
        self._check_running()
        return self._membership_service.cluster_status()

    @property
    def flight_recorder(self) -> FlightRecorder:
        """The node's event journal; deliberately NOT gated on running so a
        post-mortem can dump it after shutdown."""
        return self._membership_service.recorder

    @property
    def hierarchy(self):
        """The hierarchy plane (hierarchy/plane.py), or None when
        ``settings.hierarchy`` is off. Harnesses use it to seed parent
        bootstrap hints and to read the composed global view."""
        return self._membership_service.hierarchy

    def capture_bundle(self, path: Optional[str] = None, *,
                       trigger: str = "explicit",
                       detail: Optional[Dict[str, object]] = None,
                       ) -> Dict[str, object]:
        """Capture a cluster-wide incident evidence bundle (forensics
        plane): this node's full evidence plus a status-RPC sweep of every
        other member, each bounded by
        ``settings.forensics.bundle_member_timeout_ms`` -- unreachable
        members are named in the manifest, never waited on. When ``path``
        is given the bundle is also written atomically (tmp +
        ``os.replace``). Feed the file(s) to ``tools/forensics.py report``
        for the HLC-ordered timeline and anomaly-signature verdicts."""
        self._check_running()
        bundle = self._membership_service.capture_cluster_bundle(
            trigger, detail
        )
        if path is not None:
            write_bundle(bundle, path)
        return bundle

    def capture_bundle_async(self, *, trigger: str = "explicit",
                             detail: Optional[Dict[str, object]] = None,
                             ) -> Promise:
        """Non-blocking capture (virtual-time clusters drive this form and
        pump the scheduler until the promise completes)."""
        self._check_running()
        return self._membership_service.capture_cluster_bundle_async(
            trigger, detail
        )

    @property
    def last_bundle(self) -> Optional[Dict[str, object]]:
        """The most recent bundle an automatic trigger (e.g. a burn alert)
        pinned on this node; NOT gated on running, like the recorder."""
        return self._membership_service.last_bundle

    def register_subscription(
        self, event: ClusterEvents, callback: SubscriptionCallback
    ) -> None:
        self._membership_service.register_subscription(event, callback)

    def get_placement_map(self):
        """The current deterministic shard map (placement/engine.py), or
        None when the node was built without ``use_placement``. Identical
        bytes-for-bytes on every member of a configuration."""
        self._check_running()
        return self._membership_service.placement_map()

    def get_placement_diff(self):
        """The rebalance plan from the most recent view change (None before
        the first churn or without placement)."""
        self._check_running()
        return self._membership_service.placement_diff()

    def get_handoff_status(self) -> Tuple[int, int, int]:
        """(in-flight, completed, failed) handoff session counts, all zero
        when the node was built without ``use_handoff``."""
        self._check_running()
        engine = self._membership_service.handoff_engine()
        return engine.status() if engine is not None else (0, 0, 0)

    def get_partition_store(self):
        """The PartitionStore this node moves bytes through (None without
        ``use_handoff``)."""
        self._check_running()
        engine = self._membership_service.handoff_engine()
        return engine.store if engine is not None else None

    def serving_put(self, key: bytes, value: bytes) -> Promise:
        """Write ``key`` through the serving plane (use_serving); resolves
        with the final PutAck after routing redirects and quorum ack."""
        self._check_running()
        return self._membership_service.serving_put(key, value)

    def serving_get(self, key: bytes) -> Promise:
        """Read ``key`` through the serving plane; resolves with a PutAck."""
        self._check_running()
        return self._membership_service.serving_get(key)

    def get_serving_status(self) -> Tuple[int, int, int]:
        """(gets, puts, replication acks) served by this member, all zero
        when the node was built without ``use_serving``."""
        self._check_running()
        engine = self._membership_service.serving_engine()
        return engine.status() if engine is not None else (0, 0, 0)

    def leave_gracefully_async(self) -> Promise:
        """Inform observers of the intent to leave, then shut down
        (Cluster.java:145-149)."""
        done: Promise = Promise()

        def after_leave(_p: Promise) -> None:
            self.shutdown()
            done.set_result(None)

        self._membership_service.leave_async().add_callback(after_leave)
        return done

    def leave_gracefully(self, timeout: float = 10.0) -> None:
        self.leave_gracefully_async().result(timeout)

    def shutdown(self) -> None:
        # shutdown() races leave_gracefully_async's completion callback with a
        # user-thread call; flip the flag under a lock so exactly one caller
        # runs the teardown, and tear down outside it (it blocks on joins)
        with self._shutdown_lock:
            if self._has_shutdown:
                return
            self._has_shutdown = True
        self._server.shutdown()
        self._membership_service.shutdown()
        # Graceful-stop durability barrier: flush the WAL and write a
        # snapshot + marker so the next boot recovers with zero replayed
        # records. Without this, a clean shutdown left the tail in the log
        # and every restart paid a full replay -- and under FSYNC_NEVER the
        # page cache could still hold acked writes when the process exited
        # (pinned in tests/test_advice_regressions.py). Duck-typed so the
        # in-memory store (no checkpoint()) is untouched.
        engine = self._membership_service.handoff_engine()
        if engine is not None:
            checkpoint = getattr(engine.store, "checkpoint", None)
            if checkpoint is not None:
                checkpoint()
        self._resources.shutdown()

    def _check_running(self) -> None:
        if self._has_shutdown:
            raise RuntimeError("cluster instance has been shut down")

    def __str__(self) -> str:
        return f"Cluster:{self._listen_address}"


class ClusterBuilder:
    """Cluster.Builder (Cluster.java:162-248)."""

    def __init__(self, listen_address: Endpoint) -> None:
        self._listen_address = listen_address
        self._metadata: FrozenMetadata = ()
        self._settings = Settings()
        self._fd_factory: Optional[IEdgeFailureDetectorFactory] = None
        self._subscriptions: Dict[ClusterEvents, List[SubscriptionCallback]] = {}
        self._client: Optional[IMessagingClient] = None
        self._server: Optional[IMessagingServer] = None
        self._scheduler: Optional[Scheduler] = None
        self._rng: Optional[random.Random] = None
        self._broadcaster_factory = None
        self._metrics: Optional[Metrics] = None
        self._tracer: Optional[Tracer] = None
        self._placement: Optional[PlacementConfig] = None
        self._handoff_store: Optional[PartitionStore] = None
        self._serving = False
        self._tier_resolver: Optional[Callable[[Endpoint], str]] = None
        self._durability_dir: Optional[str] = None
        self._forensics_dump: Optional[str] = None

    def set_metadata(self, metadata: Dict[str, bytes]) -> "ClusterBuilder":
        self._metadata = tuple(sorted(metadata.items()))
        return self

    def set_edge_failure_detector_factory(
        self, factory: IEdgeFailureDetectorFactory
    ) -> "ClusterBuilder":
        self._fd_factory = factory
        return self

    def set_tier_resolver(
        self, tier_of: Callable[[Endpoint], str]
    ) -> "ClusterBuilder":
        """Topology tier label per monitored subject (rack/zone/region/wan)
        for the adaptive failure detector's peer grouping; ignored unless
        settings.adaptive_fd.enabled (see monitoring/adaptive.py)."""
        self._tier_resolver = tier_of
        return self

    def add_subscription(
        self, event: ClusterEvents, callback: SubscriptionCallback
    ) -> "ClusterBuilder":
        self._subscriptions.setdefault(event, []).append(callback)
        return self

    def use_settings(self, settings: Settings) -> "ClusterBuilder":
        self._settings = settings
        return self

    def set_messaging_client_and_server(
        self, client: IMessagingClient, server: IMessagingServer
    ) -> "ClusterBuilder":
        self._client = client
        self._server = server
        return self

    def use_scheduler(self, scheduler: Scheduler) -> "ClusterBuilder":
        """Share a scheduler across in-process nodes (virtual-time clusters)."""
        self._scheduler = scheduler
        return self

    def use_rng(self, rng: random.Random) -> "ClusterBuilder":
        """Seeded randomness for deterministic runs (node IDs, broadcast
        shuffles, consensus jitter)."""
        self._rng = rng
        return self

    def use_metrics(self, metrics: Metrics) -> "ClusterBuilder":
        """Inject the metrics registry for this node (join diagnostics,
        failure detectors, and the MembershipService all count there).
        Default: a per-node registry attached to ``global_metrics()``."""
        self._metrics = metrics
        return self

    def use_tracer(self, tracer: Tracer) -> "ClusterBuilder":
        """Inject the span tracer for this node. Default: a per-node tracer
        attached to ``global_tracer()``."""
        self._tracer = tracer
        return self

    def use_placement(
        self,
        partitions: int = 256,
        replicas: int = 3,
        seed: int = 0,
        weight_key: str = DEFAULT_WEIGHT_KEY,
        default_weight: int = 1,
    ) -> "ClusterBuilder":
        """Enable the placement plane: a deterministic P-partition, R-replica
        shard map recomputed locally at every view change (placement/). All
        members must be built with identical parameters -- they are part of
        the map function, like K/H/L are part of the protocol."""
        self._placement = PlacementConfig(
            partitions=partitions, replicas=replicas, seed=seed,
            weight_key=weight_key, default_weight=default_weight,
        )
        return self

    def use_handoff(self, store: PartitionStore) -> "ClusterBuilder":
        """Enable the handoff plane: every placement diff's moved partitions
        are pulled into ``store`` by this node when it becomes a new replica,
        and released from it once a verified new owner acks (handoff/).
        Requires ``use_placement`` with identical parameters cluster-wide."""
        self._handoff_store = store
        return self

    def use_serving(
        self, store: Optional[PartitionStore] = None
    ) -> "ClusterBuilder":
        """Enable the serving plane: a replicated Get/Put KV store routed by
        the placement map, with quorum-ack writes and leader reads
        (serving/). The serving engine persists into the handoff plane's
        PartitionStore so view-change state transfer moves serving data
        through verified handoff sessions; ``store`` configures the handoff
        plane when it is not configured yet. Requires ``use_placement`` and
        ``use_handoff`` (directly or via ``store``)."""
        if store is not None and self._handoff_store is None:
            self.use_handoff(store)
        self._serving = True
        return self

    def use_durability(self, directory: str) -> "ClusterBuilder":
        """Enable the durability plane: mount a write-ahead-logged
        DurablePartitionStore rooted at ``directory`` under the handoff
        seam (durability/). Construction is recovery -- a restarted node
        reopens with the state it acknowledged, reuses its persisted
        NodeId to rejoin, and catches up via verified handoff pulls.
        Gated on ``settings.durability.enabled`` (the kill switch): when
        off, the directory is ignored and the node runs the exact
        pre-durability in-memory path."""
        self._durability_dir = directory
        return self

    def _durable_store(self):
        """Build (and recover) the durable store when the plane is on;
        mounts it as the handoff store so every downstream plane
        (placement sizes, handoff pulls, serving persistence) rides it."""
        if self._durability_dir is None or not self._settings.durability.enabled:
            return None
        from .durability.store import DurablePartitionStore

        knobs = self._settings.durability
        store = DurablePartitionStore(
            self._durability_dir,
            segment_bytes=knobs.segment_bytes,
            fsync_policy=knobs.fsync_policy,
            snapshot_every_records=knobs.snapshot_every_records,
        )
        self._handoff_store = store
        return store

    def use_forensics_dump(self, journal_path: str) -> "ClusterBuilder":
        """Register crash/exit evidence hooks (forensics plane): an atexit
        dump of the flight-recorder journal to ``journal_path`` (atomic:
        tmp + ``os.replace``) plus a faulthandler traceback file beside it
        (``journal_path + ".crash"``) for hard crashes that never reach
        atexit. Inert unless ``settings.forensics.enabled``."""
        self._forensics_dump = journal_path
        return self

    def _forensics(
        self, resources: SharedResources, client: IMessagingClient,
        durable,
    ) -> Tuple[Optional[HlcClock], IMessagingClient,
               Optional[FlightRecorder]]:
        """Forensics-plane assembly, shared by ``start`` and ``join_async``.

        When ``settings.forensics.enabled``: mint this node's hybrid
        logical clock (physical axis = the node's scheduler clock, so
        virtual-time runs are deterministic and a nemesis clock-skew
        scheduler skews the HLC with the node; incarnation = the durable
        store's persisted boot count when one exists), wrap the messaging
        client so every outbound message carries a fresh stamp, and build
        the HLC-stamping flight recorder at the configured capacity. When
        off: (None, client, None) -- the exact pre-forensics path, byte
        for byte on the wire."""
        if not self._settings.forensics.enabled:
            return None, client, None
        incarnation = 1
        if durable is not None:
            bump = getattr(durable, "bump_incarnation", None)
            if bump is not None:
                incarnation = max(1, int(bump()))
        hlc = HlcClock(
            clock=resources.scheduler.now_ms, incarnation=incarnation
        )
        recorder = FlightRecorder(
            node=str(self._listen_address),
            clock=resources.scheduler.now_ms,
            capacity=self._settings.forensics.journal_capacity,
            hlc=hlc,
            metrics=self._metrics,
        )
        if self._forensics_dump:
            install_exit_hooks(recorder, self._forensics_dump)
        return hlc, HlcStampingClient(client, hlc), recorder

    def set_broadcaster_factory(self, factory) -> "ClusterBuilder":
        """Swap the dissemination strategy: ``factory(client, rng)`` returns
        the IBroadcaster this node's service uses (default:
        UnicastToAllBroadcaster; e.g. messaging.gossip.GossipBroadcaster for
        epidemic relay -- the alternative IBroadcaster.java:24-26 names)."""
        self._broadcaster_factory = factory
        return self

    def _broadcaster(self, client: IMessagingClient, rng: random.Random):
        if self._broadcaster_factory is None:
            return None  # service defaults to UnicastToAllBroadcaster
        broadcaster = self._broadcaster_factory(client, rng)
        if getattr(broadcaster, "receive", None) is not None:
            # gossip-style broadcasters wrap messages in GossipEnvelope,
            # which the JVM-wire-compatible gRPC transport cannot carry
            # (rapid.proto has no such message); best-effort sends would
            # fail silently and the cluster would never converge, so refuse
            # the pairing at build time
            from .messaging.grpc_transport import GrpcClient

            if isinstance(client, GrpcClient):
                raise JoinException(
                    "gossip-style broadcasters need a native-codec transport "
                    "(tcp / native-tcp / in-process); the gRPC wire has no "
                    "GossipEnvelope message"
                )
        return broadcaster

    # ------------------------------------------------------------------ #

    def _prepare(self) -> Tuple[SharedResources, IMessagingClient, IMessagingServer,
                                random.Random]:
        if self._client is None or self._server is None:
            raise JoinException(
                "no transport: call set_messaging_client_and_server(...) "
                "(e.g. InProcessClient/InProcessServer or the TCP transport)"
            )
        resources = SharedResources(self._scheduler, name=str(self._listen_address))
        rng = self._rng if self._rng is not None else random.Random()
        return resources, self._client, self._server, rng

    def _fd(self, client: IMessagingClient) -> IEdgeFailureDetectorFactory:
        if self._fd_factory is not None:
            return self._fd_factory
        # RTT estimates read the node's scheduler clock when one is set, so
        # virtual-time runs measure deterministic fd.rtt_ms and a nemesis
        # clock-skew scheduler drifts the estimates with the node
        clock = self._scheduler.now_ms if self._scheduler is not None else None
        if self._settings.adaptive_fd.enabled:
            from .monitoring.adaptive import AdaptivePingPongFactory

            return AdaptivePingPongFactory(
                self._listen_address, client,
                settings=self._settings,
                metrics=self._metrics,
                clock=clock,
                tier_of=self._tier_resolver,
            )
        if self._settings.fd_policy == "windowed":
            from .monitoring.pingpong import WindowedPingPongFailureDetectorFactory

            return WindowedPingPongFailureDetectorFactory(
                self._listen_address, client,
                window=self._settings.fd_window,
                threshold=self._settings.fd_window_threshold,
                metrics=self._metrics,
                clock=clock,
            )
        return PingPongFailureDetectorFactory(
            self._listen_address, client,
            failure_threshold=self._settings.fd_failure_threshold,
            metrics=self._metrics,
            clock=clock,
        )

    def start(self) -> Cluster:
        """Bootstrap a seed node (Cluster.java:255-280)."""
        resources, client, server, rng = self._prepare()
        durable = self._durable_store()
        # forensics plane (kill-switched): HLC-stamping client wrapper plus
        # the HLC-stamping recorder; (None, client, None) when off
        hlc, client, forensics_recorder = self._forensics(
            resources, client, durable
        )
        # restart-aware identity: a seed that persisted its NodeId boots
        # with the same identity it had before the restart
        node_id = durable.node_id if durable is not None else None
        if node_id is None:
            node_id = NodeId.random(rng)
        view = MembershipView(K, node_ids=[node_id], endpoints=[self._listen_address])
        cut_detector = MultiNodeCutDetector(K, H, L)
        metadata_map = (
            {self._listen_address: self._metadata} if self._metadata else {}
        )
        service = MembershipService(
            self._listen_address,
            cut_detector,
            view,
            resources,
            self._settings,
            client,
            self._fd(client),
            metadata_map=metadata_map,
            subscriptions=self._subscriptions,
            rng=rng,
            broadcaster=self._broadcaster(client, rng),
            metrics=self._metrics,
            tracer=self._tracer,
            recorder=(
                forensics_recorder
                if forensics_recorder is not None
                else FlightRecorder(
                    node=str(self._listen_address),
                    clock=resources.scheduler.now_ms,
                )
            ),
            placement=self._placement,
            handoff_store=self._handoff_store,
            serving=self._serving,
            hlc=hlc,
        )
        if durable is not None:
            durable.set_identity(node_id)
            durable.set_config_id(view.get_current_configuration_id())
        server.set_membership_service(service)
        server.start()
        return Cluster(server, service, resources, self._listen_address)

    def join(self, seed_address: Endpoint, timeout: float = 60.0) -> Cluster:
        """Blocking join for real-time mode."""
        return self.join_async(seed_address).result(timeout)

    def join_async(self, seed_address: Endpoint) -> Promise:
        """Two-phase join state machine (Cluster.java:303-401). Resolves with a
        Cluster or fails with JoinException after RETRIES attempts."""
        resources, client, server, rng = self._prepare()
        # The server starts before the join so observers can probe us; probes
        # are answered BOOTSTRAPPING until the service is wired
        # (Cluster.java:312, GrpcServer.java:83-95).
        server.start()
        result: Promise = Promise()
        durable = self._durable_store()
        # forensics plane (kill-switched): stamp the join traffic too, so
        # a seed's causal timeline includes the joiner's first messages
        hlc, client, forensics_recorder = self._forensics(
            resources, client, durable
        )
        # Restart-aware rejoin: reuse the persisted NodeId. A returning
        # host still present in the ring then gets HOSTNAME_ALREADY_IN_RING
        # in phase 1 and SAFE_TO_JOIN from observers that recognize the
        # (host, identity) pair -- the fast identity-preserving path; a
        # fresh random id on a still-present hostname would loop on
        # CONFIG_CHANGED until eviction. The identifier history is
        # append-only, so after eviction the old id is burned and the
        # UUID_ALREADY_IN_RING redraw below takes over.
        persisted = durable.node_id if durable is not None else None
        state = {
            "node_id": persisted if persisted is not None else NodeId.random(rng),
            "attempt": 0,
        }
        join_metrics = self._metrics if self._metrics is not None else JOIN_METRICS
        # the flight recorder outlives individual join attempts: created here
        # so retry exhaustion is journaled even when no service ever exists,
        # then handed to the MembershipService on success
        recorder = (
            forensics_recorder
            if forensics_recorder is not None
            else FlightRecorder(
                node=str(self._listen_address),
                clock=resources.scheduler.now_ms,
            )
        )

        def fail_all(reason: str) -> None:
            join_metrics.incr("join.exhausted")
            recorder.record(
                "join_exhausted", reason=reason, attempts=state["attempt"]
            )
            server.shutdown()
            client.shutdown()
            resources.shutdown()
            result.set_exception(
                JoinException(f"join attempt unsuccessful {self._listen_address}: {reason}")
            )

        def next_attempt(reason: str) -> None:
            state["attempt"] += 1
            if state["attempt"] >= RETRIES:
                fail_all(reason)
            else:
                attempt()

        def attempt() -> None:
            pre_join = PreJoinMessage(sender=self._listen_address, node_id=state["node_id"])
            client.send_message(seed_address, pre_join).add_callback(on_phase1)

        def on_phase1(p: Promise) -> None:
            if p.exception() is not None:
                # the seed never answered within the join deadline -- the
                # starvation signature, distinct from protocol-legal retries
                join_metrics.incr("join.phase1_no_response")
                next_attempt(f"phase 1 failed: {p.exception()}")
                return
            response = p.peek()
            if not isinstance(response, JoinResponse):
                next_attempt(f"unexpected phase 1 response {type(response).__name__}")
                return
            status = response.status_code
            if status not in (
                JoinStatusCode.SAFE_TO_JOIN,
                JoinStatusCode.HOSTNAME_ALREADY_IN_RING,
            ):
                # Error responses from the seed that warrant a retry
                # (Cluster.java:318-338)
                if status == JoinStatusCode.UUID_ALREADY_IN_RING:
                    state["node_id"] = NodeId.random(rng)
                next_attempt(f"phase 1 status {status.name}")
                return
            # HOSTNAME_ALREADY_IN_RING: a previous attempt's view change added
            # us; join with config id -1 so any SAFE_TO_JOIN response streams
            # the configuration (Cluster.java:374-381).
            config_to_join = (
                -1
                if status == JoinStatusCode.HOSTNAME_ALREADY_IN_RING
                else response.configuration_id
            )
            send_phase2(response, config_to_join)

        def send_phase2(phase1_response: JoinResponse, config_to_join: int) -> None:
            # Batch ring numbers per distinct observer (Cluster.java:406-437)
            ring_numbers_per_observer: Dict[Endpoint, List[int]] = {}
            for ring_number, observer in enumerate(phase1_response.endpoints):
                ring_numbers_per_observer.setdefault(observer, []).append(ring_number)
            futures = []
            for observer, ring_numbers in ring_numbers_per_observer.items():
                msg = JoinMessage(
                    sender=self._listen_address,
                    node_id=state["node_id"],
                    ring_numbers=tuple(ring_numbers),
                    configuration_id=config_to_join,
                    metadata=self._metadata,
                )
                futures.append(client.send_message(observer, msg))
            successful_as_list(futures).add_callback(
                lambda p: on_phase2(p, config_to_join)
            )

        def on_phase2(p: Promise, config_to_join: int) -> None:
            responses = p.peek()
            # Accept the first response carrying a *different* configuration:
            # joining is itself a view change (Cluster.java:389-399).
            for response in responses:
                if (
                    isinstance(response, JoinResponse)
                    and response.status_code == JoinStatusCode.SAFE_TO_JOIN
                    and response.configuration_id != config_to_join
                ):
                    finish(response)
                    return
            next_attempt("phase 2 returned no valid configuration")

        def finish(response: JoinResponse) -> None:
            """createClusterFromJoinResponse (Cluster.java:442-474)."""
            view = MembershipView(
                K, node_ids=response.identifiers, endpoints=response.endpoints
            )
            cut_detector = MultiNodeCutDetector(K, H, L)
            metadata_map = dict(response.metadata)
            service = MembershipService(
                self._listen_address,
                cut_detector,
                view,
                resources,
                self._settings,
                client,
                self._fd(client),
                metadata_map=metadata_map,
                subscriptions=self._subscriptions,
                rng=rng,
                broadcaster=self._broadcaster(client, rng),
                metrics=self._metrics,
                tracer=self._tracer,
                recorder=recorder,
                placement=self._placement,
                handoff_store=self._handoff_store,
                serving=self._serving,
                hlc=hlc,
            )
            if durable is not None:
                durable.set_identity(state["node_id"])
                durable.set_config_id(response.configuration_id)
            server.set_membership_service(service)
            result.set_result(
                Cluster(server, service, resources, self._listen_address)
            )

        attempt()
        return result
