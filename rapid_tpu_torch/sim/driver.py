"""Host driver: runs the device round loop and applies view changes.

The port of ``rapid_tpu/sim/driver.py``'s ``Simulator``, restricted to the
protocol: ring/adjacency construction at configuration changes
(MembershipView ringAdd/ringDelete), configuration identity (the chained
xxHash64, bit-compatible with the JVM), the append-only identifiersSeen set
(MembershipView.java:51,155), the fault API (crash bursts, one-way ingress
partitions, lossy ingress, flip-flop, leaves, join waves, delivery groups and
delays), identities seated ahead of joins, bridged external voters, both
dispatch branches of ``run_until_decision`` with the classic-Paxos fallback
round (``classic.py``), the configuration snapshot, the multi-device round
loop over a mesh (``mesh=``, ``rapid_tpu_torch/shard/engine.py``), the
speculative view change (``speculate=``), the telemetry plane (``metrics``,
``tracer``, the stable-view timer, the flight ``recorder``, stamped by a
hybrid logical clock when ``SimConfig.forensics`` is set) and the profiling
plane (``enable_profiling``). Method names and signatures follow the JAX
driver, with a ``device`` argument last.

The driver's host planes follow the JAX driver's: placement
(``enable_placement``, its map built and updated on the device by the
``placement_topr`` kernel), handoff, serving (``serving_put``/``get``, the
open-loop driver), SLO, durability (``checkpoint_slot``/``restart_slot``)
and the hierarchy mirror, hooked into the view change in JAX's order.
The protocol plane's live engines those planes mirror are the port's own
too: ``handoff/engine.py``, ``serving/engine.py``, ``hierarchy/plane.py``
and ``routing.py``, ``durability/``; the placement engine and its
subscriber are in ``placement/engine.py``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Set, Tuple

import numpy as np
import torch

from ..faults import FaultPlan, Nemesis
from ..forensics.hlc import HlcClock
from ..handoff.device import device_transfer_plans
from ..handoff.plan import chunk_spans, content_fingerprint
from ..handoff.store import InMemoryPartitionStore
from ..hashing import endpoint_hash_batch, xxh64_batch_auto
from ..hierarchy.cells import _CELL_SEED_BASE, cell_count
from ..hierarchy.parent import _LEADER_SEED, CellState, _fold, compose_fingerprint
from ..observability import (
    HANDOFF_BYTES_BUCKETS,
    HANDOFF_CHUNKS_BUCKETS,
    PARTITIONS_MOVED_BUCKETS,
    SERVING_LATENCY_BUCKETS_MS,
    FlightRecorder,
    Metrics,
    StableViewTimer,
    TraceContext,
    Tracer,
    global_metrics,
    global_tracer,
)
from ..placement.device import DevicePlacement
from ..placement.engine import PlacementConfig
from ..profiling import PhaseProfiler
from ..runtime import jitwatch
from ..serving.kv import decode_kv, encode_kv, partition_of
from ..settings import ProfilingSettings, SLOSettings
from ..shard.engine import (
    Mesh,
    make_sharded_run,
    make_sharded_run_until,
    place_inputs,
    place_state,
    row_field,
)
from ..slo import SloPlane
from ..types import Endpoint, HandoffRequest, Put, PutAck
from . import threefry
from .classic import ClassicCoordinator
from .engine import (
    FAST_RANK,
    RANK_BITS,
    RoundInputs,
    SimConfig,
    SimState,
    device_initial_state,
    pack_decision,
    resolve_device,
    run_rounds_const,
    run_until_decided_const,
    unpack_decision,
)
from .topology import VirtualCluster, _int64_le_bytes, config_fold, ring_order

# rounds a classic recovery exchange bills with no latency skew: phase1a,
# phase1b, phase2a, phase2b, one delivery hop each (the JAX driver's
# _CLASSIC_ROUND_HOPS); under skew the winning coordinator's cutoffs are
# billed instead
_CLASSIC_ROUND_HOPS = 4


def _pow2_chunks(n: int, batch: int) -> List[int]:
    """Split ``n`` rounds into scan lengths drawn from {batch} and powers of
    two -- the JAX driver's dispatch sequence for the scan path (where each
    length is a compiled executable), kept so both drivers issue the same
    dispatches and execute exactly ``n`` rounds."""
    chunks: List[int] = []
    while n > 0:
        step = batch if n >= batch else 1 << (n.bit_length() - 1)
        chunks.append(step)
        n -= step
    return chunks


def _speculates(speculate: Optional[bool], device: torch.device) -> bool:
    """``Simulator(speculate=)``: as given, else on except on a CUDA device."""
    return speculate if speculate is not None else device.type != "cuda"


def _tensors(tree):
    """Every tensor of a state: a dataclass, its lists, tuples and dicts."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


class _VirtualClock:
    """A simulator's virtual clock behind the ``now_ms()`` seam a Nemesis
    takes its time from."""

    def __init__(self, sim: "Simulator") -> None:
        self._sim = sim

    def now_ms(self) -> int:
        return self._sim.virtual_ms


@dataclass
class ViewChangeRecord:
    """One decided configuration change."""

    cut: np.ndarray  # node ids added/removed
    added: np.ndarray
    removed: np.ndarray
    configuration_id: int
    virtual_time_ms: int  # protocol-time of the decision
    wall_time_s: float  # host+device time spent simulating to it
    membership_size: int
    via_classic_round: bool = False  # decided by the Paxos fallback


# One thread drives a simulator (the sim loop): the caller's, or a gateway's
# protocol thread, which serializes every task that touches it. The
# speculation worker writes ``_spec`` alone, and the simulator joins it before
# any read; the lazy caches its calls reach are warmed before it starts.
class Simulator:  # guarded-by: sim-loop
    def __init__(
        self,
        n_nodes: int,
        capacity: Optional[int] = None,
        config: Optional[SimConfig] = None,
        seed: int = 0,
        mesh: Optional[Mesh] = None,
        speculate: Optional[bool] = None,
        identities=None,
        metrics: Optional[Metrics] = None,
        tracer: Optional[Tracer] = None,
        device=None,
    ) -> None:
        """The JAX ``Simulator``'s parameters in its order, then ``device``.

        ``mesh``: a ``shard.engine.Mesh`` (``make_mesh``) to run the round
        loop over several devices, or several shards of one: per-edge state
        row-sharded over every mesh axis, the rest on the mesh's home device,
        which is then the simulator's ``device``; capacity must divide over
        it. The fault, join, leave and view-change API is the same in both
        modes; a mesh dispatch runs the rounds one by one (the closed form
        is single-device). On a mesh of several processes
        (``make_multihost_mesh(coordinator_address=...)``) every process
        constructs its simulator alike and makes the same calls in the same
        order, as JAX's SPMD processes do: each holds its own shards' rows,
        and every dispatch, and a partition's first fetch of the subjects
        (``shard.engine.row_field``), is a collective of them all.

        ``speculate``: overlap the predicted view change (configuration-id
        fold, fresh state) with the decision fetch
        (``_speculate_view_change``). Invisible in every result. ``None``,
        the default, speculates except on a CUDA device, where the round
        loop is host-bound and the fetch returns at once, so the worker
        costs more host time than the view change it saves (PERF.md §6);
        elsewhere it is the JAX driver's default, on.

        ``identities``: optional [(hostname bytes, port, id_high, id_low)]
        seated into slots 0.. before any state is built, replacing the
        synthesized identities.

        ``metrics`` / ``tracer``: registries to record into (any object with
        the methods of ``observability.Metrics`` / ``Tracer``); by default
        fresh per-simulator ones attached to the port's process-global
        registry and tracer.

        ``device``: where the round loop runs; CUDA unless the caller names
        another (``"cpu"`` for the tests). Without a GPU and without an
        explicit device, construction raises."""
        self.device = mesh.home if mesh is not None else resolve_device(device)
        capacity = capacity if capacity is not None else n_nodes
        assert n_nodes <= capacity
        self.config = config if config is not None else SimConfig(capacity=capacity)
        assert self.config.capacity == capacity
        assert self.config.fd_interval_ms % self.config.rounds_per_interval == 0, (
            "fd_interval_ms must divide evenly into sub-interval rounds"
        )
        self.mesh = mesh
        self.cluster = VirtualCluster.synthesize(capacity, self.config.k, seed=seed)
        if identities is not None:
            assert len(identities) <= capacity
            for slot, (host, port, id_high, id_low) in enumerate(identities):
                self.cluster.assign_identity(slot, host, port, id_high, id_low)
        self.active = np.zeros(capacity, dtype=bool)
        self.active[:n_nodes] = True
        self.alive = self.active.copy()
        self.group_of = np.zeros(capacity, dtype=np.int32)
        self.auto_vote = np.ones(capacity, dtype=bool)
        # identifiersSeen: the append-only *value* history of every NodeId
        # ever admitted (MembershipView.java:51,155), in admission order
        slots = np.flatnonzero(self.active)
        self._seen_ids = np.stack(
            [self.cluster.id_high[slots], self.cluster.id_low[slots]], axis=1
        )  # [M, 2] int64
        self._seen_set: Optional[Set[Tuple[int, int]]] = None
        self._seen_hashes: Optional[np.ndarray] = None  # [M, 2] uint64
        self.seed = seed
        self.speculate = _speculates(speculate, self.device)
        self.virtual_ms = 0
        # kept so from_configuration's path builds the telemetry alike
        self._metrics_override = metrics
        self._tracer_override = tracer
        self._init_runtime_state()

    def _init_runtime_state(self) -> None:
        """Everything past identity/membership: telemetry, device caches,
        fresh device state, the all-clear fault plane, and the hash
        pre-warms. Shared by __init__ and from_configuration."""
        capacity, k, g = self.config.capacity, self.config.k, self.config.groups
        dev = self.device
        self._init_telemetry()
        self._config_id: Optional[int] = None
        # the speculative view change (_speculate_view_change): (predicted
        # active bytes, seed, config id, fresh state, alive bytes)
        self._spec: Optional[Tuple[bytes, int, int, SimState, bytes]] = None
        self._spec_stream: Optional[torch.cuda.Stream] = None  # the worker's, on the card
        self._profiler = None  # enable_profiling attaches one
        self._sharded_runs: dict = {}
        # device-resident constants: the ring ranks (adjacency rebuilds never
        # re-upload them) and the all-clear fault-plane tensors
        self._ring_rank_dev = self._tensor(self.cluster.ring_rank())
        self._ring_rank_dirty = False
        self._zero_ck = torch.zeros((capacity, k), dtype=torch.bool, device=dev)
        self._zero_drop_prob = torch.zeros(capacity, dtype=torch.float32, device=dev)
        self._ones_deliver = torch.ones((g, capacity), dtype=torch.bool, device=dev)
        self._zero_delay = torch.zeros((g, capacity), dtype=torch.int32, device=dev)
        self._deliver_delay = np.zeros((g, capacity), dtype=np.int32)
        self._deliver_delay_dev: Optional[torch.Tensor] = None
        self._alive_dev: Optional[torch.Tensor] = None
        self._probe_drop_dev: Optional[torch.Tensor] = None
        self._down_reports_dev: Optional[torch.Tensor] = None
        self._subjects_host: Optional[np.ndarray] = None
        self._observers_host: Optional[np.ndarray] = None
        # each ring's active nodes in ring order and their ring hashes, per
        # configuration: a joiner's predecessors are a binary search away
        self._ring_nodes: Optional[List[Tuple[np.ndarray, np.ndarray]]] = None
        self._ids_sorted: Optional[np.ndarray] = None
        self.state = self._fresh_state(self.seed)
        self._billed_rounds = 0  # rounds of this configuration already billed
        self._rounds_executed = 0  # host mirror of state.round (per config)
        self.view_changes: List[ViewChangeRecord] = []
        # fault plane
        self._ingress_partitioned: Set[int] = set()
        self._drop_prob = np.zeros(capacity, dtype=np.float32)
        self._deliver = np.ones((g, capacity), dtype=bool)
        self._pending_joiners: Set[int] = set()
        self._join_reports_armed = False
        self._pending_leavers: Set[int] = set()
        self._injected_down = np.zeros((capacity, k), dtype=bool)
        # host-side randomness for the classic-fallback coordinator race
        # (which nodes' expovariate timers fire first, FastPaxos.java:200-203),
        # seeded as the JAX driver seeds it so runs replay alike
        self._host_rng = np.random.default_rng(self.seed ^ 0x5EED_C1A5)
        # the driver's host planes, each opt-in through its enable_* (derived
        # state, so a restored simulator re-enables them explicitly)
        self._placement = None
        self._placement_diffs: List = []
        # handoff (requires placement)
        self._handoff_stores = None
        self._handoff_sizes: Optional[np.ndarray] = None
        self._handoff_chunk_size = 1 << 16
        self._handoff_chunk_ms = 1
        self._handoff_max_chunk_retries = 8
        self._handoff_nemesis = None
        self._handoff_transfers: List = []
        # serving (requires handoff: the KV blobs live inside its stores)
        self._serving_enabled = False
        self._serving_request_ms = 1
        self._serving_nemesis = None
        self._serving_cache: dict = {}  # (slot, partition) -> decoded KV map
        self._serving_acked: dict = {}  # key -> (version, value) at ack time
        self._serving_eps: dict = {}
        # durability (requires serving): per-slot WAL-record counts
        self._durability_enabled = False
        self._durability_replay_ms = 1
        self._durable_pending: dict = {}  # slot -> records since checkpoint
        # SLO (None: serving requests run the exact pre-SLO code)
        self._slo = None
        # hierarchy mirror
        self._hier_cell_of: Optional[np.ndarray] = None
        self._hier_n_cells = 0
        self._hier_round_ms = 1
        self._hier_leaders_per_cell = 1
        self._hier_rows: dict = {}
        self._hier_rounds = 0
        # membership-invariant element hashes: construction cost, not
        # protocol time (they feed every configuration_id fold)
        self.cluster.node_hashes()
        self._sorted_identifiers()
        self._seen_id_hashes()

    def _init_telemetry(self) -> None:
        """The metrics registry and tracer (the caller's, or per-simulator
        ones attached to the port's process-global plane), the stable-view
        timer on the virtual clock, the churn episode's trace context, and
        the flight recorder, stamped by an HLC on the virtual clock when
        ``config.forensics`` is set -- as the JAX driver builds them."""
        self.metrics = (
            self._metrics_override if self._metrics_override is not None
            else Metrics(parent=global_metrics(), plane="sim")
        )
        self.tracer = (
            self._tracer_override if self._tracer_override is not None
            else Tracer(parent=global_tracer(), plane="sim", track="sim")
        )
        # detection -> decision -> view installed on the virtual clock, with
        # the protocol plane's bucket edges
        self._stable_view = StableViewTimer(
            self.metrics, "sim", clock=lambda: self.virtual_ms)
        # the first fault injection of a churn episode mints a trace context;
        # the view_change span parents onto it; cleared at the install
        self._churn_ctx: Optional[TraceContext] = None
        self.hlc = None
        if self.config.forensics:
            self.hlc = HlcClock(clock=lambda: self.virtual_ms)
        self.recorder = FlightRecorder(
            node="sim", clock=lambda: self.virtual_ms, hlc=self.hlc, metrics=self.metrics)

    def _fresh_state(self, seed: int) -> SimState:
        """Fresh-configuration state, built on the device
        (engine.device_initial_state) with the key ``PRNGKey(seed)``, as the
        JAX driver seeds it, and placed on the mesh if there is one. A
        speculated state for exactly this configuration
        (``_speculate_view_change``, built with the same seed) is taken
        instead of a new build; the per-configuration latches are set here
        either way."""
        # extern proposal rows, the per-sender vote dedup, and the classic
        # round counter are per-configuration, like every consensus latch
        self._extern_rows: dict = {}  # proposal-mask bytes -> extern row
        self._extern_voted: Set[int] = set()
        self._last_announcement: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._classic_attempts = 0
        dev = self.device
        self._upload_ring_rank()
        self._subjects_host = None
        self._observers_host = None
        self._ring_nodes = None
        self._alive_dev = None
        self._probe_drop_dev = None  # partition set maps onto new adjacency
        self._down_reports_dev = None  # leave alerts map onto new adjacency
        spec = self._spec
        if (
            spec is not None
            and spec[0] == self.active.tobytes()
            and spec[1] == seed
            # the alive mask the worker baked in must still hold (a revive
            # or crash between speculation and decision invalidates it)
            and spec[4] == (self.alive & self.active).tobytes()
        ):
            self._spec = None
            self.metrics.incr("speculation_hits_fresh_state")
            return self._adopt(spec[3])
        return self._build_state(self.active, self.alive & self.active, seed)

    def _build_state(self, active: np.ndarray, alive: np.ndarray, seed: int) -> SimState:
        """A fresh configuration's state for ``active``/``alive`` on the
        device (engine.device_initial_state), its key ``PRNGKey(seed)``,
        placed on the mesh if there is one. Device ops and queued uploads
        only: no synchronizing call, so the speculation worker can run it."""
        state = device_initial_state(
            self.config,
            self._ring_rank_dev,
            self._tensor(active),
            self._tensor(alive),
            self._tensor(self.group_of),
            self._tensor(self.auto_vote),
            self._tensor(np.array(threefry.key_words(seed), dtype=np.int64)),
        )
        return state if self.mesh is None else place_state(state, self.mesh)

    def _upload_ring_rank(self) -> None:
        """Upload the ring rank table after identity seatings, once."""
        if self._ring_rank_dirty:
            self._ring_rank_dev = self._tensor(self.cluster.ring_rank())
            self._ring_rank_dirty = False

    def _tensor(self, arr: np.ndarray) -> torch.Tensor:
        """A copy of a host array on the device: never a view of the array,
        which the host goes on mutating, and on CUDA queued from pinned
        memory, so the host does not wait for it."""
        t = torch.from_numpy(np.array(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    # ------------------------------------------------------------------ #
    # Fault injection (BASELINE.json configs)
    # ------------------------------------------------------------------ #

    def _fd_signal(self, **attrs: object) -> None:
        """Root of a churn episode's trace: the protocol plane's edge-FD
        signal, so merged traces show one trace id from injection to view
        install whatever the plane; the journal entry carries it too."""
        signal = self.tracer.event("fd_signal", virtual_ms=self.virtual_ms, **attrs)
        if self._churn_ctx is None:
            self._churn_ctx = TraceContext(
                trace_id=signal.trace_id or signal.span_id,
                parent_span_id=signal.span_id,
                origin="sim",
            )
        self.recorder.record("fd_signal", trace_id=self._churn_ctx.trace_id, **attrs)

    def crash(self, node_ids: np.ndarray) -> None:
        """Crash-stop burst: nodes stop responding to probes and stop voting."""
        self._stable_view.detection()
        self._fd_signal(cause="crash", nodes=len(np.atleast_1d(node_ids)))
        self.alive[np.atleast_1d(node_ids)] = False
        self._alive_dev = self._tensor(self.alive)

    def revive(self, node_ids: np.ndarray) -> None:
        """Flip-flop support: nodes become reachable again (cumulative FD
        counters are deliberately NOT reset -- PingPongFailureDetector.java:116-118)."""
        node_ids = np.atleast_1d(node_ids)
        self.alive[node_ids] = self.active[node_ids]
        self._alive_dev = self._tensor(self.alive)

    def leave(self, node_ids: np.ndarray) -> None:
        """Graceful leave: each leaver proactively notifies its K observers,
        which broadcast DOWN alerts immediately (MembershipService.java:366-371,
        534-554). Leavers keep responding to probes until the view change
        removes them."""
        self._stable_view.detection()
        self._fd_signal(cause="leave", nodes=len(np.atleast_1d(node_ids)))
        for node in np.atleast_1d(node_ids):
            node = int(node)
            assert self.active[node], f"node {node} is not a member"
            # a crashed process cannot send a leave notification; its removal
            # must go through failure detection
            assert self.alive[node], f"node {node} is crashed, cannot leave"
            self._pending_leavers.add(node)
        self._down_reports_dev = None

    def inject_down_report(self, dst: int, rings) -> None:
        """Externally sourced DOWN reports for ``dst`` on the given rings.
        One-shot per configuration, like any other alert."""
        self._stable_view.detection()
        self._fd_signal(cause="injected_report", dst=int(dst))
        self._injected_down[dst, list(rings)] = True
        self._down_reports_dev = None

    def assign_identity(
        self, slot: int, hostname: bytes, port: int, id_high: int, id_low: int
    ) -> None:
        """Seat a process identity in an inactive slot ahead of its join; see
        VirtualCluster.assign_identity. Re-seating a slot whose previous
        identity was admitted in some past configuration is legal (the
        identifier history is stored by value), but identifier reuse is not
        (MembershipView.java:101-116)."""
        assert not self.active[slot] and slot not in self._pending_joiners
        assert (id_high, id_low) not in self._seen_identifier_set(), (
            "identifier reuse"
        )
        self.cluster.assign_identity(slot, hostname, port, id_high, id_low)
        # the device rank table is consumed at the next configuration rebuild
        # (_fresh_state), so a burst of seatings uploads it once
        self._ring_rank_dirty = True
        self._ring_nodes = None
        self._spec = None  # endpoint hashes / rank table changed

    def _seen_identifier_set(self) -> Set[Tuple[int, int]]:
        """Membership test over the identifier history, built on first use."""
        if self._seen_set is None:
            self._seen_set = {(int(h), int(l)) for h, l in self._seen_ids}
        return self._seen_set

    def is_identifier_seen(self, id_high: int, id_low: int) -> bool:
        return (id_high, id_low) in self._seen_identifier_set()

    @property
    def identifiers_seen(self) -> Set[Tuple[int, int]]:
        """The append-only identifier history, as (high, low) values."""
        return set(self._seen_identifier_set())

    @property
    def pending_joiners(self) -> Set[int]:
        return set(self._pending_joiners)

    @property
    def pending_leavers(self) -> Set[int]:
        return set(self._pending_leavers)

    def endpoint_of(self, slot: int) -> Tuple[bytes, int]:
        host = bytes(self.cluster.hostnames[slot, : self.cluster.host_lengths[slot]])
        return host, int(self.cluster.ports[slot])

    # ------------------------------------------------------------------ #
    # Placement plane (placement/device.py)
    # ------------------------------------------------------------------ #

    @property
    def placement(self):
        """The DevicePlacement (None unless enable_placement ran)."""
        return self._placement

    @property
    def placement_diffs(self) -> List:
        """DeviceDiff per view change since placement was enabled."""
        return list(self._placement_diffs)

    def enable_placement(
        self,
        partitions: int = 8192,
        replicas: int = 3,
        seed: int = 0,
        weights: Optional[np.ndarray] = None,
    ) -> None:
        """Attach the placement plane: a deterministic shard map over the
        live membership, updated incrementally inside every view change.

        The full [P, R] build over the whole slot universe happens HERE,
        once, on the simulator's device (the home device on a mesh) through
        the ``placement_topr`` kernel. View changes afterwards touch only
        the minimal-motion subset. Placement never advances virtual_ms: the
        map is state *derived from* the membership, not part of the
        protocol the simulator is timing."""
        cfg = PlacementConfig(partitions=partitions, replicas=replicas, seed=seed)
        placement = DevicePlacement(
            cfg,
            self.cluster.hostnames,
            self.cluster.host_lengths,
            self.cluster.ports,
            weights,
            device=self.device,
        )
        placement.build(self.active)
        self._placement = placement
        self._placement_diffs = []
        self.metrics.incr("placement.rebuilds")
        self.metrics.set_gauge("placement.imbalance", placement.imbalance())
        self.recorder.record(
            "placement_rebalance",
            configuration_id=self.configuration_id(),
            moved=0, version=placement.version,
        )

    # ------------------------------------------------------------------ #
    # Handoff plane (handoff/device.py)
    # ------------------------------------------------------------------ #

    @property
    def handoff_stores(self):
        """Per-slot InMemoryPartitionStore dict (None unless enabled)."""
        return self._handoff_stores

    @property
    def handoff_transfers(self) -> List:
        """DeviceTransferPlan lists, one per view change since enabling."""
        return list(self._handoff_transfers)

    def _virtual_nemesis(self, fault_plan):
        """A Nemesis armed now on this simulator's virtual clock; a plan of
        the JAX package crosses in through its JSON form."""
        if not isinstance(fault_plan, FaultPlan):
            fault_plan = FaultPlan.from_json(fault_plan.to_json())
        return Nemesis(fault_plan, _VirtualClock(self), metrics=self.metrics).arm()

    def enable_handoff(
        self,
        sizes: Optional[np.ndarray] = None,
        chunk_size: int = 1 << 16,
        chunk_ms: int = 1,
        fault_plan=None,
        max_chunk_retries: int = 8,
    ) -> None:
        """Attach the handoff plane: per-slot partition stores seeded for
        the current owners, with every subsequent placement diff's moved
        partitions transferred chunk-by-chunk between stores.

        Transfers are billed on virtual time (``chunk_ms`` per chunk plus
        any fault-plan delay) strictly AFTER the view installs, so the
        detection->decision->install stable-view distributions are
        untouched. ``fault_plan`` (a ``faults.FaultPlan`` of either package)
        makes chunk pulls suffer deterministic drops/duplicates/delays --
        dropped chunks retry up to ``max_chunk_retries`` before the session
        fails over to the next surviving source."""
        if self._placement is None:
            raise RuntimeError("enable_placement must run before enable_handoff")
        partitions = self._placement.config.partitions
        if sizes is None:
            sizes = (977 * np.arange(partitions, dtype=np.int64)) % 5000
        sizes = np.asarray(sizes, dtype=np.int64)
        if sizes.shape[0] != partitions:
            raise ValueError("sizes must have one entry per partition")
        self._handoff_sizes = sizes
        self._handoff_chunk_size = int(chunk_size)
        self._handoff_chunk_ms = int(chunk_ms)
        self._handoff_max_chunk_retries = int(max_chunk_retries)
        self._handoff_transfers = []
        self._handoff_nemesis = (
            self._virtual_nemesis(fault_plan) if fault_plan is not None else None)
        stores = {
            slot: InMemoryPartitionStore()
            for slot in range(self.config.capacity)
        }
        assign = self._placement.assign
        for p in range(partitions):
            payload = self._handoff_payload(p, int(sizes[p]))
            fingerprint = content_fingerprint(p, payload)
            for slot in assign[p]:
                if slot >= 0:
                    stores[int(slot)].put(p, payload, fingerprint=fingerprint)
        self._handoff_stores = stores

    @staticmethod
    def _handoff_payload(partition: int, size: int) -> bytes:
        """Deterministic per-partition content (cheap, numpy-generated)."""
        if size <= 0:
            return b""
        pattern = (
            np.arange(size, dtype=np.int64) * 31 + partition * 977 + 7
        ) & 0xFF
        return pattern.astype(np.uint8).tobytes()

    def _run_handoff(self, old_assign: np.ndarray, parent_span) -> None:
        """Execute every transfer the just-applied placement diff implies,
        deterministically (store-to-store, fault plan consulted per chunk).
        Runs after the view is installed; bills virtual time for the chunk
        pulls."""
        placement = self._placement
        plans = device_transfer_plans(
            old_assign, placement.assign, self.active, placement.keys64,
            placement.version, placement.config.seed, self._handoff_sizes,
            self._handoff_chunk_size,
        )
        self._handoff_transfers.append(plans)
        stores = self._handoff_stores
        nemesis = self._handoff_nemesis
        billed_ms = 0
        moved_ok: Set[Tuple[int, int]] = set()
        endpoints: dict = {}

        def ep(slot: int) -> Endpoint:
            cached = endpoints.get(slot)
            if cached is None:
                host, port = self.endpoint_of(slot)
                cached = endpoints[slot] = Endpoint(hostname=host, port=port)
            return cached

        for plan in plans:
            span = self._child_span(
                "handoff_session", parent_span,
                partition=plan.partition, session=plan.session_id,
                sources=len(plan.sources),
            )
            self.metrics.incr("handoff.sessions_started")
            completed = False
            not_found = 0
            reachable = 0
            for src in plan.sources:
                if not self.alive[src]:
                    self.metrics.incr("handoff.failovers")
                    continue
                reachable += 1
                data = stores[src].get(plan.partition)
                if data is None:
                    not_found += 1
                    continue
                schedule = chunk_spans(len(data), self._handoff_chunk_size)
                pulled = True
                n_chunks = 0
                for offset, length in schedule if schedule else ((0, 0),):
                    request = HandoffRequest(
                        sender=ep(plan.recipient),
                        session_id=plan.session_id,
                        partition=plan.partition, offset=offset,
                        length=length,
                    )
                    retries = 0
                    while True:
                        billed_ms += self._handoff_chunk_ms
                        if nemesis is not None:
                            decision = nemesis.decide(
                                ep(plan.recipient), ep(src), request, "egress"
                            )
                            billed_ms += decision.delay_ms
                            if decision.drop:
                                retries += 1
                                self.metrics.incr("handoff.retries")
                                if retries > self._handoff_max_chunk_retries:
                                    pulled = False
                                    break
                                continue
                            for _ in range(decision.duplicates):
                                self.metrics.incr("handoff.chunks_duplicate")
                        self.metrics.incr("handoff.chunks_sent")
                        self.metrics.incr("handoff.chunks_received")
                        self.metrics.incr("handoff.bytes_moved", length)
                        n_chunks += 1
                        break
                    if not pulled:
                        break
                if not pulled:
                    self.metrics.incr("handoff.failovers")
                    continue
                fingerprint = content_fingerprint(plan.partition, data)
                src_fp = stores[src].fingerprint(plan.partition)
                if src_fp is not None and fingerprint != src_fp:
                    self.metrics.incr("handoff.fingerprint_mismatches")
                    continue
                stores[plan.recipient].put(plan.partition, data, fingerprint=fingerprint)
                completed = True
                self.metrics.incr("handoff.sessions_completed")
                self.metrics.observe(
                    "handoff.session_bytes", len(data),
                    buckets=HANDOFF_BYTES_BUCKETS,
                )
                self.metrics.observe(
                    "handoff.session_chunks", max(1, n_chunks),
                    buckets=HANDOFF_CHUNKS_BUCKETS,
                )
                span.attrs["bytes"] = len(data)
                self.recorder.record(
                    "handoff_complete", partition=plan.partition,
                    session=plan.session_id, bytes=len(data), source=int(src),
                )
                break
            if not completed:
                if reachable > 0 and not_found == reachable:
                    # every reachable source is authoritative and empty:
                    # nothing to move (the live engine's vacuous completion)
                    completed = True
                    self.metrics.incr("handoff.sessions_completed")
                    span.attrs["empty"] = True
                else:
                    self.metrics.incr("handoff.sessions_failed")
                    span.attrs["failed"] = True
                    self.recorder.record(
                        "handoff_failed", partition=plan.partition,
                        session=plan.session_id, sources=len(plan.sources),
                    )
            if completed:
                moved_ok.add((plan.partition, plan.recipient))
            self.tracer.end(span, virtual_ms=self.virtual_ms)
        # releases: a donor drops its copy once every recipient of that
        # partition verified (a failed transfer keeps the old replica alive)
        by_partition: dict = {}
        for plan in plans:
            by_partition.setdefault(plan.partition, []).append(plan)
        for partition, group in by_partition.items():
            if not all((partition, g.recipient) in moved_ok for g in group):
                continue
            new_row = set(int(s) for s in placement.assign[partition] if s >= 0)
            old_row = [int(s) for s in old_assign[partition] if s >= 0]
            for slot in old_row:
                if slot in new_row or not self.alive[slot]:
                    continue
                if stores[slot].get(partition) is not None:
                    stores[slot].delete(partition)
                    self.metrics.incr("handoff.releases")
        # billed strictly after the install: the stable-view timer has
        # already stamped this churn
        self.virtual_ms += billed_ms

    # ------------------------------------------------------------------ #
    # Serving plane (the serving engine's mirror)
    # ------------------------------------------------------------------ #

    @property
    def serving_enabled(self) -> bool:
        return self._serving_enabled

    @property
    def serving_acked(self) -> dict:
        """Oracle: every acknowledged write, key -> (version, value) as of
        the ack. Zero-lost-writes checks read each key back and require a
        version >= the oracle's."""
        return dict(self._serving_acked)

    def enable_serving(self, request_ms: int = 1, fault_plan=None) -> None:
        """Attach the serving plane mirror: replicated Get/Put over the
        handoff stores. KV state persists as deterministic ``encode_kv``
        blobs INSIDE the handoff stores, so every view change moves serving
        data through the verified handoff sessions.

        Each client op bills ``request_ms`` of virtual time (one leader
        round trip); a dead leader costs one extra hop (redirect) and
        reads fall back to quorum reads until the next view installs.
        ``fault_plan`` makes replication writes suffer deterministic
        drops/duplicates/delays; a write only acks with a majority."""
        if self._handoff_stores is None:
            raise RuntimeError("enable_handoff must run before enable_serving")
        self._serving_nemesis = (
            self._virtual_nemesis(fault_plan) if fault_plan is not None else None)
        self._serving_request_ms = int(request_ms)
        # replace the synthetic handoff payloads with empty KV blobs: from
        # here on the stores hold serving data, and fingerprints still
        # agree across replicas because encode_kv is deterministic
        empty = encode_kv({})
        fingerprints: dict = {}
        for store in self._handoff_stores.values():
            for p in store.partitions():
                fp = fingerprints.get(p)
                if fp is None:
                    fp = fingerprints[p] = content_fingerprint(p, empty)
                store.put(p, empty, fingerprint=fp)
        self._serving_cache = {}
        self._serving_acked = {}
        self._serving_eps = {}
        self._serving_enabled = True

    def _serving_ep(self, slot: int):

        cached = self._serving_eps.get(slot)
        if cached is None:
            host, port = self.endpoint_of(slot)
            cached = self._serving_eps[slot] = Endpoint(hostname=host, port=port)
        return cached

    def _serving_kv(self, slot: int, p: int) -> dict:

        kv = self._serving_cache.get((slot, p))
        if kv is None:
            kv = decode_kv(self._handoff_stores[slot].get(p))
            self._serving_cache[(slot, p)] = kv
        return kv

    def _serving_persist(self, slot: int, p: int, kv: dict) -> None:

        self._handoff_stores[slot].put(p, encode_kv(kv))
        if self._durability_enabled:
            # one persisted blob == one WAL append on the live plane; the
            # count is what a post-crash replay has to re-apply
            self._durable_pending[slot] = self._durable_pending.get(slot, 0) + 1

    # -- SLO plane ----------------------------------------------------------- #

    def enable_slo(self, settings=None, catalog=None, windows=None):
        """Attach the SLO plane (slo/): online SLIs over the serving path,
        multi-window burn-rate alerts, and churn-episode attribution
        against this simulator's journal. ``settings.enabled`` is the kill
        switch: when False this is a no-op returning None and every
        serving request runs the exact pre-SLO path. Returns the SloPlane
        (or None when disabled)."""
        if settings is None:
            settings = SLOSettings(enabled=True)
        if not settings.enabled:
            self._slo = None
            return None
        self._slo = SloPlane(
            settings, metrics=self.metrics, recorder=self.recorder,
            catalog=catalog, windows=windows,
        )
        return self._slo

    def slo_plane(self):
        """The live SLO plane (None unless enable_slo attached one)."""
        return self._slo

    # -- hierarchy mirror --------------------------------------------------- #

    def enable_hierarchy(
        self,
        cells: int = 0,
        topology=None,
        parent_round_ms: int = 1,
        leaders_per_cell: int = 1,
    ) -> None:
        """Attach the hierarchy mirror: the simulator's analogue of the
        engine's two-level composition.

        Slots partition into cells by the same pure functions the engine
        uses -- topology zones when a LatencyTopology is given (slots ARE
        topology indices), the seeded rendezvous hash over the slot's
        endpoint otherwise (``cells.cell_of_endpoint``, here over every slot
        at once with the batched endpoint hash). Each view change then
        recomputes ONLY the touched cells' rows (epoch fold, leader order,
        membership fingerprint over the cell-local slice of the active
        mask) and, when the composition moved, bills one parent round of
        ``parent_round_ms`` on the virtual clock. Everything is a pure
        function of (membership, seed)."""
        resolved = cell_count(cells, topology)
        cl = self.cluster
        if topology is not None:
            cell_of = np.array(
                [topology.zone_of(slot) for slot in range(self.config.capacity)],
                dtype=np.int32)
        elif resolved <= 1:
            cell_of = np.zeros(self.config.capacity, dtype=np.int32)
        else:
            # rendezvous: each slot joins the cell whose seeded endpoint
            # hash is highest, the first such cell on a tie
            scores = np.stack([
                endpoint_hash_batch(cl.hostnames, cl.host_lengths, cl.ports,
                                    _CELL_SEED_BASE + cell)
                for cell in range(resolved)
            ])
            cell_of = np.argmax(scores, axis=0).astype(np.int32)
        self._hier_cell_of = cell_of
        self._hier_n_cells = resolved
        self._hier_round_ms = int(parent_round_ms)
        self._hier_leaders_per_cell = int(leaders_per_cell)
        self._hier_rows = {}
        self._hier_rounds = 0
        for cell in range(resolved):
            self._hierarchy_recompute_cell(cell)
        self.metrics.set_gauge("hierarchy.cells", resolved)

    def _hierarchy_recompute_cell(self, cell: int) -> None:
        """Rebuild one cell's composed-view row from its cell-local slice
        of the active mask (hierarchy/parent.py CellState discipline):
        ``parent.cell_leaders`` and ``parent.cell_fingerprint`` over the
        cell's members, with their endpoint hashes taken in one batch."""
        slots = np.flatnonzero(self.active & (self._hier_cell_of == cell))
        if not len(slots):
            self._hier_rows.pop(cell, None)
            return
        cl = self.cluster
        _, _, host_h, port_h = cl.node_hashes()
        hosts, lengths, ports = cl.hostnames[slots], cl.host_lengths[slots], cl.ports[slots]
        # leader order: ascending (leader-seeded endpoint hash, hostname,
        # port); only members hashing at or below the k-th smallest hash can
        # lead, so the full key sorts those alone
        lead_h = endpoint_hash_batch(hosts, lengths, ports, _LEADER_SEED)
        k = min(max(1, self._hier_leaders_per_cell), len(slots))
        bound = np.partition(lead_h, k - 1)[k - 1]
        order = sorted(
            (int(lead_h[i]), self.endpoint_of(int(slots[i])))
            for i in np.flatnonzero(lead_h <= bound))
        leaders = [Endpoint(*endpoint) for _h, endpoint in order[:k]]
        # the cell's epoch is a config-id-style chained fold over the
        # cell-local slice's element hashes: it moves exactly when the
        # cell's membership moves
        epoch = _fold(int(x) for x in np.sort(host_h[slots] ^ port_h[slots]))
        self._hier_rows[cell] = CellState(
            cell=cell,
            epoch=epoch,
            size=len(slots),
            leader=str(leaders[0]),
            fingerprint=_fold(
                int(x) for x in np.sort(endpoint_hash_batch(hosts, lengths, ports, 0))),
        )

    def _hierarchy_view_change(self, record, vc_span) -> None:
        """Mirror one view change into the composition: recompute touched
        cells only, bill one parent round when the composition moved."""
        touched = sorted(
            {int(self._hier_cell_of[s]) for s in record.added}
            | {int(self._hier_cell_of[s]) for s in record.removed}
        )
        before = self.global_fingerprint()
        for cell in touched:
            self._hierarchy_recompute_cell(cell)
        after = self.global_fingerprint()
        if after == before:
            return
        # one leader-to-leader parent round carries the moved cells' digests
        # to every other cell: O(cells) messages, one round of latency
        self._hier_rounds += 1
        self.virtual_ms += self._hier_round_ms
        self.metrics.incr("hierarchy.parent_rounds")
        self.metrics.set_gauge("hierarchy.live_cells", len(self._hier_rows))
        self.recorder.record(
            "parent_round",
            virtual_ms=self.virtual_ms,
            round=self._hier_rounds,
            cells=len(self._hier_rows),
            touched=len(touched),
            global_fingerprint=after,
            trace_id=vc_span.trace_id,
        )

    @property
    def hierarchy_enabled(self) -> bool:
        return self._hier_cell_of is not None

    @property
    def parent_rounds(self) -> int:
        """Parent rounds billed since enable_hierarchy."""
        return self._hier_rounds

    def hierarchy_rows(self):
        """The composed global view: CellState rows sorted by cell."""
        return tuple(self._hier_rows[cell] for cell in sorted(self._hier_rows))

    def global_fingerprint(self) -> int:
        """Composed global fingerprint (hierarchy/parent.py fold) of the
        mirror's current rows."""
        return compose_fingerprint(self.hierarchy_rows())

    def cell_of_slot(self, slot: int) -> int:
        """Cell of device slot ``slot`` (enable_hierarchy must have run)."""
        return int(self._hier_cell_of[slot])

    def serving_drive_open_loop(self, arrivals):
        """Drive the serving mirror with an open-loop arrival stream
        (slo/sli.py OpenLoopGenerator): each arrival is scheduled on the
        virtual clock independently of completions. When the server is
        idle the clock advances to the arrival; when it is behind, the
        request queues and its measured latency (completion minus
        *scheduled arrival*) includes the queueing delay. Feeds the SLO
        plane when one is attached. Returns
        ``[(arrival, status, latency_ms), ...]``."""
        if not self._serving_enabled:
            raise RuntimeError("serving is not enabled on this simulator")
        results = []
        for a in arrivals:
            at = int(a.at_ms)
            if self.virtual_ms < at:
                self.virtual_ms = at  # idle server: wait for the client
            if self._slo is not None:
                self._slo.record_offered(at)
            if a.op == "put":
                ack = self.serving_put(a.key, a.value)
            else:
                ack = self.serving_get(a.key)
            latency_ms = float(self.virtual_ms - at)
            ok = ack.status in (PutAck.STATUS_OK, PutAck.STATUS_NOT_FOUND) \
                if a.op == "get" else ack.status == PutAck.STATUS_OK
            if self._slo is not None:
                self._slo.record(self.virtual_ms, ok, latency_ms)
            results.append((a, int(ack.status), latency_ms))
        return results

    # -- durability mirror -------------------------------------------------- #

    def enable_durability(self, replay_record_ms: int = 1) -> None:
        """Attach the durability mirror: every serving persist counts as one
        WAL append, and :meth:`restart_slot` bills the log-over-snapshot
        replay on the virtual clock (``replay_record_ms`` per un-checkpointed
        record) -- the simulator's analogue of a durable store's recovery."""
        if not self._serving_enabled:
            raise RuntimeError("enable_serving must run before enable_durability")
        self._durability_replay_ms = int(replay_record_ms)
        self._durable_pending = {}
        self._durability_enabled = True

    def checkpoint_slot(self, slot: int) -> None:
        """Snapshot the slot's store: replay debt drops to zero, as a
        durable store's checkpoint truncates its log."""
        if not self._durability_enabled:
            raise RuntimeError("durability is not enabled on this simulator")
        self._durable_pending[slot] = 0
        self.metrics.incr("durability.snapshots")
        self.recorder.record("durability_checkpoint", node=f"slot{int(slot)}")

    def durable_pending(self, slot: int) -> int:
        """Records a restart of ``slot`` would replay (un-checkpointed)."""
        return self._durable_pending.get(int(slot), 0)

    def restart_slot(self, slot: int, down_ms: int = 0) -> int:
        """Crash-and-recover ``slot`` with its store intact: the node is dead
        for ``down_ms`` of virtual time, then replays its WAL debt at
        ``replay_record_ms`` per record before answering again. Returns the
        replayed-record count. The identity is retained -- a restart is not
        a leave, so no identifier churn and no view change is implied (the
        FD may still evict if ``down_ms`` outlasts detection)."""
        if not self._durability_enabled:
            raise RuntimeError("durability is not enabled on this simulator")
        slot = int(slot)
        self.crash(np.asarray([slot]))
        replayed = self._durable_pending.get(slot, 0)
        self.virtual_ms += int(down_ms) + replayed * self._durability_replay_ms
        if replayed:
            self.metrics.incr("durability.replayed_records", replayed)
        self.recorder.record(
            "durability_recovered", node=f"slot{slot}", replayed=replayed,
        )
        self.revive(np.asarray([slot]))
        return replayed

    def _serving_reconcile(self, old_assign) -> None:
        """Anti-entropy at the view-change boundary, BEFORE handoff runs:
        merge each partition's KV map (max version per key) across its live
        old-row replicas and persist the merged blob back to each of them,
        so handoff ships complete blobs to the new owners whichever source
        replica it copies from (an acked write reached a majority of the
        old row, so a live replica still holds it)."""
        stores = self._handoff_stores
        for p in range(old_assign.shape[0]):
            live = [
                int(s) for s in old_assign[p] if s >= 0 and self.alive[int(s)]
            ]
            if len(live) < 2:
                continue
            first = stores[live[0]].get(p)
            if all(stores[s].get(p) == first for s in live[1:]):
                # identical blobs decode to identical maps: the merge is
                # each of them, and nothing is written
                continue
            merged: dict = {}
            for s in live:
                for key, (version, value) in self._serving_kv(s, p).items():
                    cur = merged.get(key)
                    if cur is None or version > cur[0]:
                        merged[key] = (version, value)
            for s in live:
                if self._serving_kv(s, p) != merged:
                    self.metrics.incr("serving.reconciled_replicas")
                    self._serving_cache[(s, p)] = dict(merged)
                    self._serving_persist(s, p, merged)

    def _serving_row(self, key: bytes):

        p = partition_of(key, self._placement.config.partitions)
        row = [int(s) for s in self._placement.assign[p] if s >= 0]
        live = [s for s in row if self.alive[s]]
        return p, row, live

    def serving_put(self, key: bytes, value: bytes):
        """One closed-loop client write: route to the first live replica in
        placement order, replicate to the row, ack on majority. Returns a
        PutAck (STATUS_OK or STATUS_RETRY)."""
        if not self._serving_enabled:
            raise RuntimeError("serving is not enabled on this simulator")
        self.metrics.incr("serving.puts")
        t0 = self.virtual_ms
        self.virtual_ms += self._serving_request_ms
        p, row, live = self._serving_row(key)
        majority = len(row) // 2 + 1
        status = PutAck.STATUS_RETRY
        version = 0
        if live:
            leader = live[0]
            if row[0] != leader:
                # the map still names a dead leader: one redirect hop
                self.metrics.incr("serving.not_leader_redirects")
                self.virtual_ms += self._serving_request_ms
            kv = self._serving_kv(leader, p)
            version = kv.get(key, (0, b""))[0] + 1
            msg = Put(
                sender=self._serving_ep(leader), key=key, value=value,
                request_id=0, replicate=1, version=version,
            )
            acks = 0
            for slot in row:
                if not self.alive[slot]:
                    continue
                if slot != leader and self._serving_nemesis is not None:
                    decision = self._serving_nemesis.decide(
                        self._serving_ep(slot), self._serving_ep(leader),
                        msg, "egress",
                    )
                    # slow_ms covers disk_stall rules: the replica answers,
                    # but only after the stalled fsync returns
                    self.virtual_ms += decision.delay_ms + decision.slow_ms
                    if decision.drop:
                        continue
                skv = kv if slot == leader else self._serving_kv(slot, p)
                if version > skv.get(key, (0, b""))[0]:
                    skv[key] = (version, value)
                    self._serving_persist(slot, p, skv)
                acks += 1
                if slot != leader:
                    self.metrics.incr("serving.replication_writes")
                    self.metrics.incr("serving.put_acks")
            if acks >= majority:
                status = PutAck.STATUS_OK
                self._serving_acked[key] = (version, value)
            else:
                self.metrics.incr("serving.put_retries")
        else:
            self.metrics.incr("serving.put_retries")
        self.metrics.observe(
            "serving.request_ms", float(self.virtual_ms - t0),
            buckets=SERVING_LATENCY_BUCKETS_MS,
        )
        return PutAck(
            sender=self._serving_ep(row[0]) if row else None,
            status=status, key=key, version=version,
        )

    def serving_get(self, key: bytes):
        """One closed-loop client read: leader read while the placement
        leader is alive, quorum read (max version across a live majority)
        during the churn window. Returns a PutAck."""
        if not self._serving_enabled:
            raise RuntimeError("serving is not enabled on this simulator")
        self.metrics.incr("serving.gets")
        t0 = self.virtual_ms
        self.virtual_ms += self._serving_request_ms
        p, row, live = self._serving_row(key)
        majority = len(row) // 2 + 1
        status = PutAck.STATUS_RETRY
        version = 0
        value = b""
        if live and self.alive[row[0]]:
            self.metrics.incr("serving.leader_reads")
            version, value = self._serving_kv(row[0], p).get(key, (0, b""))
            status = PutAck.STATUS_OK if version else PutAck.STATUS_NOT_FOUND
        elif live:
            # leader churn: redirect hop + quorum read across live replicas
            self.metrics.incr("serving.not_leader_redirects")
            self.metrics.incr("serving.quorum_reads")
            self.virtual_ms += self._serving_request_ms
            if len(live) >= majority:
                for slot in live:
                    v, blob = self._serving_kv(slot, p).get(key, (0, b""))
                    if v > version:
                        version, value = v, blob
                status = (
                    PutAck.STATUS_OK if version else PutAck.STATUS_NOT_FOUND
                )
        self.metrics.observe(
            "serving.request_ms", float(self.virtual_ms - t0),
            buckets=SERVING_LATENCY_BUCKETS_MS,
        )
        return PutAck(
            sender=self._serving_ep(row[0]) if row else None,
            status=status, key=key, value=value, version=version,
        )

    def one_way_ingress_partition(self, node_ids: np.ndarray) -> None:
        """Asymmetric failure: probes TO these nodes are lost, their own
        traffic still flows (paper §7, iptables INPUT partitions). Persists
        across view changes until lifted."""
        self._stable_view.detection()
        self._ingress_partitioned.update(int(i) for i in np.atleast_1d(node_ids))
        self._probe_drop_dev = None

    def ingress_loss(self, node_ids: np.ndarray, probability: float) -> None:
        """Lossy ingress (e.g. 80% loss): probes to these nodes fail with
        the given probability each round."""
        self._drop_prob[np.atleast_1d(node_ids)] = probability

    def clear_link_faults(self) -> None:
        self._ingress_partitioned.clear()
        self._drop_prob[:] = 0.0
        self._deliver[:] = True
        self._deliver_delay[:] = 0
        self._deliver_delay_dev = None
        self._probe_drop_dev = None

    # ------------------------------------------------------------------ #
    # Heterogeneous broadcast delivery (almost-everywhere agreement)
    # ------------------------------------------------------------------ #

    def set_delivery_groups(self, group_of: np.ndarray) -> None:
        """Partition nodes into delivery classes (config.groups must cover
        the assignment)."""
        group_of = np.asarray(group_of, dtype=np.int32)
        assert group_of.shape == (self.config.capacity,)
        assert group_of.max(initial=0) < self.config.groups
        self.group_of = group_of
        self.state = dataclasses.replace(self.state, group_of=self._tensor(group_of))
        self._spec = None  # a speculated fresh state baked in the old groups

    def drop_broadcasts(self, receiver_group: int, sender_nodes: np.ndarray) -> None:
        """Group ``receiver_group`` stops hearing broadcasts originating from
        ``sender_nodes``."""
        self._deliver[receiver_group, np.atleast_1d(sender_nodes)] = False

    def delay_broadcasts(
        self, receiver_group: int, sender_nodes: np.ndarray, rounds: int
    ) -> None:
        """Broadcasts from ``sender_nodes`` reach ``receiver_group``
        ``rounds`` rounds late (requires config.max_delivery_delay >= rounds)."""
        assert 0 <= rounds <= self.config.max_delivery_delay, (
            f"delay {rounds} exceeds config.max_delivery_delay="
            f"{self.config.max_delivery_delay}"
        )
        self._deliver_delay[receiver_group, np.atleast_1d(sender_nodes)] = rounds
        self._deliver_delay_dev = None

    # ------------------------------------------------------------------ #
    # Bridged (external) voters
    # ------------------------------------------------------------------ #

    def set_auto_vote(self, slot: int, enabled: bool) -> None:
        """Transfer fast-round vote ownership of a slot between the engine
        and an external voter (a bridged real member). With auto_vote off,
        the slot's vote counts only when the host registers the node's
        actually-received vote. Clear it before the slot's first
        configuration as a member: an already-cast vote is not retracted."""
        self.auto_vote[slot] = bool(enabled)
        self.state = dataclasses.replace(self.state, auto_vote=self._tensor(self.auto_vote))
        self._spec = None  # a speculated fresh state baked in the old owner

    def register_extern_vote(self, slot: int, cut: np.ndarray) -> bool:
        """Count an external member's fast-round vote in the device tally
        (FastPaxos.java:134-150): intern the voted cut as a proposal row
        (identical values pool with group proposals in the tally), mark the
        sender's per-node vote state, and put the vote in flight so it
        arrives one delivery round later. Only the first vote of a sender in
        a configuration counts. Returns True iff the vote was registered.

        Until a classic round has run in this configuration no rank can
        exceed the fast rank, so the call reads nothing back from the device;
        its writes are device ops and, for a new row, one upload."""
        if slot in self._extern_voted:
            return False  # dedup by sender (FastPaxos.java:134-141)
        if self._classic_attempts > 0 and self._classic_rank(slot) >= FAST_RANK:
            # the slot already joined a classic round: its fast vote must not
            # count toward a fast quorum (registerFastRoundVote refuses once
            # rnd.round > 1, Paxos.java:246-248), the engine's gate too
            return False
        mask = np.zeros(self.config.capacity, dtype=bool)
        mask[np.atleast_1d(cut)] = True
        key = mask.tobytes()
        row = self._extern_rows.get(key)
        st = self.state
        if row is None:
            if len(self._extern_rows) >= self.config.extern_proposals:
                logging.getLogger(__name__).warning(
                    "no free extern proposal row (extern_proposals=%d); "
                    "dropping external vote from slot %d",
                    self.config.extern_proposals, slot,
                )
                return False
            row = self.config.groups + len(self._extern_rows)
            self._extern_rows[key] = row
            st = dataclasses.replace(
                st,
                proposal=_with(st.proposal, row, self._tensor(mask)),
                announced=_with(st.announced, row, True),
            )
        # out of place: an earlier state may still reference these tensors
        self.state = dataclasses.replace(
            st,
            voted=_with(st.voted, slot, True),
            vote_prop=_with(st.vote_prop, slot, row),
            vote_new=_with(st.vote_new, slot, True),
        )
        self._extern_voted.add(slot)
        return True

    def _classic_rank(self, slot: int) -> int:
        """The highest classic rank ``slot`` has promised (one audited
        sync)."""
        return int(jitwatch.fetch("sim.extern_vote_rank", self.state.classic_rnd[slot]))

    def _probe_drop_mask(self) -> np.ndarray:
        """Map the partitioned-destination set onto the current adjacency."""
        mask = np.zeros(self.config.capacity, dtype=bool)
        if self._ingress_partitioned:
            mask[list(self._ingress_partitioned)] = True
        if self._subjects_host is None:
            # one device->host copy per adjacency rebuild
            subjects = (self.state.subjects if self.mesh is None
                        else row_field(self.state, "subjects"))
            self._subjects_host = jitwatch.fetch("sim.subjects", subjects)
        return mask[self._subjects_host]

    def _has_down_reports(self) -> bool:
        return bool(self._pending_leavers) or bool(self._injected_down.any())

    def _down_reports(self) -> torch.Tensor:
        """dst-indexed proactive DOWN reports: pending leavers (the ring-k
        report for a leaver arrives iff its ring-k observer is alive to
        broadcast it, MembershipService.java:366-371) plus injected reports."""
        if self._down_reports_dev is None:
            mask = self._injected_down.copy()
            if self._pending_leavers:
                if self._observers_host is None:
                    # one device->host copy per adjacency rebuild
                    self._observers_host = jitwatch.fetch("sim.observers", self.state.observers)
                leavers = sorted(self._pending_leavers)
                obs = self._observers_host[leavers]  # [L, K]
                mask[leavers] |= self.alive[obs] & self.active[obs]
            self._down_reports_dev = self._tensor(mask)
        return self._down_reports_dev

    def _const_inputs(self, join_reports: Optional[np.ndarray]) -> RoundInputs:
        """This dispatch's fault plane, reusing the device-resident all-clear
        tensors whenever a fault class is inactive; on a mesh, placed
        (``probe_drop`` in row blocks on the shards' devices)."""
        if self._alive_dev is None:
            self._alive_dev = self._tensor(self.alive)
        if self._ingress_partitioned and self._probe_drop_dev is None:
            self._probe_drop_dev = self._tensor(self._probe_drop_mask())
        if not self._deliver_delay.any():
            deliver_delay = self._zero_delay
        else:
            if self._deliver_delay_dev is None:
                self._deliver_delay_dev = self._tensor(self._deliver_delay)
            deliver_delay = self._deliver_delay_dev
        inputs = RoundInputs(
            alive=self._alive_dev,
            probe_drop=(
                self._probe_drop_dev if self._ingress_partitioned else self._zero_ck
            ),
            drop_prob=(
                self._tensor(self._drop_prob)
                if (self._drop_prob > 0).any()
                else self._zero_drop_prob
            ),
            join_reports=(
                self._zero_ck if join_reports is None else self._tensor(join_reports)
            ),
            down_reports=(
                self._down_reports() if self._has_down_reports() else self._zero_ck
            ),
            deliver=(
                self._ones_deliver if self._deliver.all() else self._tensor(self._deliver)
            ),
            deliver_delay=deliver_delay,
        )
        return inputs if self.mesh is None else place_inputs(inputs, self.mesh)

    # ------------------------------------------------------------------ #
    # Profiling plane
    # ------------------------------------------------------------------ #

    def enable_profiling(self, settings=None):
        """Attach the continuous profiling plane (``profiling/``): sampled
        shadow attribution of the dispatch pipeline into FD-scan /
        cut-detector / consensus-count phases, the real decision fetch timed
        as the host-transfer phase, and a metric history ring ticked once
        per dispatch. ``settings.enabled`` is the kill switch: when False
        this is a no-op returning None and the loop stays the raw path. The
        shadow prefixes run once here for both loss models, so the kernels
        are built and loaded before any timed window. Shadow sampling is
        single-device; on a mesh only the history ring and the
        host-transfer phase are recorded. Returns the PhaseProfiler (or
        None when disabled)."""
        if settings is None:
            settings = ProfilingSettings(enabled=True)
        if not settings.enabled:
            self._profiler = None
            return None
        prof = PhaseProfiler(self.metrics, settings, plane="sim")
        if self.mesh is None:
            inputs = self._const_inputs(None)
            for random_loss in (False, True):
                prof.warm(self.config, self.state, inputs, random_loss)
        self._profiler = prof
        return prof

    # ------------------------------------------------------------------ #
    # Joins
    # ------------------------------------------------------------------ #

    def request_joins(self, node_ids: np.ndarray) -> None:
        """A join wave: each joining slot's K expected observers emit UP
        alerts with the ring numbers the joiner assigned
        (MembershipService.java:229-251). Pending joiners re-attempt in every
        new configuration until admitted."""
        self._stable_view.detection()
        for node in np.atleast_1d(node_ids):
            node = int(node)
            assert not self.active[node], f"node {node} already a member"
            nid = (int(self.cluster.id_high[node]), int(self.cluster.id_low[node]))
            assert nid not in self._seen_identifier_set(), (
                f"identifier reuse at {node}"
            )
            self._pending_joiners.add(node)
        self._join_reports_armed = False

    def cancel_join(self, slot: int) -> None:
        """Withdraw a pending join; its UP reports stop being armed from the
        next dispatch."""
        self._pending_joiners.discard(slot)
        self._join_reports_armed = False

    def _arm_pending_joins(self) -> Optional[np.ndarray]:
        """Build this configuration's join reports and write each joiner's
        expected observers into its (otherwise unused) observers row so the
        implicit-invalidation pass covers joins (MultiNodeCutDetector.java:146-158)."""
        if not self._pending_joiners or self._join_reports_armed:
            return None
        self._join_reports_armed = True
        k = self.config.k
        with self.tracer.span("join_arm", joiners=len(self._pending_joiners)):
            join_reports = np.zeros((self.config.capacity, k), dtype=bool)
            # once per join wave, not per dispatch
            observers = jitwatch.fetch("sim.observers", self.state.observers).copy()
            for node in sorted(self._pending_joiners):
                obs_ids, obs_alive = self._expected_observers(node)
                join_reports[node, :] = obs_alive
                observers[node, :] = obs_ids
            self.state = dataclasses.replace(self.state, observers=self._tensor(observers))
        return join_reports

    def expected_observers(self, node: int) -> Tuple[np.ndarray, np.ndarray]:
        """Public alias of ``_expected_observers`` (the messaging bridge's
        call)."""
        return self._expected_observers(node)

    def _expected_observers(self, node: int) -> Tuple[np.ndarray, np.ndarray]:
        """The node's ring predecessors (MembershipView.java:293-304 for
        joiners) and whether each is alive to vouch."""
        k = self.config.k
        ids = np.zeros(k, dtype=np.int32)
        alive = np.zeros(k, dtype=bool)
        signed = self.cluster.ring_hashes.view(np.int64)
        if self._ring_nodes is None:
            with self.tracer.span("ring_order"):
                full_order = self.cluster.full_ring_order()
                self._ring_nodes = []
                for ring in range(k):
                    nodes = full_order[ring][self.active[full_order[ring]]]
                    self._ring_nodes.append((nodes, signed[ring, nodes]))
        for ring in range(k):
            ring_nodes, ring_hashes = self._ring_nodes[ring]
            me = signed[ring, node]
            pos = np.searchsorted(ring_hashes, me)
            pred = ring_nodes[pos - 1] if pos > 0 else ring_nodes[-1]
            ids[ring] = pred
            alive[ring] = self.alive[pred]
        return ids, alive

    # ------------------------------------------------------------------ #
    # Round loop
    # ------------------------------------------------------------------ #

    def run_until_decision(
        self, max_rounds: int = 64, batch: int = 8,
        classic_fallback_after_rounds: Optional[int] = 8,
        stop_when_announced: bool = False,
    ) -> Optional[ViewChangeRecord]:
        """Run device batches until consensus decides a cut, then apply the
        view change. Returns the record, or None if no decision in budget.

        Under a deterministic fault plane each batch is one closed-form
        dispatch (engine.run_until_decided_const); under random ingress loss
        it is a scan of ``step`` (engine.run_rounds_const), whose FD phase is
        the CUDA kernel ``fd_phase_fused`` (with the round's key split and
        draw). On a mesh each batch is one dispatch of the sharded runner
        (``shard.engine.make_sharded_run_until``), whose FD phase is the CUDA
        kernels ``fd_phase_rows`` on every device and ``fd_gather`` on home. Either way the host syncs once per batch, fetching the packed
        decision words (``jitwatch.fetch("sim.decision_words")``); while it
        waits, a worker builds the view change the fault plane predicts
        (``_speculate_view_change``). Each batch bills the ``rounds`` it
        executed (masked no-op rounds are not billed) and one
        ``device_dispatches``, inside a ``device_rounds`` span; with
        ``enable_profiling`` a sampled batch is first attributed in shadow.

        If the fast round stalls for ``classic_fallback_after_rounds``
        rounds, a classic Paxos recovery round runs (``_run_classic_round``,
        at most one per batch); a decision there bills the exchange's hops
        and sets ``via_classic_round`` on the record.

        ``stop_when_announced``: return (None) as soon as a proposal is
        announced but undecided, leaving the announcement snapshot in
        ``last_announcement``."""
        t0 = time.perf_counter()
        rounds_done = 0
        while rounds_done < max_rounds:
            join_reports = self._arm_pending_joins()
            with self.tracer.span("dispatch_inputs"):
                inputs = self._const_inputs(join_reports)
            n = min(batch, max_rounds - rounds_done)
            random_loss = bool((self._drop_prob > 0).any())
            prof = self._profiler
            if prof is not None:
                # shadow attribution of 1-of-N dispatches against the live
                # pre-dispatch state (the prefixes leave it, its key
                # included, as it was); the history ring ticks every one
                if self.mesh is None and prof.should_sample():
                    prof.sample(self.config, self.state, inputs, random_loss)
                prof.tick_history()
            if stop_when_announced and not random_loss:
                # the closed form pauses at the announcement round itself,
                # so the whole remaining budget rides one dispatch
                n = max_rounds - rounds_done
            spec_worker = None
            try:
                with self.tracer.span("device_rounds", virtual_ms=self.virtual_ms,
                                      rounds=n) as dispatch_span:
                    with self.tracer.span("dispatch_enqueue"):
                        if self.mesh is not None:
                            # rounds after the decision (and, for
                            # stop_when_announced, the announcement) run as
                            # masked no-ops; the budget is an argument, so
                            # every batch size shares one cached runner
                            self.state = self._sharded_run_until(
                                random_loss, stop_when_announced)(self.state, inputs, n)
                        elif random_loss:
                            for chunk in _pow2_chunks(n, batch):
                                self.state = run_rounds_const(
                                    self.config, self.state, inputs, chunk, True)
                        else:
                            self.state = run_until_decided_const(
                                self.config, self.state, inputs, n,
                                bool(self._deliver.all()), stop_when_announced,
                            )
                        # ONE device->host copy syncs the batch and fetches
                        # everything a decision needs
                        packed = pack_decision(self.config, self.state)
                    # the speculation worker runs while the host waits for
                    # the fetch (started after the enqueue: its host work
                    # would slow the enqueue down)
                    spec_worker = self._speculate_view_change()
                    with self.tracer.span("decision_fetch") as fetch_span:
                        words = jitwatch.fetch("sim.decision_words", packed)
                    if prof is not None:
                        prof.record_host_transfer(fetch_span.wall_ms)
            finally:
                if spec_worker is not None:
                    spec_worker.join()
            (decided, announced_np, announced_round_np, proposal_np,
             decided_group, decided_round, round_np) = unpack_decision(self.config, words)
            # bill the rounds that executed: a dispatch runs its whole budget,
            # but rounds after the decision (or before the closed form's
            # fast-forward start) leave the round counter as it was
            self.metrics.incr("rounds", round_np - self._rounds_executed)
            self._rounds_executed = round_np
            self.metrics.incr("device_dispatches")
            # the span is recorded already; its virtual extent closes on the
            # rounds executed (billing happens at decision/announcement)
            dispatch_span.virtual_end_ms = self.virtual_ms + (
                self._rounds_executed - self._billed_rounds) * self._round_ms
            rounds_done += n
            if decided:
                return self._apply_view_change(
                    t0, (proposal_np, decided_group, decided_round)
                )
            if announced_np.any():
                self._last_announcement = (announced_np, proposal_np)
                if stop_when_announced and announced_np[: self.config.groups].any():
                    # bill exactly the rounds this configuration has executed
                    self.virtual_ms += (round_np - self._billed_rounds) * self._round_ms
                    self._billed_rounds = round_np
                    return None
                # the fallback timer runs from propose() (FastPaxos.java:105-107)
                stalled_rounds = round_np - announced_round_np
                if (
                    classic_fallback_after_rounds is not None
                    and stalled_rounds >= classic_fallback_after_rounds
                ):
                    winner, exchange_rounds = self._run_classic_round()
                    if winner is not None:
                        # the fetched words hold every proposal row, so the
                        # decision needs no write back to the device
                        record = self._apply_view_change(
                            t0, (proposal_np, winner, round_np + exchange_rounds)
                        )
                        record.via_classic_round = True
                        return record
        self.virtual_ms += rounds_done * self._round_ms
        self._billed_rounds += rounds_done
        return None

    def _speculate_view_change(self) -> Optional[threading.Thread]:
        """Start a worker that builds the view change the fault plane
        predicts (cut = dead or leaving members) -- its configuration-id fold
        and its fresh state -- while the calling thread waits in the
        decision fetch. ``_fresh_state`` and
        ``configuration_id`` take the results only when the decided
        membership (and, for the state, the seed and the alive mask) matches
        bit for bit; any surprise falls back to the normal path. Joins are
        never speculated (admissions grow the identifier history).

        Every cache the worker reads is warmed here, so it only reads shared
        state. On the card its device work runs on a side stream that first
        waits for the work queued so far on the caller's stream, so the
        fetch's copy never queues behind it (``_adopt`` hands the state
        back). It makes no synchronizing call
        (torch's sync debug mode is process-global, so one would trip a
        timed window armed on the calling thread; a sync error it meets is
        recorded in ``jitwatch.violations()``). It touches no
        per-configuration latch: ``_fresh_state`` sets those on a hit as on a
        miss."""
        if not self.speculate or self._pending_joiners:
            return None
        cut_pred = self.active & ~self.alive
        if self._pending_leavers:
            leavers = list(self._pending_leavers)
            cut_pred[leavers] = self.active[leavers]
        if not cut_pred.any():
            return None
        new_active = self.active & ~cut_pred
        key = new_active.tobytes()
        if self._spec is not None and self._spec[0] == key:
            return None  # this outcome is already speculated
        self._sorted_identifiers()
        self._seen_id_hashes()
        self.cluster.node_hashes()
        self.cluster.full_ring_order()
        self._upload_ring_rank()
        seed = self.seed + len(self.view_changes) + 1
        alive_pred = self.alive & new_active
        stream = None
        if self.device.type == "cuda":
            if self._spec_stream is None:
                self._spec_stream = torch.cuda.Stream(self.device)
            stream = self._spec_stream
            stream.wait_stream(torch.cuda.current_stream(self.device))

        def work() -> None:
            try:
                with (torch.cuda.stream(stream) if stream is not None
                      else contextlib.nullcontext()):
                    cid = self._fold_configuration_id(new_active)
                    state = self._build_state(new_active, alive_pred, seed)
                self._spec = (key, seed, cid, state, alive_pred.tobytes())
            except Exception as exc:  # a failed guess must never break the run
                jitwatch.record_sync_error("the speculation worker", exc)
                logging.getLogger(__name__).warning(
                    "speculative view change failed; the view change is built after "
                    "the fetch", exc_info=True)
                self._spec = None

        worker = threading.Thread(target=work, daemon=True)
        worker.start()
        return worker

    def _adopt(self, state: SimState) -> SimState:
        """A state the speculation worker built, handed to the caller's
        stream: on the card, that stream waits for the side stream's build,
        and the state's memory on this card is kept from reuse until the
        caller's stream is done with it."""
        side = self._spec_stream
        if side is None:
            return state
        current = torch.cuda.current_stream(self.device)
        current.wait_stream(side)
        for t in _tensors(state):
            if t.device == side.device:
                t.record_stream(current)
        return state

    @property
    def last_announcement(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """(announced[P], proposal[P, C]) snapshot from the most recent
        dispatch that saw an undecided announcement; None in a fresh
        configuration."""
        return self._last_announcement

    @property
    def _round_ms(self) -> int:
        """Protocol time per engine round (a whole FD interval, or a fraction
        of one under the staggered-phase asynchrony model)."""
        return self.config.fd_interval_ms // self.config.rounds_per_interval

    def _sharded_run(self, rounds: int, random_loss: bool):
        """The mesh round loop of ``rounds`` rounds, cached per (length,
        loss model). Kept for differential testing against the runner the
        driver dispatches."""
        key = (rounds, random_loss)
        if key not in self._sharded_runs:
            self._sharded_runs[key] = make_sharded_run(
                self.config, self.mesh, rounds, random_loss)
        return self._sharded_runs[key]

    def _sharded_run_until(self, random_loss: bool, stop_when_announced: bool = False):
        """The mesh decision runner, cached per (loss model, announcement
        stop): the round budget is an argument, so every batch size shares
        one runner."""
        key = ("until", random_loss, stop_when_announced)
        if key not in self._sharded_runs:
            self._sharded_runs[key] = make_sharded_run_until(
                self.config, self.mesh, random_loss, stop_when_announced)
        return self._sharded_runs[key]

    def _run_classic_round(self) -> Tuple[Optional[int], int]:
        """One classic recovery attempt with per-node acceptor state on the
        device (``classic.py``). Every live node's expovariate fallback timer
        races (FastPaxos.java:200-203: delay ~ Exp(1/N)); the nodes whose
        timers fire within one round of the first coordinate concurrently (at
        most 3), their promises contending on the shared acceptor state. The
        attempt's round number grows with each attempt, so retries outrank
        earlier rounds.

        Returns (decided proposal row or None, the winning coordinator's
        exchange rounds to bill -- _CLASSIC_ROUND_HOPS when the attempt
        failed or no latency skew is active)."""
        live = self.active & self.alive
        n = int(self.active.sum())
        if int(live.sum()) <= n // 2:
            return None, _CLASSIC_ROUND_HOPS
        if 2 + self._classic_attempts >= (1 << (31 - RANK_BITS)):
            return None, _CLASSIC_ROUND_HOPS  # rank space exhausted: stay stalled
        self._classic_attempts += 1
        live_slots = np.flatnonzero(live)
        times = self._host_rng.exponential(scale=max(n, 1), size=len(live_slots))
        order = np.argsort(times)
        sorted_times = times[order]
        racing = min(1 + int((sorted_times[1:] - sorted_times[0] < 1.0).sum()), 3)
        coordinators = [
            ClassicCoordinator(
                self, round_no=1 + self._classic_attempts, slot=int(live_slots[order[i]])
            )
            for i in range(racing)
        ]
        # phase1 wave in arrival order; the higher slot outranks within the
        # shared round, and the acceptors' rank checks arbitrate
        promised = [c.phase1() for c in coordinators]
        decided = None
        exchange_rounds = _CLASSIC_ROUND_HOPS
        for coordinator, ok in zip(coordinators, promised):
            if not ok:
                continue
            row = coordinator.pick_value()
            if row is None:
                continue
            won = coordinator.phase2(row)
            if won is not None and decided is None:
                decided = won
                exchange_rounds = coordinator.elapsed_rounds
        if racing > 1:
            self.metrics.incr("classic_coordinator_races")
        return decided, exchange_rounds

    def _apply_view_change(
        self,
        t0: float,
        fetched: Tuple[np.ndarray, int, int],  # (proposal[P,C], group, round)
    ) -> ViewChangeRecord:
        self.metrics.incr("view_changes")
        vc_span = self.tracer.begin("view_change", virtual_ms=self.virtual_ms)
        if self._churn_ctx is not None:
            # remote-span edge: parent the install under the churn episode's
            # root, so a merged trace stitches injection -> install
            vc_span.parent_id = self._churn_ctx.parent_span_id
            vc_span.trace_id = self._churn_ctx.trace_id or vc_span.trace_id
            vc_span.attrs.setdefault("origin", self._churn_ctx.origin)
        self._config_id = None  # membership / identifier history change below
        proposal_np, decided_group, decided_round = fetched
        # the winning proposal row's value is the decided cut
        cut = proposal_np[int(decided_group)]
        decided_round = int(decided_round)
        removed = np.flatnonzero(cut & self.active)
        added = np.flatnonzero(cut & ~self.active)
        self.active[removed] = False
        self.active[added] = True
        self.alive[added] = True
        if len(added):
            new_ids = np.stack(
                [self.cluster.id_high[added], self.cluster.id_low[added]], axis=1
            )
            self._seen_ids = np.concatenate([self._seen_ids, new_ids])
            if self._seen_set is not None:
                self._seen_set.update((int(h), int(l)) for h, l in new_ids)
            if self._seen_hashes is not None:
                high_h, low_h, _, _ = self.cluster.node_hashes()
                self._seen_hashes = np.concatenate(
                    [
                        self._seen_hashes,
                        np.stack([high_h[added], low_h[added]], axis=1),
                    ]
                )
            self._ids_sorted = None
        self._pending_joiners.difference_update(int(i) for i in added)
        self._ingress_partitioned.difference_update(int(i) for i in removed)
        self._join_reports_armed = False  # still-pending joiners re-attempt
        # removed leavers shut down for good; still-pending leavers re-notify
        # their observers in the new configuration
        left = self._pending_leavers.intersection(int(i) for i in removed)
        self._pending_leavers.difference_update(left)
        self.alive[list(left)] = False
        self._injected_down[:] = False  # alerts are per-configuration

        # protocol-time: only the rounds of this configuration not yet billed
        # (decided_round includes the vote-delivery round between announcement
        # and decision), plus the batching window before the alert broadcast
        unbilled = decided_round - self._billed_rounds
        self.virtual_ms += unbilled * self._round_ms + self.config.batching_window_ms
        self._billed_rounds = 0
        self._rounds_executed = 0  # fresh configuration: state.round resets
        self._stable_view.decision(self.virtual_ms)
        id_span = self._child_span("config_id", vc_span)
        configuration_id = self.configuration_id()
        self.tracer.end(id_span, virtual_ms=self.virtual_ms)
        record = ViewChangeRecord(
            cut=np.flatnonzero(cut),
            added=added,
            removed=removed,
            configuration_id=configuration_id,
            virtual_time_ms=self.virtual_ms,
            wall_time_s=time.perf_counter() - t0,
            membership_size=int(self.active.sum()),
        )
        self.view_changes.append(record)
        # new configuration: rebuild adjacency, reset per-config state;
        # crashes persist across configurations
        state_span = self._child_span("fresh_state", vc_span)
        self.state = self._fresh_state(self.seed + len(self.view_changes))
        self.tracer.end(state_span, virtual_ms=self.virtual_ms)
        # a speculation serves exactly one view change: the identifier
        # history can grow afterwards, which changes the fold even for an
        # identical active mask
        self._spec = None
        self._stable_view.view_installed(self.virtual_ms)
        # fault-plane occupancy from the host mirrors, once per view change
        self.metrics.set_gauge("sim.fault.crashed", int((self.active & ~self.alive).sum()))
        self.metrics.set_gauge("sim.fault.ingress_partitioned", len(self._ingress_partitioned))
        self.metrics.set_gauge("sim.fault.lossy", int((self._drop_prob > 0).sum()))
        self.metrics.set_gauge("sim.membership_size", record.membership_size)
        self.metrics.set_gauge("sim.pending_joiners", len(self._pending_joiners))
        if self._placement is not None:
            self._placement_view_change(record, vc_span)
        if self._hier_cell_of is not None:
            # composition mirror: touched cells' rows recompute, one
            # virtual-time parent round when the composed fingerprint moved
            # (billed after the install, like handoff)
            self._hierarchy_view_change(record, vc_span)
        vc_span.attrs.update(
            cut=len(record.cut), added=len(record.added), removed=len(record.removed),
            configuration_id=record.configuration_id,
        )
        self.tracer.end(vc_span, virtual_ms=self.virtual_ms)
        self.recorder.record(
            "view_install", configuration_id=record.configuration_id,
            size=record.membership_size, trace_id=vc_span.trace_id,
            removed=len(record.removed), added=len(record.added),
        )
        self._churn_ctx = None  # the next churn episode roots a fresh trace
        if self._slo is not None:
            # the install may have jumped the virtual clock: re-evaluate the
            # burn windows at the new now before the next request lands
            self._slo.tick(self.virtual_ms)
        return record

    def _child_span(self, name: str, parent, **attrs: object):
        """``tracer.begin`` parented under ``parent`` (a span ``begin``
        opened, so not the current span), at the virtual clock's now."""
        span = self.tracer.begin(name, virtual_ms=self.virtual_ms, **attrs)
        span.parent_id = parent.span_id
        span.trace_id = parent.trace_id
        return span

    def _placement_view_change(self, record: ViewChangeRecord, vc_span) -> None:
        """The planes' part of a view change, in the JAX driver's order:
        the placement map's incremental update (a ``placement_topr`` call
        for the affected rows and one for the added columns, one fetch;
        derived state, so no protocol time), then with handoff the serving
        reconcile, the transfers and the serving cache reset."""
        p_span = self._child_span("placement_rebalance", vc_span,
                                  size=record.membership_size)
        old_assign = (
            self._placement.assign.copy() if self._handoff_stores is not None else None
        )
        diff = self._placement.apply_view_change(self.active)
        self._placement_diffs.append(diff)
        p_span.attrs.update(moved=diff.moved, version=self._placement.version)
        self.tracer.end(p_span, virtual_ms=self.virtual_ms)
        self.metrics.incr("placement.rebuilds")
        self.metrics.observe(
            "placement.partitions_moved", diff.moved, buckets=PARTITIONS_MOVED_BUCKETS,
        )
        self.metrics.set_gauge("placement.imbalance", self._placement.imbalance())
        self.recorder.record(
            "placement_rebalance", configuration_id=record.configuration_id,
            moved=diff.moved, version=self._placement.version,
        )
        if old_assign is None:
            return
        if self._serving_enabled:
            # before blobs move: every live old-row replica takes the union
            # of acked writes, so handoff ships complete content
            self._serving_reconcile(old_assign)
        self.recorder.record(
            "handoff_started", configuration_id=record.configuration_id,
            version=self._placement.version,
        )
        self._run_handoff(old_assign, p_span)
        if self._serving_enabled:
            # handoff copied and released blobs between stores: every cached
            # decode may be stale, and the new leaders come from the fresh rows
            self._serving_cache = {}
            self.metrics.incr(
                "serving.leader_changes",
                int(np.count_nonzero(old_assign[:, 0] != self._placement.assign[:, 0])),
            )

    # ------------------------------------------------------------------ #

    def configuration_id(self) -> int:
        """Bit-exact configuration identity of the current membership,
        memoized until the next view change; the speculation worker's fold
        when it folded exactly this membership."""
        if self._config_id is not None:
            return self._config_id
        if self._spec is not None and self._spec[0] == self.active.tobytes():
            self.metrics.incr("speculation_hits_config_id")
            self._config_id = self._spec[2]
            return self._config_id
        self._config_id = self._fold_configuration_id(self.active)
        return self._config_id

    def _fold_configuration_id(self, active: np.ndarray) -> int:
        """The chained configuration-id fold over the identifier history and
        ``active``'s ring-0 endpoints, from the cached element hashes."""
        _, _, host_h, port_h = self.cluster.node_hashes()
        order = self._sorted_identifiers()
        seen_h = self._seen_id_hashes()
        order0 = ring_order(self.cluster, active, 0)
        return config_fold(
            seen_h[order, 0], seen_h[order, 1], host_h[order0], port_h[order0]
        )

    def sorted_identifiers(self) -> np.ndarray:
        """The identifier history as [M, 2] (high, low) values in NodeId
        (signed-lexicographic) order."""
        return self._seen_ids[self._sorted_identifiers()]

    def _sorted_identifiers(self) -> np.ndarray:
        """Indices into the seen-identifier history in NodeId (high, low)
        signed-lexicographic order, cached until a new identifier is admitted."""
        if self._ids_sorted is None:
            self._ids_sorted = np.lexsort(
                (self._seen_ids[:, 1], self._seen_ids[:, 0])
            )
        return self._ids_sorted

    def _seen_id_hashes(self) -> np.ndarray:
        """xxHash64 of each seen identifier's high/low values ([M, 2] uint64),
        maintained incrementally at admissions."""
        if self._seen_hashes is None or len(self._seen_hashes) != len(self._seen_ids):
            m = len(self._seen_ids)
            eight = np.full(m, 8, dtype=np.int64)
            self._seen_hashes = np.stack(
                [
                    xxh64_batch_auto(_int64_le_bytes(self._seen_ids[:, 0]), eight, 0),
                    xxh64_batch_auto(_int64_le_bytes(self._seen_ids[:, 1]), eight, 0),
                ],
                axis=1,
            )
        return self._seen_hashes

    def ready(self) -> "Simulator":
        """Block until construction/rebuild work has drained from the device
        queue -- separates setup cost from measured protocol time."""
        devices = self.mesh.local_devices if self.mesh is not None else (self.device,)
        jitwatch.drain("sim.ready", *devices)
        return self

    @property
    def membership_size(self) -> int:
        return int(self.active.sum())

    def members(self) -> np.ndarray:
        return np.flatnonzero(self.active)

    # ------------------------------------------------------------------ #
    # Configuration snapshot
    # ------------------------------------------------------------------ #

    def save_configuration(self, path: str, extra: Optional[dict] = None) -> None:
        """Persist the configuration snapshot, with the JAX driver's keys, so
        either package's ``from_configuration`` restores it: node identities,
        the membership, the append-only identifier history, and the clock
        (MembershipView Configuration, MembershipView.java:517-548).
        Per-round device state is not persisted; a restarted simulator starts
        a fresh configuration. ``extra``: more arrays, stored under
        ``extra_``-prefixed keys and ignored by ``from_configuration``."""
        np.savez_compressed(
            path,
            **{f"extra_{k}": v for k, v in (extra or {}).items()},
            hostnames=self.cluster.hostnames,
            host_lengths=self.cluster.host_lengths,
            ports=self.cluster.ports,
            id_high=self.cluster.id_high,
            id_low=self.cluster.id_low,
            ring_hashes=self.cluster.ring_hashes,
            active=self.active,
            alive=self.alive,
            identifiers_seen=self._seen_ids,  # [M, 2] (high, low) values
            virtual_ms=np.int64(self.virtual_ms),
            group_of=self.group_of,
            params=np.array(
                [self.config.capacity, self.config.k, self.config.h, self.config.l,
                 self.config.fd_threshold, self.config.fd_interval_ms,
                 self.config.batching_window_ms, self.seed, self.config.groups],
                dtype=np.int64,
            ),
        )

    @staticmethod
    def from_configuration(
        path: str, mesh: Optional[Mesh] = None,
        config_overrides: Optional[dict] = None, device=None,
    ) -> "Simulator":
        """Rebuild a simulator from a configuration snapshot written by
        either package's ``save_configuration``; the configuration id of the
        restored instance equals the saved one. ``config_overrides``:
        SimConfig fields to replace on top of the saved parameters.
        ``mesh`` and ``device`` as for the constructor; speculation as its
        default, fresh telemetry."""
        with np.load(path) as data:
            params = [int(x) for x in data["params"]]
            (capacity, k, h, l, fd_threshold, fd_interval_ms,
             batching_window_ms, seed) = params[:8]
            groups = params[8] if len(params) > 8 else 1  # pre-groups snapshots
            config = SimConfig(
                capacity=capacity, k=k, h=h, l=l, fd_threshold=fd_threshold,
                fd_interval_ms=fd_interval_ms, batching_window_ms=batching_window_ms,
                groups=groups,
            )
            if config_overrides:
                config = dataclasses.replace(config, **config_overrides)
            sim = Simulator.__new__(Simulator)
            sim.device = mesh.home if mesh is not None else resolve_device(device)
            sim.mesh = mesh
            sim.config = config
            sim.speculate = _speculates(None, sim.device)
            sim._metrics_override = None
            sim._tracer_override = None
            sim.cluster = VirtualCluster(
                hostnames=data["hostnames"],
                host_lengths=data["host_lengths"],
                ports=data["ports"],
                id_high=data["id_high"],
                id_low=data["id_low"],
                ring_hashes=data["ring_hashes"],
            )
            sim.active = data["active"].copy()
            sim.alive = data["alive"].copy()
            seen = data["identifiers_seen"]
            if seen.ndim == 1:
                # pre-value-history snapshots stored slot indices
                slots = seen.astype(np.int64)
                seen = np.stack(
                    [sim.cluster.id_high[slots], sim.cluster.id_low[slots]],
                    axis=1,
                )
            sim._seen_ids = seen.copy()
            sim._seen_set = None
            sim._seen_hashes = None
            sim.seed = seed
            sim.virtual_ms = int(data["virtual_ms"])
            sim.group_of = (
                data["group_of"].copy()
                if "group_of" in data
                else np.zeros(capacity, dtype=np.int32)
            )
            sim.auto_vote = np.ones(capacity, dtype=bool)
        sim._init_runtime_state()
        return sim


def _with(t: torch.Tensor, index: int, value) -> torch.Tensor:
    """A copy of ``t`` with ``t[index] = value``, and ``t`` left as it was.
    Device ops only: a scalar is written by ``fill_``, which takes it as a
    kernel argument (``out[index] = scalar`` blocks on a host copy)."""
    out = t.clone()
    target = out.select(0, index)
    if isinstance(value, torch.Tensor):
        target.copy_(value)
    else:
        target.fill_(value)
    return out
