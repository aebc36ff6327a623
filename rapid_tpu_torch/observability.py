"""The telemetry plane: labeled metrics, hierarchical tracing, exporters.

The port's own copy of ``rapid_tpu/observability.py`` (same catalogs, bucket
edges, classes and wire formats, so exports of either package compare
byte for byte), with its own process-global registry and tracer, plain
``threading.Lock``s, and ``device_trace`` rebuilt on ``torch.profiler``.

The reference has no tracing/metrics subsystem (SURVEY.md §5.1: jacoco +
surefire wall-times only; §5.5: four subscription events are the whole
observable surface). Since this framework's headline metric is
time-to-stable-view, observability is first-class here:

- ``Metrics``: thread-safe counters, gauges, and fixed-bucket histograms
  keyed by ``(name, labels)``. Per-``Cluster``/``Simulator`` instances get
  their own registry attached (via weakref) to the process-global one, so
  exporters see every plane merged while ``snapshot()``/``get()`` stay
  per-instance. ``NullMetrics`` is the no-op registry used to measure
  telemetry overhead.
- ``Tracer``: wall/virtual-time spans with parent ids and a contextvar-based
  current span, bounded by a ring buffer (``dropped`` counts evictions).
  Per-instance tracers attach to the process-global one the same way, so a
  single Chrome trace carries protocol, simulator, and fault-plane spans on
  one timeline.
- ``StableViewTimer``: derives per-view-change latency histograms
  (detection -> decision -> view-installed) on a caller-supplied clock --
  virtual ms on both the event-driven plane and the simulator, so the
  ``time_to_stable_view_ms`` distributions are directly comparable.
- Exporters: Chrome ``trace_event`` JSON (Perfetto-loadable; simulator spans
  additionally plotted on a virtual-time track), Prometheus text exposition
  (``rapid_*``-prefixed, labeled), and a JSON snapshot.
- ``device_trace``: context manager around ``torch.profiler`` capturing a
  host and GPU trace of the simulation hot loop as a Chrome trace file
  (load in Perfetto or chrome://tracing).

Metric names are ``snake.dot`` strings from ``METRIC_CATALOG``; label
conventions are documented in ARCHITECTURE.md's "Telemetry plane" section.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import json
import os
import re
import sys
import tempfile
import threading
import time
import weakref
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterator, List, Optional, Tuple

# --------------------------------------------------------------------------- #
# Metric name catalog
# --------------------------------------------------------------------------- #

# Every incr/observe call site must use one of these names (or a name under
# one of METRIC_PREFIXES). The JAX package's catalog, kept whole so both
# packages' exports name the same series; the port's driver and profiler
# record the "simulator", "derived latency", "profiling" and "forensics"
# groups.
METRIC_CATALOG = frozenset({
    # protocol plane (service.py)
    "alerts_enqueued",
    "proposals",
    "view_changes",
    "view_changes_refused_missing_identity",
    "fd.edge_failures",
    # failure detectors (monitoring/)
    "fd.probes",
    "fd.probe_failures",
    "fd.rtt_ms",  # per-probe round trip (the gray-node observable)
    # adaptive gray-aware FD (monitoring/adaptive.py)
    "fd.suspicion",            # per-probe tier-relative suspicion score
    "fd.adapted_interval_ms",  # probe interval chosen per edge tier
    "fd.gray_alerts",          # alerts fired by suspicion before hard-fail
    # cut detection (cut_detector.py)
    "cut.proposals_emitted",
    # consensus (fast_paxos.py / paxos.py)
    "consensus.fast_round_votes",
    "consensus.fast_decisions",
    "consensus.classic_rounds_started",
    "consensus.classic_decisions",
    # join pipeline (cluster.py)
    "join.exhausted",
    "join.phase1_no_response",
    # nemesis fault plane (faults.py)
    "nemesis_dropped",
    "nemesis_duplicated",
    "nemesis_delayed",
    "nemesis_reordered",
    "nemesis_passed",
    "nemesis_slowed",          # SlowNodeRule applied (gray node)
    "nemesis_wire_versioned",  # WireVersionRule codec round-trip applied
    "nemesis_zone_detection_ms",  # per-zone detection->decision (scenarios)
    # retry combinator (messaging/retries.py)
    "retry_attempts",
    "retry_exhausted",
    "retry_deadline_exceeded",
    "retry_backoff_ms",
    # messaging transport (messaging/reactor.py, messaging/tcp.py)
    "msg.sent",            # frames queued for transmission
    "msg.received",        # frames parsed off the wire
    "msg.bytes_sent",      # payload+header bytes actually written
    "msg.bytes_received",  # bytes read off the wire
    "msg.batch_size",      # frames coalesced per flush (histogram)
    "msg.flush_syscalls",  # sendmsg/send calls issued by channel flushes
    "msg.dial_backoffs",   # dials suppressed by the per-peer backoff gate
    "msg.batches_sent",    # MessageBatch envelopes emitted by broadcasters
    "msg.batched_messages",  # inner messages carried inside batch envelopes
    # simulator (sim/driver.py)
    "rounds",
    "device_dispatches",
    "classic_coordinator_races",
    "speculation_hits_fresh_state",
    "speculation_hits_config_id",
    # fault-array occupancy gauges (set once per flush, host mirrors only)
    "sim.fault.crashed",
    "sim.fault.ingress_partitioned",
    "sim.fault.lossy",
    "sim.membership_size",
    "sim.pending_joiners",
    # derived latency histograms (StableViewTimer, both planes)
    "latency.detection_to_decision_ms",
    "latency.decision_to_view_ms",
    "time_to_stable_view_ms",
    # placement plane (placement/, service.py, sim/driver.py)
    "placement.rebuilds",
    "placement.partitions_moved",
    "placement.imbalance",
    "placement.partitions_owned",
    # handoff plane (handoff/, service.py, sim/driver.py)
    "handoff.sessions_started",
    "handoff.sessions_completed",
    "handoff.sessions_failed",
    "handoff.chunks_sent",
    "handoff.chunks_received",
    "handoff.chunks_duplicate",
    "handoff.bytes_moved",
    "handoff.retries",
    "handoff.failovers",
    "handoff.fingerprint_mismatches",
    "handoff.session_bytes",
    "handoff.session_chunks",
    "handoff.releases",
    # serving plane (serving/, service.py, sim/driver.py)
    "serving.gets",
    "serving.puts",
    "serving.put_acks",
    "serving.put_retries",
    "serving.replication_writes",
    "serving.leader_reads",
    "serving.quorum_reads",
    "serving.not_leader_redirects",
    "serving.leader_changes",
    "serving.reconciled_replicas",
    "serving.request_ms",
    # profiling plane (profiling/, sim/driver.py, observability.py)
    "profile.phase_ms",    # per-phase device attribution (histogram)
    "profile.step_ms",     # shadow-measured full device step (histogram)
    "profile.samples",     # shadow attribution samples taken
    "profile.history_snapshots",  # metric history-ring snapshots recorded
    # durability plane (durability/)
    "durability.appends",           # WAL records appended (puts + deletes)
    "durability.fsyncs",            # physical fsync barriers issued
    "durability.snapshots",         # checkpoints written (snapshot + marker)
    "durability.segments",          # live WAL segment count (gauge)
    "durability.replayed_records",  # log records replayed by last recovery
    "durability.torn_truncations",  # torn tails truncated at a bad record
    # forensics plane (forensics/, observability.py)
    "journal.dropped_events",  # flight-recorder entries lost to overflow
    # SLO plane (slo/)
    "slo.requests",        # requests scored by the SLI tracker
    "slo.offered",         # open-loop arrivals offered to the serving path
    "slo.availability",    # windowed good/total ratio x1000 (gauge per SLO)
    "slo.burn_rate",       # short-window burn rate (gauge per SLO+window)
    "slo.firing",          # burn alerts currently firing (gauge)
    "slo.alerts_fired",    # burn-alert fire transitions
    "slo.alerts_cleared",  # burn-alert clear transitions (recovery)
    # hierarchy plane (hierarchy/, sim/driver.py)
    "hierarchy.cells",          # configured cell count (gauge)
    "hierarchy.live_cells",     # cells present in the composed global view
    "hierarchy.parent_rounds",  # parent configuration rounds advanced
})

# Dynamic name families: an f-string call site is legal iff its literal head
# starts with one of these prefixes (e.g. ``f"messages.{type_name}"``).
METRIC_PREFIXES = ("messages.",)

# The port's own spans, which the JAX package does not record: the host
# work of the simulator's join path, dispatch and view change (sim/driver.py).
PORT_SPANS = frozenset({
    "join_arm",          # arming a configuration's pending joins
    "ring_order",        # the joiners' ring re-sort, inside join_arm
    "dispatch_inputs",   # a dispatch's fault-plane inputs and their uploads
    "dispatch_enqueue",  # a dispatch's rounds and pack_decision, in device_rounds
    "decision_fetch",    # the decision words' fetch, in device_rounds
    "config_id",         # the configuration id's fold, in view_change
    "fresh_state",       # the new configuration's state, in view_change
})

# Span names: every Tracer.span/begin/event call site must use one of
# these (the same discipline as METRIC_CATALOG): the JAX package's catalog
# and the port's own.
SPAN_CATALOG = frozenset({
    "alert_batch",       # service.py: handling one BatchedAlertMessage
    "view_change",       # service.py + sim/driver.py: installing a view
    "device_rounds",     # sim/driver.py: a batch of device-dispatched rounds
    "placement_rebalance",  # placement map rebuilt after a view change
    "handoff_session",   # one partition's state transfer (handoff/engine.py)
    "serving_request",   # one client Get/Put through the serving engine
}) | PORT_SPANS

# Instant-event and flight-recorder kinds: every Tracer.event and
# FlightRecorder.record call site must use one of these.
EVENT_CATALOG = frozenset({
    # tracer instants
    "fd_signal",         # edge failure detector fired
    "alert_enqueued",    # alert queued for the next batch flush
    "proposal",          # cut detector emitted a proposal
    "cut_detected",      # H-th report crossed the watermark
    "fast_decision",     # Fast Paxos decided without a classic round
    "classic_decision",  # classic Paxos learner reached a majority
    # flight-recorder journal kinds (membership-relevant happenings)
    "alert_in",          # batched alerts received
    "alert_out",         # batched alerts flushed to the broadcaster
    "decision",          # consensus handed the service a proposal
    "view_install",      # view change applied
    "view_refused",      # view change refused (missing identity), parked
    "join_exhausted",    # a join burned all RETRIES attempts
    "kicked",            # this node was removed from the ring
    "status_served",     # answered a ClusterStatusRequest
    "placement_rebalance",  # placement map rebuilt (moved count + versions)
    "handoff_started",   # transfer sessions launched for a placement diff
    "handoff_complete",  # a session finished with a verified fingerprint
    "handoff_failed",    # a session exhausted sources/retries
    "handoff_release",   # source released a partition after a verified ack
    "serving_leader_change",  # a partition's leader moved with the view
    "serving_sync",      # churned partition re-synced from replica snapshots
    "durability_recovered",   # store reopened: snapshot loaded + log replayed
    "durability_checkpoint",  # snapshot + marker written, old segments culled
    "slo_alert_fired",   # multi-window burn-rate alert started firing
    "slo_alert_cleared",  # burn rates fell back under the clear threshold
    "bundle_captured",   # forensic evidence bundle written (trigger + path)
    "parent_round",      # hierarchy parent round advanced (composition moved)
})

# Histogram bucket upper edges (``le``, inclusive -- Prometheus convention).
DEFAULT_LATENCY_BUCKETS_MS: Tuple[float, ...] = (
    1, 2, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000, 10000,
)

# One shared definition for the headline distribution on BOTH planes: the
# acceptance criterion is that the simulator's and the protocol plane's
# time_to_stable_view_ms histograms are bucket-for-bucket comparable.
STABLE_VIEW_BUCKETS_MS: Tuple[float, ...] = (
    10, 50, 100, 250, 500, 1000, 2500, 5000, 10000, 15000, 30000, 60000,
    120000,
)

# Partitions moved per rebalance (placement.partitions_moved): powers of two
# up to the largest supported map so correlated-failure motion is directly
# readable off the histogram on both planes.
PARTITIONS_MOVED_BUCKETS: Tuple[float, ...] = (
    0, 1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192,
)

# Bytes moved per handoff session (handoff.session_bytes): powers of four
# from 1 KiB to 1 GiB, wide enough for both the in-memory reference store
# and a real partition payload.
HANDOFF_BYTES_BUCKETS: Tuple[float, ...] = (
    0, 1024, 4096, 16384, 65536, 262144, 1048576, 4194304, 16777216,
    67108864, 268435456, 1073741824,
)

# Chunks per handoff session (handoff.session_chunks): powers of two.
HANDOFF_CHUNKS_BUCKETS: Tuple[float, ...] = (
    0, 1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024,
)

# Per-request serving latency (serving.request_ms): sub-millisecond through
# view-change-window tails. Finer low end than DEFAULT_LATENCY_BUCKETS_MS
# because a leader read inside one process is typically < 1 ms, while a
# quorum write during churn can stretch to seconds.
SERVING_LATENCY_BUCKETS_MS: Tuple[float, ...] = (
    0.25, 0.5, 1, 2, 5, 10, 25, 50, 100, 250, 500, 1000, 2500, 5000,
)

# Frames coalesced per channel flush (msg.batch_size): powers of two. A
# saturated broadcast storm should push mass well past 1 -- that ratio IS
# the write-coalescing win (syscalls per message = 1 / batch size).
MSG_BATCH_BUCKETS: Tuple[float, ...] = (
    1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024,
)

# Per-phase device attribution (profile.phase_ms / profile.step_ms): a
# finer low end than DEFAULT_LATENCY_BUCKETS_MS because a single fused
# round at small N is tens of microseconds, while a 1M-node dispatch
# stretches to seconds.
PROFILE_PHASE_BUCKETS_MS: Tuple[float, ...] = (
    0.05, 0.1, 0.25, 0.5, 1, 2, 5, 10, 25, 50, 100, 250, 500, 1000, 2500,
    5000,
)


# --------------------------------------------------------------------------- #
# Histograms
# --------------------------------------------------------------------------- #


class Histogram:
    """Fixed-bucket histogram (no locking of its own; the owning Metrics
    serializes access). ``counts`` has one slot per bucket edge plus +Inf."""

    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: Tuple[float, ...]) -> None:
        self.buckets = tuple(buckets)
        self.counts = [0] * (len(self.buckets) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        i = 0
        for i, edge in enumerate(self.buckets):  # noqa: B007
            if value <= edge:
                break
        else:
            i = len(self.buckets)
        self.counts[i] += 1
        self.sum += value
        self.count += 1

    def copy(self) -> "Histogram":
        out = Histogram(self.buckets)
        out.counts = list(self.counts)
        out.sum = self.sum
        out.count = self.count
        return out

    def merge(self, other: "Histogram") -> None:
        if other.buckets != self.buckets:
            return  # mismatched definitions never merge (catalog bug)
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.sum += other.sum
        self.count += other.count

    def snapshot(self) -> Dict[str, object]:
        return {
            "buckets": list(self.buckets),
            "counts": list(self.counts),
            "sum": self.sum,
            "count": self.count,
        }


# --------------------------------------------------------------------------- #
# Metrics registry
# --------------------------------------------------------------------------- #

LabelItems = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, object]) -> LabelItems:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _render(name: str, labels: LabelItems) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


class Metrics:
    """Thread-safe labeled registry (counters, gauges, histograms).

    ``parent``: attach this registry (weakly) to another one; exporters
    walking the parent's ``collect()`` see this registry's samples with
    ``const_labels`` merged in. Per-Cluster/Simulator registries attach to
    ``global_metrics()`` by default, so one Prometheus scrape covers every
    plane while per-instance ``get``/``snapshot`` stay isolated.
    """

    def __init__(self, parent: Optional["Metrics"] = None,
                 **const_labels: object) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, LabelItems], int] = {}
        self._gauges: Dict[Tuple[str, LabelItems], float] = {}
        self._histograms: Dict[Tuple[str, LabelItems], Histogram] = {}
        self._const_labels: Dict[str, str] = {
            k: str(v) for k, v in sorted(const_labels.items())
        }
        self._children: List["weakref.ref[Metrics]"] = []
        # dead children's final samples, appended by GC finalizers and folded
        # in lazily by _drain_absorbed(). The finalizer must NOT take _lock:
        # cyclic GC can run inside this registry's own locked sections (any
        # allocation can trigger it), and a lock-taking finalizer would then
        # self-deadlock the thread. list.append is atomic and lock-free.
        self._pending_absorbs: List[tuple] = []  # guarded-by: gil-atomic-append
        if parent is not None:
            parent.attach(self)

    # -- registry tree ------------------------------------------------------

    def attach(self, child: "Metrics") -> None:
        """Attach ``child`` weakly: while alive it is merged into this
        registry's ``collect()``; when garbage-collected, its final samples
        are folded into this registry (the finalizer captures the child's
        data dicts, not the child), so a shut-down Cluster's telemetry
        survives into exports without the tree pinning dead components."""
        with self._lock:
            self._children = [r for r in self._children if r() is not None]
            self._children.append(weakref.ref(child))
        weakref.finalize(
            child, self._pending_absorbs.append,
            (child._counters, child._gauges, child._histograms,
             dict(child._const_labels)),
        )

    def detach(self, child: "Metrics") -> None:
        with self._lock:
            self._children = [
                r for r in self._children
                if r() is not None and r() is not child
            ]

    def _drain_absorbed(self) -> None:
        """Fold any dead children's queued samples into this registry.
        Called from every read/collect path (never from GC) so absorbed
        telemetry is visible by the time anyone looks."""
        while self._pending_absorbs:
            try:
                counters, gauges, hists, const = self._pending_absorbs.pop(0)
            except IndexError:  # pragma: no cover - concurrent drain
                break
            self._absorb(counters, gauges, hists, const)

    def _absorb(self, counters: Dict, gauges: Dict, hists: Dict,
                const: Dict[str, str]) -> None:
        """Fold a dead child's samples into this registry, const labels
        applied (the child's lock is irrelevant -- nothing else references
        its dicts anymore)."""
        with self._lock:
            for (name, labels), value in counters.items():
                key = (name, tuple(sorted({**const, **dict(labels)}.items())))
                self._counters[key] = self._counters.get(key, 0) + value
            for (name, labels), value in gauges.items():
                key = (name, tuple(sorted({**const, **dict(labels)}.items())))
                self._gauges[key] = value
            for (name, labels), hist in hists.items():
                key = (name, tuple(sorted({**const, **dict(labels)}.items())))
                mine = self._histograms.get(key)
                if mine is None:
                    self._histograms[key] = hist.copy()
                else:
                    mine.merge(hist)

    # -- recording ----------------------------------------------------------

    def incr(self, name: str, amount: int = 1, **labels: object) -> None:
        key = (name, _label_key(labels))
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + amount

    def set_gauge(self, name: str, value: float, **labels: object) -> None:
        with self._lock:
            self._gauges[(name, _label_key(labels))] = value

    def observe(self, name: str, value: float,
                buckets: Tuple[float, ...] = DEFAULT_LATENCY_BUCKETS_MS,
                **labels: object) -> None:
        key = (name, _label_key(labels))
        with self._lock:
            hist = self._histograms.get(key)
            if hist is None:
                hist = self._histograms[key] = Histogram(buckets)
            hist.observe(value)

    # -- reading ------------------------------------------------------------

    def get(self, name: str, **labels: object) -> int:
        """Exact ``(name, labels)`` counter; with no labels, the sum over
        every label set of ``name`` (so legacy unlabeled reads keep working
        after a call site gains labels)."""
        self._drain_absorbed()
        with self._lock:
            if labels:
                return self._counters.get((name, _label_key(labels)), 0)
            return sum(
                v for (n, _), v in self._counters.items() if n == name
            )

    def get_gauge(self, name: str, **labels: object) -> Optional[float]:
        self._drain_absorbed()
        with self._lock:
            return self._gauges.get((name, _label_key(labels)))

    def histogram(self, name: str, **labels: object) -> Optional[Dict[str, object]]:
        """Merged snapshot of ``name`` over this registry AND its attached
        children; ``labels`` filter as a subset (``plane="sim"`` matches any
        series also carrying node/other labels). None if never observed."""
        want = {k: str(v) for k, v in labels.items()}
        merged: Optional[Histogram] = None
        for kind, n, sample_labels, value in self.collect():
            if kind != "histogram" or n != name:
                continue
            if any(sample_labels.get(k) != v for k, v in want.items()):
                continue
            if merged is None:
                merged = value.copy()
            else:
                merged.merge(value)
        return merged.snapshot() if merged is not None else None

    def snapshot(self) -> Dict[str, int]:
        """Flat counter view of THIS registry (children excluded): unlabeled
        counters keep their bare names, labeled ones render as
        ``name{k=v,...}``. Existing consumers that parse dotted names (e.g.
        experiments/message_load.py over ``messages.*``) are unaffected."""
        self._drain_absorbed()
        with self._lock:
            return {
                _render(name, labels): value
                for (name, labels), value in self._counters.items()
            }

    def gauges(self) -> Dict[str, float]:
        self._drain_absorbed()
        with self._lock:
            return {
                _render(name, labels): value
                for (name, labels), value in self._gauges.items()
            }

    def histograms(self) -> Dict[str, Dict[str, object]]:
        self._drain_absorbed()
        with self._lock:
            return {
                _render(name, labels): hist.snapshot()
                for (name, labels), hist in self._histograms.items()
            }

    def reset(self) -> None:
        """Atomically clear this registry's own series (children keep
        theirs: they belong to live components). Queued dead-child samples
        are discarded too -- reset means a clean slate."""
        del self._pending_absorbs[:]
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()
            self._children = [r for r in self._children if r() is not None]

    # -- export -------------------------------------------------------------

    def collect(self) -> List[Tuple[str, str, Dict[str, str], object]]:
        """Merged samples of this registry and every live child:
        ``(kind, name, labels, value)`` with kind in counter/gauge/histogram
        and const labels folded into each sample's labels."""
        self._drain_absorbed()
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = {k: h.copy() for k, h in self._histograms.items()}
            children = [r() for r in self._children]
        const = self._const_labels
        out: List[Tuple[str, str, Dict[str, str], object]] = []
        for (name, labels), value in counters.items():
            out.append(("counter", name, {**const, **dict(labels)}, value))
        for (name, labels), value in gauges.items():
            out.append(("gauge", name, {**const, **dict(labels)}, value))
        for (name, labels), hist in hists.items():
            out.append(("histogram", name, {**const, **dict(labels)}, hist))
        for child in children:
            if child is not None:
                for kind, name, labels, value in child.collect():
                    out.append((kind, name, {**const, **labels}, value))
        return out


class NullMetrics(Metrics):
    """No-op registry: the telemetry-overhead baseline (never attaches to
    the global tree, records nothing)."""

    def __init__(self) -> None:  # noqa: super-init intentional
        super().__init__()

    def incr(self, name: str, amount: int = 1, **labels: object) -> None:
        pass

    def set_gauge(self, name: str, value: float, **labels: object) -> None:
        pass

    def observe(self, name: str, value: float,
                buckets: Tuple[float, ...] = DEFAULT_LATENCY_BUCKETS_MS,
                **labels: object) -> None:
        pass


# Process-wide default registry for components that outlive any one Cluster:
# the nemesis fault plane (faults.py) counts injected faults here unless
# given a registry ("nemesis_*" counters), the retry combinator counts
# "retry_*" when handed one, and per-instance registries attach here so
# exporters see every plane. Tests snapshot/reset it around a run.
_GLOBAL_METRICS = Metrics()


def global_metrics() -> Metrics:
    return _GLOBAL_METRICS


# --------------------------------------------------------------------------- #
# Metric history rings
# --------------------------------------------------------------------------- #

DEFAULT_HISTORY_CAPACITY = 128
DEFAULT_HISTORY_INTERVAL_S = 1.0


class MetricsHistory:
    """Bounded fixed-interval snapshot ring over a ``Metrics`` registry tree.

    Point-in-time registries answer "what is the value now"; the history
    ring answers "what was it over the last while" without an external
    scraper. ``maybe_snapshot`` is called opportunistically from whatever
    loop the owner already runs (the sim dispatch loop, a service timer, a
    test); it records at most one snapshot per ``interval_s``. Each
    snapshot captures every counter/gauge sample of ``collect()`` plus each
    histogram's (count, sum) -- enough to reconstruct rates and means per
    interval without shipping full bucket vectors.

    Retention is bounded AND downsampled: the ring holds at most
    ``capacity`` snapshots, and on overflow the oldest half is decimated
    (every other entry dropped), so recent history keeps full resolution
    while older history coarsens geometrically instead of falling off a
    cliff. A ring that snapshots forever stays within
    [3/4 * capacity, capacity] entries.

    Lock order: ``collect()`` runs OUTSIDE the ring lock, so this class
    adds no ``MetricsHistory._lock -> Metrics._lock`` edge.
    """

    def __init__(self, metrics: Optional[Metrics] = None,
                 interval_s: float = DEFAULT_HISTORY_INTERVAL_S,
                 capacity: int = DEFAULT_HISTORY_CAPACITY) -> None:
        self._metrics = metrics if metrics is not None else global_metrics()
        self.interval_s = max(float(interval_s), 0.0)
        self.capacity = max(int(capacity), 4)
        self._lock = threading.Lock()
        self._snaps: List[Dict[str, object]] = []
        self._last_ts: Optional[float] = None
        # per-instance monotonic snapshot stamp: strictly increasing within
        # one ring's lifetime, restarting at 1 when a restarted node builds
        # a fresh ring -- the reset signal profiling/scrape.py splits
        # series on (a restarted node's clock may replay earlier ts_s)
        self._seq = itertools.count(1)

    def __len__(self) -> int:
        with self._lock:
            return len(self._snaps)

    def maybe_snapshot(self, now_s: Optional[float] = None) -> bool:
        """Record a snapshot iff at least ``interval_s`` elapsed since the
        last one (first call always records). Returns whether it did."""
        now = float(now_s) if now_s is not None else time.time()
        with self._lock:
            last = self._last_ts
        if last is not None and now - last < self.interval_s:
            return False
        self.snapshot(now)
        return True

    def snapshot(self, now_s: Optional[float] = None) -> Dict[str, object]:
        """Unconditionally record one snapshot of the registry tree."""
        now = float(now_s) if now_s is not None else time.time()
        counters: Dict[str, float] = {}
        gauges: Dict[str, float] = {}
        hists: Dict[str, List[float]] = {}
        for kind, name, labels, value in self._metrics.collect():
            rendered = _render(name, tuple(sorted(labels.items())))
            if kind == "counter":
                counters[rendered] = counters.get(rendered, 0) + value
            elif kind == "gauge":
                gauges[rendered] = value
            elif kind == "histogram":
                prev = hists.get(rendered)
                if prev is None:
                    hists[rendered] = [value.count, value.sum]
                else:
                    prev[0] += value.count
                    prev[1] += value.sum
        snap: Dict[str, object] = {
            "ts_s": now,
            "seq": next(self._seq),
            "counters": counters,
            "gauges": gauges,
            "histograms": hists,
        }
        with self._lock:
            self._snaps.append(snap)
            self._last_ts = now
            if len(self._snaps) >= self.capacity:
                self._downsample_locked()
        self._metrics.incr("profile.history_snapshots")
        return snap

    def _downsample_locked(self) -> None:
        """Decimate the oldest half in place (caller holds ``_lock``)."""
        half = len(self._snaps) // 2
        self._snaps[:half] = self._snaps[:half][::2]

    # -- reading ------------------------------------------------------------

    def entries(self) -> List[Dict[str, object]]:
        with self._lock:
            return list(self._snaps)

    def series(self, name: str) -> List[Tuple[float, float]]:
        """(ts_s, value) timeseries of one rendered series name, searched
        across counters, then gauges, then histogram counts. Snapshots in
        which the series did not yet exist are skipped."""
        out: List[Tuple[float, float]] = []
        for snap in self.entries():
            for table, pick in (("counters", None), ("gauges", None),
                                ("histograms", 0)):
                value = snap[table].get(name)  # type: ignore[union-attr]
                if value is not None:
                    out.append((
                        snap["ts_s"],  # type: ignore[arg-type]
                        float(value[pick] if pick is not None else value),
                    ))
                    break
        return out

    def reset(self) -> None:
        with self._lock:
            self._snaps.clear()
            self._last_ts = None

    # -- wire ---------------------------------------------------------------

    def to_wire(self, n: Optional[int] = None) -> Tuple[str, ...]:
        """The ring's tail as sorted-key JSON lines: the form
        ``ClusterStatusResponse.history`` carries on both transports."""
        entries = self.entries()
        if n is not None:
            entries = entries[-n:]
        return tuple(
            json.dumps(snap, sort_keys=True, default=str)
            for snap in entries
        )

    @staticmethod
    def from_wire(lines: Tuple[str, ...]) -> List[Dict[str, object]]:
        """Parse ``to_wire`` output back into snapshot dicts (malformed
        lines are skipped -- a truncated scrape never breaks assembly)."""
        out: List[Dict[str, object]] = []
        for line in lines:
            try:
                snap = json.loads(line)
            except (ValueError, TypeError):
                continue
            if isinstance(snap, dict) and "ts_s" in snap:
                out.append(snap)
        return out


# --------------------------------------------------------------------------- #
# Tracing
# --------------------------------------------------------------------------- #

_SPAN_IDS = itertools.count(1)
# PORT_SPANS take their ids from a range of their own, so every span both
# packages record keeps the JAX package's numbering: a churn episode's trace
# id (its root span's id) names the episode in either package's records
_PORT_SPAN_IDS = itertools.count(1 << 48)
_SPAN_ID_LOCK = threading.Lock()

# One process-wide current-span so nesting works across tracer instances
# (e.g. a fault-plane event inside a protocol-plane span): each task/thread
# context carries its own value.
_CURRENT_SPAN: "contextvars.ContextVar[Optional[Span]]" = contextvars.ContextVar(
    "rapid_tpu_torch_current_span", default=None
)


def _next_span_id(name: str = "") -> int:
    with _SPAN_ID_LOCK:
        return next(_PORT_SPAN_IDS if name in PORT_SPANS else _SPAN_IDS)


def profiler_range(name: str):
    """A ``torch.profiler`` range named ``name`` while the profiler records,
    else a context that does nothing. The range lands on the trace's own
    clock, and on the device's timeline over the kernels launched inside it.
    Without torch loaded nothing can be recording, so this module stays
    importable without it."""
    torch = sys.modules.get("torch")
    if torch is not None and torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def _open_range(name: str):
    """``profiler_range(name)`` entered, or None while nothing records."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd._profiler_enabled():
        return None
    rng = torch.profiler.record_function(name)
    rng.__enter__()
    return rng


def _close_range(rng) -> None:
    if rng is not None:
        rng.__exit__(None, None, None)


@dataclass(frozen=True)
class TraceContext:
    """The trace coordinates of a churn episode.

    ``trace_id`` names the whole causal chain (minted by the root span: the
    first fault injection of the episode); ``parent_span_id`` is that span,
    under which the view change parents; ``origin`` is its track for
    display; ``flags`` is reserved (0 today). On the wire it is a compact
    4-list under the frame's reserved ``__tc`` key (``messaging/codec.py``).
    """

    trace_id: int
    parent_span_id: int
    origin: str = ""
    flags: int = 0

    def to_wire(self) -> List[object]:
        return [self.trace_id, self.parent_span_id, self.origin, self.flags]

    @classmethod
    def from_wire(cls, raw: object) -> Optional["TraceContext"]:
        try:
            trace_id, parent_span_id, origin, flags = raw  # type: ignore[misc]
            return cls(int(trace_id), int(parent_span_id), str(origin),
                       int(flags))
        except (TypeError, ValueError):
            return None  # malformed context never breaks message handling


# Messages are frozen dataclasses; the trace context rides as a sidecar
# attribute (object.__setattr__) so it stays invisible to dataclass fields,
# equality, hashing, and the codec's field walk.
_TRACE_CTX_ATTR = "trace_ctx"


def stamp_trace_context(msg: object, ctx: Optional[TraceContext]) -> object:
    if ctx is not None:
        try:
            object.__setattr__(msg, _TRACE_CTX_ATTR, ctx)
        except (AttributeError, TypeError):
            pass  # slotted/immutable object: carriage degrades to none
    return msg


def trace_context_of(msg: object) -> Optional[TraceContext]:
    ctx = getattr(msg, _TRACE_CTX_ATTR, None)
    return ctx if isinstance(ctx, TraceContext) else None


def current_trace_context(origin: str = "") -> Optional[TraceContext]:
    """TraceContext for the ambient span (None outside any span): what a
    send site stamps on an outgoing message unless it has an explicit
    context of its own."""
    cur = _CURRENT_SPAN.get()
    if cur is None:
        return None
    return TraceContext(
        trace_id=cur.trace_id or cur.span_id,
        parent_span_id=cur.span_id,
        origin=origin or cur.track,
    )


@dataclass
class Span:
    name: str
    wall_start_s: float
    wall_end_s: float = 0.0
    virtual_start_ms: Optional[int] = None
    virtual_end_ms: Optional[int] = None
    attrs: Dict[str, object] = field(default_factory=dict)
    span_id: int = 0
    parent_id: Optional[int] = None
    plane: str = "protocol"
    track: str = "main"
    trace_id: int = 0

    @property
    def wall_ms(self) -> float:
        return (self.wall_end_s - self.wall_start_s) * 1000.0


DEFAULT_MAX_SPANS = 8192


class Tracer:
    """Span recorder with a bounded ring buffer.

    ``spans`` is the ring (oldest evicted first; ``dropped`` counts
    evictions). ``parent`` attaches this tracer (weakly) to another one so
    ``collect_spans()`` on the parent -- and therefore the Chrome-trace
    exporter -- sees every attached plane on one timeline. ``plane``/``track``
    stamp each span for the exporter's process/thread grouping. While
    ``torch.profiler`` records, every span (``span``, ``begin``/``end``,
    ``remote_span``) also opens a ``profiler_range`` of its name around its
    wall extent, so a device trace holds the spans on its own clock."""

    def __init__(self, max_spans: int = DEFAULT_MAX_SPANS,
                 parent: Optional["Tracer"] = None,
                 plane: str = "protocol", track: str = "main") -> None:
        self.spans: List[Span] = []
        self._dropped_box = [0]  # boxed so the parent's finalizer sees it
        self.plane = plane
        self.track = track
        self._max_spans = max_spans
        self._lock = threading.Lock()
        self._children: List["weakref.ref[Tracer]"] = []
        # dead children's (spans, dropped_box), appended by GC finalizers --
        # lock-free on purpose: cyclic GC can fire inside this tracer's own
        # locked sections, so a lock-taking finalizer would self-deadlock.
        self._pending_absorbs: List[tuple] = []  # guarded-by: gil-atomic-append
        # span id -> the profiler range a ``begin`` opened, closed by ``end``
        # (kept off the Span, whose fields the exporters compare)
        self._ranges: Dict[int, object] = {}
        if parent is not None:
            parent.attach(self)

    @property
    def dropped(self) -> int:
        self._drain_absorbed()
        return self._dropped_box[0]

    # -- tracer tree --------------------------------------------------------

    def attach(self, child: "Tracer") -> None:
        """Attach ``child`` weakly; when it is garbage-collected its spans
        fold into this tracer's (bounded) ring, so a shut-down component's
        trace survives into exports."""
        with self._lock:
            self._children = [r for r in self._children if r() is not None]
            self._children.append(weakref.ref(child))
        weakref.finalize(
            child, self._pending_absorbs.append,
            (child.spans, child._dropped_box),
        )

    def _drain_absorbed(self) -> None:
        """Fold dead children's queued spans into the ring (called from the
        read paths, never from GC)."""
        while self._pending_absorbs:
            try:
                spans, dropped_box = self._pending_absorbs.pop(0)
            except IndexError:  # pragma: no cover - concurrent drain
                break
            for s in spans:
                self._append(s)
            with self._lock:
                self._dropped_box[0] += dropped_box[0]

    # -- recording ----------------------------------------------------------

    def _new_span(self, name: str, virtual_ms: Optional[int],
                  attrs: Dict[str, object]) -> Span:
        parent = _CURRENT_SPAN.get()
        span_id = _next_span_id(name)
        return Span(
            name=name,
            wall_start_s=time.perf_counter(),
            virtual_start_ms=virtual_ms,
            attrs=attrs,
            span_id=span_id,
            parent_id=parent.span_id if parent is not None else None,
            plane=self.plane,
            track=self.track,
            # roots mint the trace id (their own span id: process-unique);
            # children inherit, so one id names the whole causal chain
            trace_id=(
                (parent.trace_id or parent.span_id)
                if parent is not None
                else span_id
            ),
        )

    def _append(self, s: Span) -> None:
        with self._lock:
            if self._max_spans > 0 and len(self.spans) >= self._max_spans:
                self.spans.pop(0)
                self._dropped_box[0] += 1
            self.spans.append(s)

    @contextlib.contextmanager
    def span(self, name: str, virtual_ms: Optional[int] = None,
             **attrs: object) -> Iterator[Span]:
        rng = _open_range(name)
        s = self._new_span(name, virtual_ms, dict(attrs))
        token = _CURRENT_SPAN.set(s)
        try:
            yield s
        finally:
            _CURRENT_SPAN.reset(token)
            s.wall_end_s = time.perf_counter()
            _close_range(rng)
            self._append(s)

    def begin(self, name: str, virtual_ms: Optional[int] = None,
              **attrs: object) -> Span:
        """Non-contextmanager start (paired with ``end``), for spans whose
        close site is far from their open site (e.g. view-change application
        that returns mid-function)."""
        rng = _open_range(name)
        s = self._new_span(name, virtual_ms, dict(attrs))
        if rng is not None:
            self._ranges[s.span_id] = rng
        return s

    def end(self, s: Span, virtual_ms: Optional[int] = None) -> None:
        s.wall_end_s = time.perf_counter()
        if virtual_ms is not None:
            s.virtual_end_ms = virtual_ms
        if self._ranges:
            _close_range(self._ranges.pop(s.span_id, None))
        self._append(s)

    def event(self, name: str, virtual_ms: Optional[int] = None,
              **attrs: object) -> Span:
        """Zero-duration instant (still parented under the current span)."""
        s = self._new_span(name, virtual_ms, dict(attrs))
        s.wall_end_s = s.wall_start_s
        s.virtual_end_ms = virtual_ms
        self._append(s)
        return s

    # -- cross-node propagation ---------------------------------------------

    def inject(self) -> Optional[TraceContext]:
        """The context an outgoing message should carry: the ambient span's
        coordinates with this tracer's track as the origin (None outside
        any span -- unsolicited sends stay traceless)."""
        return current_trace_context(origin=self.track)

    @staticmethod
    def extract(msg: object) -> Optional[TraceContext]:
        """The context an incoming message carried (None if it had none or
        the peer predates trace propagation)."""
        return trace_context_of(msg)

    @contextlib.contextmanager
    def remote_span(self, name: str, ctx: Optional[TraceContext] = None,
                    virtual_ms: Optional[int] = None,
                    **attrs: object) -> Iterator[Span]:
        """Like ``span`` but parented under a *remote* span: the receiving
        half of a cross-node edge. With ``ctx=None`` this degrades to a
        plain ``span`` (untraced peers cost nothing). The remote parent id
        may not resolve locally -- ``span_tree`` re-roots such spans, so a
        duplicated or reordered message can at worst repeat an edge, never
        corrupt parenting or accumulate state."""
        if ctx is not None and ctx.origin:
            attrs.setdefault("origin", ctx.origin)
        rng = _open_range(name)
        s = self._new_span(name, virtual_ms, dict(attrs))
        if ctx is not None:
            s.parent_id = ctx.parent_span_id
            s.trace_id = ctx.trace_id or s.trace_id
        token = _CURRENT_SPAN.set(s)
        try:
            yield s
        finally:
            _CURRENT_SPAN.reset(token)
            s.wall_end_s = time.perf_counter()
            _close_range(rng)
            self._append(s)

    # -- reading ------------------------------------------------------------

    def collect_spans(self) -> List[Span]:
        """This tracer's spans plus every live child's (exporter input)."""
        self._drain_absorbed()
        with self._lock:
            out = list(self.spans)
            children = [r() for r in self._children]
        for child in children:
            if child is not None:
                out.extend(child.collect_spans())
        return out

    def span_tree(self) -> Dict[Optional[int], List[Span]]:
        """parent span id -> children, root spans under None (a span whose
        parent was evicted from the ring is re-rooted under None)."""
        self._drain_absorbed()
        with self._lock:
            spans = list(self.spans)
        known = {s.span_id for s in spans}
        tree: Dict[Optional[int], List[Span]] = {}
        for s in spans:
            parent = s.parent_id if s.parent_id in known else None
            tree.setdefault(parent, []).append(s)
        return tree

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-name aggregate: count, total/mean wall ms."""
        self._drain_absorbed()
        with self._lock:
            spans = list(self.spans)
        agg: Dict[str, Dict[str, float]] = {}
        for s in spans:
            entry = agg.setdefault(s.name, {"count": 0, "total_ms": 0.0})
            entry["count"] += 1
            entry["total_ms"] += s.wall_ms
        for entry in agg.values():
            entry["mean_ms"] = entry["total_ms"] / entry["count"]
        return agg

    def reset(self) -> None:
        del self._pending_absorbs[:]
        with self._lock:
            self.spans.clear()
            self._dropped_box[0] = 0
            self._children = [r for r in self._children if r() is not None]


_GLOBAL_TRACER = Tracer(plane="global", track="global")


def global_tracer() -> Tracer:
    return _GLOBAL_TRACER


# --------------------------------------------------------------------------- #
# Derived latency: detection -> decision -> view-installed
# --------------------------------------------------------------------------- #


class StableViewTimer:
    """Per-view-change latency decomposition on a caller-supplied clock.

    ``detection(t)`` marks the first failure/join signal since the last view
    change (first call sticks); ``decision(t)`` marks when consensus decided
    (last call wins -- a parked decision re-applies later); ``view_installed``
    closes the cycle and records three histograms labeled with ``plane``:
    detection->decision, decision->view, and the headline
    ``time_to_stable_view_ms`` -- all on STABLE_VIEW_BUCKETS_MS so the
    simulator (virtual clock) and the protocol plane (scheduler clock)
    distributions are bucket-for-bucket comparable."""

    def __init__(self, metrics: Metrics, plane: str,
                 clock: Callable[[], int]) -> None:
        self._metrics = metrics
        self._plane = plane
        self._clock = clock
        self._detect_ms: Optional[int] = None  # guarded-by: protocol-thread
        self._decide_ms: Optional[int] = None  # guarded-by: protocol-thread

    def _now(self, now_ms: Optional[int]) -> int:
        return int(now_ms if now_ms is not None else self._clock())

    def detection(self, now_ms: Optional[int] = None) -> None:
        if self._detect_ms is None:
            self._detect_ms = self._now(now_ms)

    def decision(self, now_ms: Optional[int] = None) -> None:
        if self._detect_ms is not None:
            self._decide_ms = self._now(now_ms)

    def view_installed(self, now_ms: Optional[int] = None) -> None:
        detect, decide = self._detect_ms, self._decide_ms
        self._detect_ms = None
        self._decide_ms = None
        if detect is None:
            return  # e.g. the initial view: nothing was detected
        installed = self._now(now_ms)
        if decide is None:
            decide = installed
        self._metrics.observe(
            "latency.detection_to_decision_ms", decide - detect,
            buckets=STABLE_VIEW_BUCKETS_MS, plane=self._plane,
        )
        self._metrics.observe(
            "latency.decision_to_view_ms", installed - decide,
            buckets=STABLE_VIEW_BUCKETS_MS, plane=self._plane,
        )
        self._metrics.observe(
            "time_to_stable_view_ms", installed - detect,
            buckets=STABLE_VIEW_BUCKETS_MS, plane=self._plane,
        )


# --------------------------------------------------------------------------- #
# Flight recorder
# --------------------------------------------------------------------------- #

DEFAULT_JOURNAL_CAPACITY = 256


class FlightRecorder:
    """Bounded journal of the last N membership-relevant events on one node.

    A black box for post-mortems without a live scraper: each entry carries
    a monotonic sequence number, the event kind (from ``EVENT_CATALOG``),
    wall-clock seconds, the node's virtual/scheduler milliseconds, and a
    small detail dict. The deque drops the oldest entry on overflow, so a
    recorder can run forever; ``dropped`` counts those losses (and bills
    the ``journal.dropped_events`` counter when a metrics registry is
    attached) so evidence bundles report truncation instead of hiding it.
    When the forensics plane wires an HLC clock, each entry also carries an
    ``hlc`` coordinate (``[physical_ms, logical, incarnation]``) so skewed
    nodes' journals merge into one causal timeline. ``to_wire`` serializes
    the tail as JSON lines (the form both the msgpack codec and the proto
    wire carry in ``ClusterStatusResponse.journal``); ``dump`` writes the
    same lines to a file on crash/exit -- atomically, via tmp +
    ``os.replace``, so a crash mid-dump never leaves a torn journal."""

    def __init__(self, capacity: int = DEFAULT_JOURNAL_CAPACITY,
                 node: str = "",
                 clock: Optional[Callable[[], int]] = None,
                 hlc=None, metrics: Optional["Metrics"] = None) -> None:
        self.node = node
        self._clock = clock
        # duck-typed forensics.hlc.HlcClock
        self._hlc = hlc
        self._metrics = metrics
        self._seq = itertools.count(1)
        self._lock = threading.Lock()
        # guarded-by: _lock
        self._dropped = 0
        self._events: "collections.deque[Dict[str, object]]" = (
            collections.deque(maxlen=max(1, capacity))
        )

    @property
    def capacity(self) -> int:
        return self._events.maxlen or 0

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def hlc_now(self):
        """The attached HLC clock's current stamp, or None when the
        forensics plane is off."""
        if self._hlc is None:
            return None
        try:
            return self._hlc.peek()
        except Exception:  # noqa: BLE001 -- forensics never loses the event
            return None

    def record(self, kind: str, virtual_ms: Optional[int] = None,
               **detail: object) -> Dict[str, object]:
        if virtual_ms is None and self._clock is not None:
            try:
                virtual_ms = int(self._clock())
            except Exception:  # noqa: BLE001 -- a dying clock never loses the event
                virtual_ms = None
        entry: Dict[str, object] = {
            "seq": next(self._seq),
            "kind": kind,
            "wall_s": time.time(),
            "virtual_ms": virtual_ms,
            "node": self.node,
            "detail": {str(k): v for k, v in detail.items()},
        }
        if self._hlc is not None:
            try:
                entry["hlc"] = self._hlc.now().to_wire()
            except Exception:  # noqa: BLE001 -- forensics never loses the event
                pass
        with self._lock:
            overflowing = len(self._events) == self._events.maxlen
            self._events.append(entry)
            if overflowing:
                self._dropped += 1
        if overflowing and self._metrics is not None:
            self._metrics.incr("journal.dropped_events")
        return entry

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def tail(self, n: Optional[int] = None) -> List[Dict[str, object]]:
        with self._lock:
            events = list(self._events)
        return events if n is None else events[-n:]

    def to_wire(self, n: Optional[int] = None) -> Tuple[str, ...]:
        return tuple(
            json.dumps(entry, sort_keys=True, default=str)
            for entry in self.tail(n)
        )

    def dump(self, path: str, n: Optional[int] = None) -> None:
        directory = os.path.dirname(os.path.abspath(path))
        fd, tmp = tempfile.mkstemp(prefix=".journal-", dir=directory)
        try:
            with os.fdopen(fd, "w") as fh:
                for line in self.to_wire(n):
                    fh.write(line + "\n")
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise


# --------------------------------------------------------------------------- #
# Exporters
# --------------------------------------------------------------------------- #

_PROM_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    sanitized = _PROM_NAME_RE.sub("_", name)
    return sanitized if sanitized.startswith("rapid_") else f"rapid_{sanitized}"


def _prom_label_value(value: str) -> str:
    return (
        value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _prom_labels(labels: Dict[str, str], extra: Optional[Dict[str, str]] = None) -> str:
    merged = dict(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    inner = ",".join(
        f'{k}="{_prom_label_value(v)}"' for k, v in sorted(merged.items())
    )
    return f"{{{inner}}}"


def _num(value: float) -> str:
    if isinstance(value, float) and value.is_integer():
        return str(int(value))
    return str(value)


def prometheus_text(metrics: Optional[Metrics] = None) -> str:
    """Prometheus text exposition of a registry tree (default: the process
    global, i.e. every attached Cluster/Simulator plane merged). Counters
    gain ``_total``; histograms expand to ``_bucket``/``_sum``/``_count``
    with inclusive ``le`` edges. Output is sorted for determinism."""
    registry = metrics if metrics is not None else global_metrics()
    counters: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
    gauges: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
    hists: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], Histogram] = {}
    for kind, name, labels, value in registry.collect():
        key = (name, tuple(sorted(labels.items())))
        if kind == "counter":
            counters[key] = counters.get(key, 0) + value
        elif kind == "gauge":
            gauges[key] = value
        elif kind == "histogram":
            if key in hists:
                hists[key].merge(value)
            else:
                hists[key] = value.copy()
    lines: List[str] = []
    typed: set = set()

    def type_line(name: str, kind: str) -> None:
        if name not in typed:
            typed.add(name)
            lines.append(f"# TYPE {name} {kind}")

    for (name, labels) in sorted(counters):
        prom = f"{_prom_name(name)}_total"
        type_line(prom, "counter")
        lines.append(
            f"{prom}{_prom_labels(dict(labels))} {_num(counters[(name, labels)])}"
        )
    for (name, labels) in sorted(gauges):
        prom = _prom_name(name)
        type_line(prom, "gauge")
        lines.append(
            f"{prom}{_prom_labels(dict(labels))} {_num(gauges[(name, labels)])}"
        )
    for (name, labels) in sorted(hists):
        hist = hists[(name, labels)]
        prom = _prom_name(name)
        type_line(prom, "histogram")
        cumulative = 0
        for edge, count in zip(hist.buckets, hist.counts):
            cumulative += count
            lines.append(
                f"{prom}_bucket"
                f"{_prom_labels(dict(labels), {'le': _num(float(edge))})} "
                f"{cumulative}"
            )
        cumulative += hist.counts[-1]
        lines.append(
            f"{prom}_bucket{_prom_labels(dict(labels), {'le': '+Inf'})} "
            f"{cumulative}"
        )
        lines.append(f"{prom}_sum{_prom_labels(dict(labels))} {_num(hist.sum)}")
        lines.append(f"{prom}_count{_prom_labels(dict(labels))} {hist.count}")
    return "\n".join(lines) + ("\n" if lines else "")


def chrome_trace(tracer: Optional[Tracer] = None) -> Dict[str, object]:
    """Chrome ``trace_event`` JSON (load in Perfetto / chrome://tracing).

    One process per plane; one thread per track (a protocol node's address,
    the simulator, ...). Spans carrying virtual timestamps are ADDITIONALLY
    plotted on a synthetic "virtual-time" process whose microseconds are
    virtual milliseconds x1000, so protocol time lines up across planes
    regardless of host wall-time jitter."""
    root = tracer if tracer is not None else global_tracer()
    spans = sorted(
        root.collect_spans(), key=lambda s: (s.wall_start_s, s.span_id)
    )
    planes = sorted({s.plane for s in spans})
    pid_of = {plane: i + 1 for i, plane in enumerate(planes)}
    virtual_pid = len(planes) + 1
    tracks = sorted({(s.plane, s.track) for s in spans})
    tid_of = {pt: i + 1 for i, pt in enumerate(tracks)}
    events: List[Dict[str, object]] = []
    for plane, pid in pid_of.items():
        events.append({
            "ph": "M", "pid": pid, "name": "process_name",
            "args": {"name": plane},
        })
    has_virtual = any(s.virtual_start_ms is not None for s in spans)
    if has_virtual:
        events.append({
            "ph": "M", "pid": virtual_pid, "name": "process_name",
            "args": {"name": "virtual-time (ms)"},
        })
    for (plane, track), tid in tid_of.items():
        events.append({
            "ph": "M", "pid": pid_of[plane], "tid": tid,
            "name": "thread_name", "args": {"name": track},
        })
    t0 = min((s.wall_start_s for s in spans), default=0.0)
    for s in spans:
        args: Dict[str, object] = {str(k): v for k, v in s.attrs.items()}
        args["span_id"] = s.span_id
        if s.parent_id is not None:
            args["parent_id"] = s.parent_id
        if s.trace_id:
            args["trace_id"] = s.trace_id
        ts = int(round((s.wall_start_s - t0) * 1e6))
        dur = max(int(round((s.wall_end_s - s.wall_start_s) * 1e6)), 1)
        events.append({
            "name": s.name, "ph": "X", "pid": pid_of[s.plane],
            "tid": tid_of[(s.plane, s.track)], "ts": ts, "dur": dur,
            "args": args,
        })
        if s.virtual_start_ms is not None:
            v_end = (
                s.virtual_end_ms
                if s.virtual_end_ms is not None
                else s.virtual_start_ms
            )
            events.append({
                "name": s.name, "ph": "X", "pid": virtual_pid,
                "tid": tid_of[(s.plane, s.track)],
                "ts": int(s.virtual_start_ms) * 1000,
                "dur": max((int(v_end) - int(s.virtual_start_ms)) * 1000, 1),
                "args": args,
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def json_snapshot(metrics: Optional[Metrics] = None,
                  tracer: Optional[Tracer] = None) -> Dict[str, object]:
    """Everything in one JSON-serializable dict: merged counter/gauge/
    histogram samples plus the span summary."""
    registry = metrics if metrics is not None else global_metrics()
    root = tracer if tracer is not None else global_tracer()
    counters: Dict[str, float] = {}
    gauges: Dict[str, float] = {}
    hists: Dict[str, Dict[str, object]] = {}
    for kind, name, labels, value in registry.collect():
        rendered = _render(name, tuple(sorted(labels.items())))
        if kind == "counter":
            counters[rendered] = counters.get(rendered, 0) + value
        elif kind == "gauge":
            gauges[rendered] = value
        elif kind == "histogram":
            hists[rendered] = value.snapshot()
    return {
        "counters": dict(sorted(counters.items())),
        "gauges": dict(sorted(gauges.items())),
        "histograms": dict(sorted(hists.items())),
        "spans": root.summary(),
        "spans_dropped": root.dropped,
    }


def write_prometheus(path: str, metrics: Optional[Metrics] = None) -> None:
    with open(path, "w") as fh:
        fh.write(prometheus_text(metrics))


def write_chrome_trace(path: str, tracer: Optional[Tracer] = None) -> None:
    with open(path, "w") as fh:
        json.dump(chrome_trace(tracer), fh)


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[object]:
    """Capture a ``torch.profiler`` trace of everything inside the block,
    host and (when a GPU is present) device activity, and write it as a
    Chrome trace to ``log_dir/trace.json``. Yields the profiler, whose
    ``events()`` the caller may read after the block."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
