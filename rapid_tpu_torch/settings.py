"""Configuration knobs.

The port's own copy of ``rapid_tpu/settings.py``: every sub-settings class
(adaptive FD, profiling, durability, SLO, forensics, hierarchy) with its
``SETTINGS_CATALOG`` bounds, and ``Settings`` with JAX's fields in JAX's
order and with JAX's defaults, so ``dataclasses.asdict`` of either package's
``Settings`` is the same dict (Settings.java:21-112: one mutable object that
every consumer takes whole).
"""

from __future__ import annotations

from dataclasses import dataclass, field

# Bounds for every knob of the sub-settings, keyed "<plane>.<field>": every
# field of each sub-settings class has an entry here with its legal
# [min, max] range, and no stale keys remain.
SETTINGS_CATALOG = {
    "adaptive_fd.enabled": {
        "min": 0, "max": 1,
        "doc": "kill switch: False preserves exact static-FD behavior",
    },
    "adaptive_fd.warmup_probes": {
        "min": 1, "max": 64,
        "doc": "RTT samples seeding the variance estimate before any "
               "suspicion can accrue (cold-start bias guard)",
    },
    "adaptive_fd.gray_confirm": {
        "min": 1, "max": 255,
        "doc": "consecutive outlier/missed probes before a gray alert",
    },
    "adaptive_fd.outlier_z": {
        "min": 1.0, "max": 16.0,
        "doc": "robust z-score vs the tier peer group marking one probe "
               "as an RTT outlier",
    },
    "adaptive_fd.min_spread_ms": {
        "min": 0.0, "max": 1000.0,
        "doc": "floor on the tier RTT spread so quiet LAN tiers cannot "
               "flag microsecond jitter as outliers",
    },
    "adaptive_fd.interval_floor_ms": {
        "min": 10, "max": 60000,
        "doc": "fastest adapted probe interval (suspect edges)",
    },
    "adaptive_fd.interval_ceiling_ms": {
        "min": 10, "max": 60000,
        "doc": "slowest adapted probe interval (healthy WAN edges)",
    },
    "adaptive_fd.threshold_floor": {
        "min": 1, "max": 255,
        "doc": "lowest adapted hard-failure threshold",
    },
    "adaptive_fd.threshold_ceiling": {
        "min": 1, "max": 255,
        "doc": "highest adapted hard-failure threshold",
    },
    "adaptive_fd.flush_floor_ms": {
        "min": 0, "max": 60000,
        "doc": "shortest adapted alert-batching flush window",
    },
    "adaptive_fd.flush_ceiling_ms": {
        "min": 0, "max": 60000,
        "doc": "longest adapted alert-batching flush window",
    },
    "profiling.enabled": {
        "min": 0, "max": 1,
        "doc": "kill switch: False runs the raw dispatch loop with zero "
               "profiling work on any path",
    },
    "profiling.sample_every_dispatches": {
        "min": 1, "max": 1000000,
        "doc": "shadow-profile one of every N device dispatches (1 = every "
               "dispatch; large N keeps steady-state overhead negligible)",
    },
    "profiling.history_interval_ms": {
        "min": 1, "max": 3600000,
        "doc": "minimum spacing between metric history-ring snapshots",
    },
    "profiling.history_capacity": {
        "min": 4, "max": 65536,
        "doc": "history-ring size before the oldest half is downsampled",
    },
    "profiling.overhead_budget_pct": {
        "min": 0.0, "max": 100.0,
        "doc": "overhead guard: instrumented warmed decision loop must stay "
               "within this percentage of the raw one",
    },
    "durability.enabled": {
        "min": 0, "max": 1,
        "doc": "kill switch: False keeps the in-memory store and the exact "
               "pre-durability decision loop",
    },
    "durability.fsync_policy": {
        "min": 0, "max": 2,
        "doc": "0 = never fsync (page cache only), 1 = fsync on explicit "
               "sync/checkpoint barriers, 2 = fsync every append",
    },
    "durability.segment_bytes": {
        "min": 4096, "max": 1073741824,
        "doc": "WAL segment rotation threshold; retention deletes whole "
               "segments below the last snapshot marker",
    },
    "durability.snapshot_every_records": {
        "min": 0, "max": 1048576,
        "doc": "auto-checkpoint after this many log records since the last "
               "snapshot (0 disables auto-checkpointing)",
    },
    "slo.enabled": {
        "min": 0, "max": 1,
        "doc": "kill switch: False attaches no SLO plane and reproduces the "
               "exact pre-SLO serving path",
    },
    "slo.bucket_ms": {
        "min": 1, "max": 3600000,
        "doc": "SLI aggregation time-bucket width; burn windows are sums of "
               "whole buckets, so this bounds alert-edge resolution",
    },
    "slo.window_scale": {
        "min": 0.000001, "max": 1000.0,
        "doc": "multiplier on the declared burn windows (1.0 = wall-scale "
               "SRE windows; small values shrink 5m/1h/6h/3d onto short "
               "virtual-time runs without changing the burn arithmetic)",
    },
    "slo.max_buckets": {
        "min": 16, "max": 1048576,
        "doc": "SLI ring capacity in time buckets; the oldest buckets are "
               "evicted beyond this, bounding memory for any run length",
    },
    "slo.clear_fraction": {
        "min": 0.1, "max": 1.0,
        "doc": "alert hysteresis: a firing burn alert clears only when both "
               "window burn rates drop below clear_fraction x the fire "
               "threshold (1.0 disables the hysteresis band)",
    },
    "forensics.enabled": {
        "min": 0, "max": 1,
        "doc": "kill switch: False attaches no HLC sidecar, no bundle "
               "triggers, no exit hooks, and reproduces the exact "
               "pre-forensics wire bytes",
    },
    "forensics.journal_capacity": {
        "min": 1, "max": 1048576,
        "doc": "FlightRecorder ring capacity in events; overflow drops the "
               "oldest entry and counts journal.dropped_events so bundles "
               "report truncation instead of hiding it",
    },
    "forensics.bundle_journal_tail": {
        "min": 1, "max": 65536,
        "doc": "journal entries captured per member in an evidence bundle",
    },
    "forensics.bundle_history_tail": {
        "min": 0, "max": 65536,
        "doc": "metric-history ring snapshots captured per member in an "
               "evidence bundle (0 skips the history carriage)",
    },
    "forensics.bundle_member_timeout_ms": {
        "min": 1, "max": 600000,
        "doc": "per-member status-RPC deadline during cluster-wide bundle "
               "capture; a member that misses it is marked unreachable and "
               "the capture proceeds without blocking",
    },
    "hierarchy.enabled": {
        "min": 0, "max": 1,
        "doc": "kill switch: False runs the flat single-level protocol and "
               "reproduces the exact pre-hierarchy wire bytes",
    },
    "hierarchy.cells": {
        "min": 0, "max": 65536,
        "doc": "number of cells for the rendezvous-hash fallback assignment "
               "(0 derives the cell count from the attached topology's "
               "zones, or 1 when there is no topology)",
    },
    "hierarchy.leaders_per_cell": {
        "min": 1, "max": 7,
        "doc": "size of each cell's deterministic leader set participating "
               "in the parent configuration (failover promotes the next "
               "member in leader order on an ordinary intra-cell view "
               "change)",
    },
    "hierarchy.parent_flush_ms": {
        "min": 0, "max": 60000,
        "doc": "flush window coalescing a leader's parent-level traffic "
               "into one MessageBatch per peer per window (0 sends each "
               "cell digest as its own frame)",
    },
    "hierarchy.parent_round_ms": {
        "min": 0, "max": 600000,
        "doc": "parent heartbeat period: every period each leader advances "
               "its parent round, re-announces its cell's digest to peer "
               "leaders, and ages out cells idle for eviction_rounds "
               "rounds -- this is what evicts a whole lost cell in O(1) "
               "rounds even when the survivors see no churn (0 disables "
               "the heartbeat; rounds then only advance on view changes)",
    },
    "hierarchy.eviction_rounds": {
        "min": 1, "max": 100,
        "doc": "parent rounds a foreign cell's row may stay idle before a "
               "leader drops it from the composed view (whole-cell loss "
               "detection horizon = eviction_rounds * parent_round_ms)",
    },
}


@dataclass(frozen=True)
class AdaptiveFdSettings:
    """Knobs for the adaptive gray-aware failure detector
    (monitoring/adaptive.py). Defaults are conservative: adaptation is off
    (``enabled=False`` reproduces the static PingPong detector bit-for-bit)
    and every controller output is clamped to the floors/ceilings below.
    Bounds live in SETTINGS_CATALOG."""

    enabled: bool = False
    warmup_probes: int = 4
    gray_confirm: int = 3
    outlier_z: float = 4.0
    min_spread_ms: float = 5.0
    interval_floor_ms: int = 250
    interval_ceiling_ms: int = 4000
    threshold_floor: int = 3
    threshold_ceiling: int = 30
    flush_floor_ms: int = 10
    flush_ceiling_ms: int = 500

    def __post_init__(self) -> None:
        for key, value in (
            ("enabled", int(self.enabled)),
            ("warmup_probes", self.warmup_probes),
            ("gray_confirm", self.gray_confirm),
            ("outlier_z", self.outlier_z),
            ("min_spread_ms", self.min_spread_ms),
            ("interval_floor_ms", self.interval_floor_ms),
            ("interval_ceiling_ms", self.interval_ceiling_ms),
            ("threshold_floor", self.threshold_floor),
            ("threshold_ceiling", self.threshold_ceiling),
            ("flush_floor_ms", self.flush_floor_ms),
            ("flush_ceiling_ms", self.flush_ceiling_ms),
        ):
            bounds = SETTINGS_CATALOG[f"adaptive_fd.{key}"]
            assert bounds["min"] <= value <= bounds["max"], (
                f"adaptive_fd.{key}={value!r} outside "
                f"[{bounds['min']}, {bounds['max']}]"
            )
        assert self.interval_floor_ms <= self.interval_ceiling_ms
        assert self.threshold_floor <= self.threshold_ceiling
        assert self.flush_floor_ms <= self.flush_ceiling_ms


@dataclass(frozen=True)
class ProfilingSettings:
    """Knobs for the continuous profiling plane (profiling/). Defaults are
    conservative: profiling is off (``enabled=False`` leaves the dispatch
    loop untouched) and, when on, shadow attribution samples only one of
    every ``sample_every_dispatches`` dispatches so the steady-state loop
    stays within ``overhead_budget_pct`` of the raw one. Bounds live in
    SETTINGS_CATALOG."""

    enabled: bool = False
    sample_every_dispatches: int = 16
    history_interval_ms: int = 1000
    history_capacity: int = 128
    overhead_budget_pct: float = 10.0

    def __post_init__(self) -> None:
        for key, value in (
            ("enabled", int(self.enabled)),
            ("sample_every_dispatches", self.sample_every_dispatches),
            ("history_interval_ms", self.history_interval_ms),
            ("history_capacity", self.history_capacity),
            ("overhead_budget_pct", self.overhead_budget_pct),
        ):
            bounds = SETTINGS_CATALOG[f"profiling.{key}"]
            assert bounds["min"] <= value <= bounds["max"], (
                f"profiling.{key}={value!r} outside "
                f"[{bounds['min']}, {bounds['max']}]"
            )


@dataclass(frozen=True)
class DurabilitySettings:
    """Knobs for the durability plane (durability/). Defaults are
    conservative: durability is off (``enabled=False`` keeps the in-memory
    store and the exact pre-durability decision loop) and, when on, fsync
    batching amortizes the stable-storage write path the way real Paxos
    deployments do. Bounds live in SETTINGS_CATALOG; the fsync policy is int-coded (0=never, 1=batch,
    2=always) so the catalog can bound it."""

    enabled: bool = False
    fsync_policy: int = 1
    segment_bytes: int = 1048576
    snapshot_every_records: int = 4096

    def __post_init__(self) -> None:
        for key, value in (
            ("enabled", int(self.enabled)),
            ("fsync_policy", self.fsync_policy),
            ("segment_bytes", self.segment_bytes),
            ("snapshot_every_records", self.snapshot_every_records),
        ):
            bounds = SETTINGS_CATALOG[f"durability.{key}"]
            assert bounds["min"] <= value <= bounds["max"], (
                f"durability.{key}={value!r} outside "
                f"[{bounds['min']}, {bounds['max']}]"
            )


@dataclass(frozen=True)
class SLOSettings:
    """Knobs for the SLO plane (slo/). Defaults are conservative: the plane
    is off (``enabled=False`` attaches nothing to the serving path) and,
    when on, SLIs aggregate into fixed-width time buckets whose windowed
    sums drive the multi-window burn-rate alerts. ``window_scale`` maps the
    wall-scale SRE windows (5m/1h fast, 6h/3d slow) onto virtual-time runs;
    the burn arithmetic is scale-invariant so alerts fire at the same
    error-budget consumption either way. Bounds live in SETTINGS_CATALOG
   ."""

    enabled: bool = False
    bucket_ms: int = 1000
    window_scale: float = 1.0
    max_buckets: int = 4096
    clear_fraction: float = 0.9

    def __post_init__(self) -> None:
        for key, value in (
            ("enabled", int(self.enabled)),
            ("bucket_ms", self.bucket_ms),
            ("window_scale", self.window_scale),
            ("max_buckets", self.max_buckets),
            ("clear_fraction", self.clear_fraction),
        ):
            bounds = SETTINGS_CATALOG[f"slo.{key}"]
            assert bounds["min"] <= value <= bounds["max"], (
                f"slo.{key}={value!r} outside "
                f"[{bounds['min']}, {bounds['max']}]"
            )


@dataclass(frozen=True)
class ForensicsSettings:
    """Knobs for the forensics plane (forensics/). Defaults are
    conservative: the plane is off (``enabled=False`` attaches no HLC
    sidecar and reproduces the exact pre-forensics wire bytes) and, when
    on, outbound messages carry hybrid-logical-clock stamps, journal
    entries gain HLC coordinates, and evidence bundles capture bounded
    tails from every reachable member. Bounds live in SETTINGS_CATALOG
   ."""

    enabled: bool = False
    journal_capacity: int = 256
    bundle_journal_tail: int = 128
    bundle_history_tail: int = 32
    bundle_member_timeout_ms: int = 2000

    def __post_init__(self) -> None:
        for key, value in (
            ("enabled", int(self.enabled)),
            ("journal_capacity", self.journal_capacity),
            ("bundle_journal_tail", self.bundle_journal_tail),
            ("bundle_history_tail", self.bundle_history_tail),
            ("bundle_member_timeout_ms", self.bundle_member_timeout_ms),
        ):
            bounds = SETTINGS_CATALOG[f"forensics.{key}"]
            assert bounds["min"] <= value <= bounds["max"], (
                f"forensics.{key}={value!r} outside "
                f"[{bounds['min']}, {bounds['max']}]"
            )


@dataclass(frozen=True)
class HierarchySettings:
    """Knobs for the hierarchy plane (hierarchy/). Defaults are
    conservative: the plane is off (``enabled=False`` runs the flat
    single-level protocol and reproduces the exact pre-hierarchy wire
    bytes) and, when on, the membership splits into deterministic cells
    that each run Rapid internally while the cells' leader sets agree on
    the composed global view, so cross-cell churn costs O(cells) instead
    of O(members). Bounds live in SETTINGS_CATALOG."""

    enabled: bool = False
    cells: int = 0
    leaders_per_cell: int = 1
    parent_flush_ms: int = 50
    parent_round_ms: int = 1000
    eviction_rounds: int = 3

    def __post_init__(self) -> None:
        for key, value in (
            ("enabled", int(self.enabled)),
            ("cells", self.cells),
            ("leaders_per_cell", self.leaders_per_cell),
            ("parent_flush_ms", self.parent_flush_ms),
            ("parent_round_ms", self.parent_round_ms),
            ("eviction_rounds", self.eviction_rounds),
        ):
            bounds = SETTINGS_CATALOG[f"hierarchy.{key}"]
            assert bounds["min"] <= value <= bounds["max"], (
                f"hierarchy.{key}={value!r} outside "
                f"[{bounds['min']}, {bounds['max']}]"
            )


@dataclass
class Settings:
    # Transport timeouts/retries (GrpcClient.java:55-59)
    message_timeout_ms: int = 1000
    join_message_timeout_ms: int = 5000
    probe_message_timeout_ms: int = 1000
    message_retries: int = 5

    # Retry backoff between attempts (messaging/retries.py). The reference
    # resubscribes immediately (Retries.java:44-91), which the 0 default
    # preserves; a nonzero base delay turns on capped exponential backoff
    # with the chosen jitter discipline, spaced through the scheduler seam
    # so virtual-time runs stay deterministic.
    retry_base_delay_ms: int = 0
    retry_max_delay_ms: int = 4000
    retry_jitter: str = "decorrelated"

    # Dial backoff at the transport's connect seam (messaging/tcp.py).
    # A peer whose dial failed is gated behind a decorrelated-jitter delay
    # (base..max, the retries.py discipline) so a crashed peer costs one
    # pending dial per window instead of a connect-syscall storm; the gate
    # epoch resets every dial_deadline_ms so a long-dead peer still gets
    # rate-limited fresh dials (it may have rebooted).
    dial_backoff_base_ms: int = 50
    dial_backoff_max_ms: int = 1000
    dial_deadline_ms: int = 30000

    # Protocol engine (MembershipService.java:75-77)
    failure_detector_interval_ms: int = 1000
    batching_window_ms: int = 100

    # Broadcast flush window (messaging/unicast.py, messaging/gossip.py):
    # when > 0, per-recipient sends accumulate for this many ms and leave as
    # one MessageBatch envelope per peer per window -- a churn wave's alerts
    # ride one frame per peer. 0 preserves the legacy send-per-message path
    # (and exact virtual-time timing) on both broadcasters.
    broadcast_flush_window_ms: int = 0

    # Failure-detector policy, mirrored from the sim plane's SimConfig
    # (fd_policy/fd_window/fd_window_threshold) so both planes expose the
    # same knobs: "cumulative" = the reference's never-reset counter
    # (PingPongFailureDetector.java:69-77, FAILURE_THRESHOLD=10);
    # "windowed" = the paper's policy (atc-2018 section 6): faulty when
    # >= fd_window_threshold of the last fd_window probes failed.
    fd_policy: str = "cumulative"
    fd_failure_threshold: int = 10
    fd_window: int = 10
    fd_window_threshold: float = 0.4

    # Adaptive gray-aware failure detection (monitoring/adaptive.py):
    # per-tier RTT-outlier scoring with adapted probe intervals, failure
    # thresholds, and alert-flush windows. Off by default; the enabled
    # flag is the kill switch back to the static reference behavior.
    adaptive_fd: AdaptiveFdSettings = field(default_factory=AdaptiveFdSettings)

    # Continuous profiling plane (profiling/): per-phase device attribution
    # sampling, metric history rings, and the telemetry scrape surface. Off
    # by default; the enabled flag is the kill switch back to the raw,
    # uninstrumented dispatch loop.
    profiling: ProfilingSettings = field(default_factory=ProfilingSettings)

    # Durability plane (durability/): per-node write-ahead log + snapshot
    # crash recovery mounted under the handoff PartitionStore seam. Off by
    # default; the enabled flag is the kill switch back to the in-memory
    # store and the untouched decision loop.
    durability: DurabilitySettings = field(default_factory=DurabilitySettings)

    # SLO plane (slo/): online SLIs over the serving path, multi-window
    # burn-rate alerts over declared objectives, and churn-episode
    # attribution. Off by default; the enabled flag is the kill switch
    # back to the exact pre-SLO serving path.
    slo: SLOSettings = field(default_factory=SLOSettings)

    # Forensics plane (forensics/): hybrid logical clocks on the wire,
    # HLC-stamped journals, and automatic incident evidence bundles. Off
    # by default; the enabled flag is the kill switch back to the exact
    # pre-forensics wire bytes and journal shape.
    forensics: ForensicsSettings = field(default_factory=ForensicsSettings)

    # Hierarchy plane (hierarchy/): two-level cell-based membership --
    # cells run Rapid internally, cell leader sets agree on the composed
    # global view. Off by default; the enabled flag is the kill switch
    # back to the flat single-level protocol and the exact pre-hierarchy
    # wire bytes.
    hierarchy: HierarchySettings = field(default_factory=HierarchySettings)

    def __post_init__(self) -> None:
        assert self.fd_policy in ("cumulative", "windowed"), (
            f"fd_policy must be 'cumulative' or 'windowed', got "
            f"{self.fd_policy!r}"
        )
        assert self.retry_jitter in ("decorrelated", "none"), (
            f"retry_jitter must be 'decorrelated' or 'none', got "
            f"{self.retry_jitter!r}"
        )
        assert 0 <= self.retry_base_delay_ms <= self.retry_max_delay_ms
        assert 0 <= self.dial_backoff_base_ms <= self.dial_backoff_max_ms
        assert self.dial_deadline_ms >= 0
        assert self.broadcast_flush_window_ms >= 0

    # Consensus fallback (FastPaxos.java:46)
    consensus_fallback_base_delay_ms: int = 1000

    # Graceful leave wait (MembershipService.java:78)
    leave_message_timeout_ms: int = 1500

    def timeout_for(self, msg) -> int:
        """Per-message-type deadline (GrpcClient.getTimeoutForMessageMs,
        GrpcClient.java:194-203)."""
        from .types import JoinMessage, PreJoinMessage, ProbeMessage

        if isinstance(msg, (JoinMessage, PreJoinMessage)):
            return self.join_message_timeout_ms
        if isinstance(msg, ProbeMessage):
            return self.probe_message_timeout_ms
        return self.message_timeout_ms

    def retry_policy(self):
        """The backoff schedule these settings describe (RetryPolicy)."""
        from .messaging.retries import RetryPolicy

        return RetryPolicy(
            base_delay_ms=self.retry_base_delay_ms,
            max_delay_ms=self.retry_max_delay_ms,
            jitter=self.retry_jitter,
        )

    def deadline_for(self, msg) -> int:
        """Overall per-message-type send deadline across every retry: the
        budget the legacy immediate-resubscribe loop consumed in the worst
        case, now enforced explicitly however the attempts are spaced."""
        return self.timeout_for(msg) * (self.message_retries + 1)
