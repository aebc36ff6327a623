"""Configuration knobs the port reads.

The port's copy of ``ProfilingSettings`` and ``SLOSettings`` and their
``profiling.*`` and ``slo.*`` bounds from ``rapid_tpu/settings.py`` (the
settings the simulator plane takes), and of
``Settings``, with the fields and methods that the messaging stack
(``messaging/tcp.py``, ``retries.py``, ``gateway.py``) and the gateway CLI
read, and the protocol timings a gateway's agents share with it, under
JAX's names, order and defaults. What no ported module reads is left out:
the FD policy knobs, the leave timeout, and the sub-settings fields of
``Settings`` (adaptive FD, profiling, durability, SLO, forensics,
hierarchy).
"""

from __future__ import annotations

from dataclasses import dataclass

# Bounds for every profiling knob, keyed "profiling.<field>": each
# ProfilingSettings field has an entry here with its legal [min, max] range.
SETTINGS_CATALOG = {
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
}


@dataclass(frozen=True)
class ProfilingSettings:
    """Knobs for the continuous profiling plane (``profiling/``). Defaults
    are conservative: profiling is off (``enabled=False`` leaves the
    dispatch loop untouched) and, when on, shadow attribution samples only
    one of every ``sample_every_dispatches`` dispatches. Bounds live in
    SETTINGS_CATALOG. The JAX package's ``overhead_budget_pct`` is left out:
    the port has no overhead check to read it yet."""

    enabled: bool = False
    sample_every_dispatches: int = 16
    history_interval_ms: int = 1000
    history_capacity: int = 128

    def __post_init__(self) -> None:
        for key, value in (
            ("enabled", int(self.enabled)),
            ("sample_every_dispatches", self.sample_every_dispatches),
            ("history_interval_ms", self.history_interval_ms),
            ("history_capacity", self.history_capacity),
        ):
            bounds = SETTINGS_CATALOG[f"profiling.{key}"]
            assert bounds["min"] <= value <= bounds["max"], (
                f"profiling.{key}={value!r} outside "
                f"[{bounds['min']}, {bounds['max']}]"
            )


@dataclass(frozen=True)
class SLOSettings:
    """Knobs for the SLO plane (``slo/``). Defaults are conservative: the
    plane is off (``enabled=False`` attaches nothing to the serving path)
    and, when on, SLIs aggregate into fixed-width time buckets whose
    windowed sums drive the multi-window burn-rate alerts. ``window_scale``
    maps the wall-scale SRE windows (5m/1h fast, 6h/3d slow) onto
    virtual-time runs; the burn arithmetic is scale-invariant. Bounds live
    in SETTINGS_CATALOG."""

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
    # with the chosen jitter discipline, spaced through the scheduler seam.
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

    # Broadcast flush window: when > 0, per-recipient sends accumulate for
    # this many ms and leave as one MessageBatch envelope per peer per
    # window. 0 preserves the send-per-message path.
    broadcast_flush_window_ms: int = 0

    def __post_init__(self) -> None:
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
        budget the immediate-resubscribe loop consumed in the worst case,
        enforced explicitly however the attempts are spaced."""
        return self.timeout_for(msg) * (self.message_retries + 1)
