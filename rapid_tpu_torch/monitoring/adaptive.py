"""Adaptive gray-aware failure detection.

The port's own copy of ``rapid_tpu/monitoring/adaptive.py``.

Closes the telemetry loop: the static PingPong detector already
measures per-edge RTT EWMAs (the observable that separates a gray node from a
dead one), but only acts once probes hard-fail ``failure_threshold`` times.
This layer scores each monitored edge by RTT *outlierness relative to its
topology tier* and converts sustained outliers into alerts before the hard
path fires, while per-tier controllers adapt probe intervals, failure
thresholds, and the alert-batching flush window.

Scoring (phi-accrual-flavored, over the existing EWMA + jitter variance):

* Every answered probe yields a robust z-score
  ``z = (rtt - median_tier) / max(spread_tier, min_spread_ms)`` against the
  smoothed RTTs of the observer's other edges in the same tier (median /
  median-absolute-deviation, so one gray peer cannot poison the baseline).
  With fewer than two warmed-up tier peers the edge falls back to its own
  history: ``z = (rtt - srtt) / max(4 * rtt_var, min_spread_ms)``.
* ``z > outlier_z`` sustains an *outlier streak*; a missed probe sustains a
  *miss streak* (a gray node past the probe timeout answers nothing, so
  misses against an established healthy history are the strongest signal);
  any answered probe resets the miss streak.
* ``suspicion = max(miss_streak, outlier_streak) / gray_confirm`` once
  ``warmup_probes`` samples exist, else 0.0 -- a fresh edge (or a node that
  was dead on arrival) can never be gray-suspected; it takes the static
  hard-failure path unchanged.

Safety:

* A suspicion >= 1 alert rides the *existing* DOWN-alert path; the
  cut detector's H/L aggregation is untouched, so almost-everywhere
  agreement still gates eviction -- one paranoid observer cannot cut a
  healthy node.
* Clock skew cannot masquerade as outlierness: all of an observer's edges
  are measured with the same injectable probe clock, so a skewed rate
  scales numerator and tier spread together and an offset cancels in the
  subtraction (tests/test_adaptive_fd.py pins both directions).

Controllers (all outputs clamped to the AdaptiveFdSettings floors/ceilings):

* probe interval: RTT-proportional, ``max(floor, 8 * median_tier_rtt)`` --
  LAN tiers probe faster than the static default, WAN tiers slower (fewer
  false positives); any suspect edge drags its tier to the floor.
* failure threshold: detection-time-budget-constant,
  ``default_threshold * default_interval / adapted_interval`` -- faster
  probing does not lower the hard path's tolerated outage time.
* alert flush window: drops to the floor while a gray alert is pending so
  the cut detector hears about a gray node promptly, else the static
  window clamped to [floor, ceiling].
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

from ..messaging.base import IMessagingClient
from ..observability import Metrics
from ..settings import Settings
from ..types import Endpoint
from .base import IEdgeFailureDetectorFactory
from .pingpong import EdgeRegistryMixin, PingPongFailureDetector

# Edge-tier labels, widest separating boundary between observer and subject
# (matches sim/topology.py LatencyTopology semantics). "default" is used
# when no tier resolver is configured: every edge shares one peer group.
TIER_RACK = "rack"
TIER_ZONE = "zone"
TIER_REGION = "region"
TIER_WAN = "wan"
TIER_DEFAULT = "default"


def topology_tier_resolver(
    topology, self_index: int, index_of: Callable[[Endpoint], Optional[int]]
) -> Callable[[Endpoint], str]:
    """Tier resolver for a sim/topology.py LatencyTopology: maps a subject
    endpoint to the widest tier separating it from the observer at
    ``self_index``. ``index_of`` maps endpoints to topology indices (None ->
    TIER_DEFAULT, e.g. a peer outside the modeled topology)."""

    def tier_of(subject: Endpoint) -> str:
        j = index_of(subject)
        if j is None:
            return TIER_DEFAULT
        if topology.region_of(self_index) != topology.region_of(j):
            return TIER_WAN
        if topology.zone_of(self_index) != topology.zone_of(j):
            return TIER_REGION
        if topology.rack_of(self_index) != topology.rack_of(j):
            return TIER_ZONE
        return TIER_RACK

    return tier_of


def _median(values) -> float:
    ordered = sorted(values)
    n = len(ordered)
    mid = n // 2
    if n % 2:
        return float(ordered[mid])
    return (ordered[mid - 1] + ordered[mid]) / 2.0


class AdaptivePingPongFailureDetector(PingPongFailureDetector):
    """PingPong detector with tier-relative gray suspicion on top of the
    unchanged cumulative hard-failure path."""

    def __init__(
        self,
        address: Endpoint,
        subject: Endpoint,
        client: IMessagingClient,
        notifier: Callable[[], None],
        factory: "AdaptivePingPongFactory",
        failure_threshold: int,
        metrics: Optional[Metrics] = None,
        clock: Optional[Callable[[], int]] = None,
    ) -> None:
        super().__init__(
            address, subject, client, notifier,
            failure_threshold=failure_threshold, metrics=metrics, clock=clock,
        )
        self._factory = factory
        self._adaptive = factory.settings.adaptive_fd
        self._miss_streak = 0
        self._outlier_streak = 0

    # -- scoring ----------------------------------------------------------

    def _warmed_up(self) -> bool:
        return self._sample_count >= self._adaptive.warmup_probes

    def _record_sample(self, rtt: float) -> None:
        self._miss_streak = 0
        if not self._warmed_up():
            self._metrics.observe("fd.suspicion", 0.0)
            return
        z = self._z_score(rtt)
        if z is not None and z > self._adaptive.outlier_z:
            self._outlier_streak += 1
        else:
            self._outlier_streak = 0
        self._metrics.observe("fd.suspicion", self.suspicion())

    def _record_failure(self) -> None:
        super()._record_failure()
        if self._warmed_up():
            self._miss_streak += 1
            self._metrics.observe("fd.suspicion", self.suspicion())

    def _z_score(self, rtt: float) -> Optional[float]:
        floor = self._adaptive.min_spread_ms
        stats = self._factory.tier_stats(self._subject)
        if stats is not None:
            median, spread = stats
            return (rtt - median) / max(spread, floor)
        srtt, var = self._rtt_ms, self._rtt_var_ms
        if srtt is None or var is None:
            return None
        return (rtt - srtt) / max(4.0 * var, floor)

    def suspicion(self) -> float:
        if not self._warmed_up():
            return 0.0
        streak = max(self._miss_streak, self._outlier_streak)
        return streak / self._adaptive.gray_confirm

    # -- alerting ---------------------------------------------------------

    def has_failed(self) -> bool:
        return super().has_failed() or self.suspicion() >= 1.0

    def __call__(self) -> None:
        if (
            not self._notified
            and not super().has_failed()
            and self.suspicion() >= 1.0
        ):
            # gray path fired first: the alert the base tick is about to
            # send exists only because of suspicion, not the hard counter
            self._metrics.incr("fd.gray_alerts")
        super().__call__()


class _TierController:
    """Derived per-tier parameters; pure function of the tier's current
    peer statistics and the static defaults (recomputed on demand)."""

    __slots__ = ("tier", "interval_ms", "threshold", "flush_ms")

    def __init__(self, tier: str, interval_ms: int, threshold: int,
                 flush_ms: int) -> None:
        self.tier = tier
        self.interval_ms = interval_ms
        self.threshold = threshold
        self.flush_ms = flush_ms


class AdaptivePingPongFactory(EdgeRegistryMixin, IEdgeFailureDetectorFactory):
    """Creates AdaptivePingPongFailureDetectors and serves the adapted
    per-tier parameters the service consults (probe interval per subject,
    alert flush window, statusz digests). RTT history carries across
    configuration changes for still-monitored subjects so warmup does not
    restart on every view change."""

    def __init__(
        self,
        address: Endpoint,
        client: IMessagingClient,
        settings: Settings,
        metrics: Optional[Metrics] = None,
        clock: Optional[Callable[[], int]] = None,
        tier_of: Optional[Callable[[Endpoint], str]] = None,
    ) -> None:
        self._address = address
        self._client = client
        self.settings = settings
        self._metrics = metrics
        self._clock = clock
        self._tier_of = tier_of if tier_of is not None else (
            lambda _subject: TIER_DEFAULT
        )
        self._edges: Dict[Endpoint, AdaptivePingPongFailureDetector] = {}

    # -- detector creation ------------------------------------------------

    def create_instance(
        self, subject: Endpoint, notifier: Callable[[], None]
    ) -> Callable[[], None]:
        detector = AdaptivePingPongFailureDetector(
            self._address, subject, self._client, notifier,
            factory=self,
            failure_threshold=self.adapted_threshold(subject),
            metrics=self._metrics, clock=self._clock,
        )
        previous = self._edges.get(subject)
        if previous is not None:
            # carry the RTT history (not the failure/streak state) so a
            # subject monitored across view changes keeps its warmup
            detector._rtt_ms = previous._rtt_ms
            detector._rtt_var_ms = previous._rtt_var_ms
            detector._seed_window = list(previous._seed_window)
            detector._sample_count = previous._sample_count
        self._register_edge(subject, detector)
        return detector

    # -- tier statistics --------------------------------------------------

    def tier_of(self, subject: Endpoint) -> str:
        return self._tier_of(subject)

    def tier_stats(self, subject: Endpoint) -> Optional[Tuple[float, float]]:
        """(median, spread) of the smoothed RTTs of the observer's *other*
        warmed-up edges in ``subject``'s tier; None below two peers."""
        tier = self._tier_of(subject)
        srtts = [
            det.rtt_ms()
            for peer, det in self._edges.items()
            if peer != subject
            and self._tier_of(peer) == tier
            and det.rtt_ms() is not None
            and det.sample_count() >= self.settings.adaptive_fd.warmup_probes
        ]
        if len(srtts) < 2:
            return None
        median = _median(srtts)
        spread = _median([abs(x - median) for x in srtts])
        return median, spread

    def _tier_median(self, tier: str) -> Optional[float]:
        srtts = [
            det.rtt_ms()
            for peer, det in self._edges.items()
            if self._tier_of(peer) == tier
            and det.rtt_ms() is not None
            and det.sample_count() >= self.settings.adaptive_fd.warmup_probes
        ]
        return _median(srtts) if len(srtts) >= 2 else None

    def _tier_suspect(self, tier: str) -> bool:
        return any(
            det.suspicion() > 0.0
            for peer, det in self._edges.items()
            if self._tier_of(peer) == tier
        )

    # -- controllers ------------------------------------------------------

    def interval_ms_for(self, subject: Endpoint,
                        default_ms: Optional[int] = None) -> int:
        """Adapted probe interval for ``subject``: RTT-proportional per
        tier, floored while the tier holds a suspect edge."""
        st = self.settings.adaptive_fd
        if default_ms is None:
            default_ms = self.settings.failure_detector_interval_ms
        tier = self._tier_of(subject)
        if self._tier_suspect(tier):
            out = st.interval_floor_ms
        else:
            median = self._tier_median(tier)
            out = default_ms if median is None else int(
                max(st.interval_floor_ms, 8.0 * median)
            )
        out = max(st.interval_floor_ms, min(st.interval_ceiling_ms, out))
        if self._metrics is not None:
            self._metrics.observe("fd.adapted_interval_ms", out)
        return out

    def adapted_threshold(self, subject: Endpoint) -> int:
        """Hard-failure threshold keeping the detection time budget
        (threshold x interval) at the static product, clamped."""
        st = self.settings.adaptive_fd
        default_threshold = self.settings.fd_failure_threshold
        default_interval = self.settings.failure_detector_interval_ms
        interval = self._interval_no_metrics(subject, default_interval)
        budget = default_threshold * default_interval
        threshold = int(round(budget / max(interval, 1)))
        return max(st.threshold_floor, min(st.threshold_ceiling, threshold))

    def _interval_no_metrics(self, subject: Endpoint, default_ms: int) -> int:
        st = self.settings.adaptive_fd
        tier = self._tier_of(subject)
        if self._tier_suspect(tier):
            out = st.interval_floor_ms
        else:
            median = self._tier_median(tier)
            out = default_ms if median is None else int(
                max(st.interval_floor_ms, 8.0 * median)
            )
        return max(st.interval_floor_ms, min(st.interval_ceiling_ms, out))

    def flush_window_ms(self, default_ms: Optional[int] = None) -> int:
        """Adapted alert-batching flush window: the floor while any edge
        holds a ripe gray suspicion (deliver the alert promptly), else the
        static window clamped to the adaptive band."""
        st = self.settings.adaptive_fd
        if default_ms is None:
            default_ms = self.settings.batching_window_ms
        if any(det.suspicion() >= 1.0 for det in self._edges.values()):
            return st.flush_floor_ms
        return max(st.flush_floor_ms, min(st.flush_ceiling_ms, default_ms))

    # -- observability ----------------------------------------------------

    def edge_digest(self):
        rows = [
            (str(subject), det.rtt_ms(), det.suspicion())
            for subject, det in self._edges.items()
        ]
        rows.sort(key=lambda r: (-r[2], -(r[1] or 0.0), r[0]))
        return tuple(rows)

    def tier_params(self) -> Tuple[Tuple[str, int, int, int], ...]:
        """((tier, interval_ms, threshold, flush_ms), ...) for every tier
        with a monitored edge, sorted by tier name."""
        by_tier: Dict[str, Endpoint] = {}
        for subject in self._edges:
            by_tier.setdefault(self._tier_of(subject), subject)
        flush = self.flush_window_ms()
        return tuple(
            (
                tier,
                self._interval_no_metrics(
                    subject, self.settings.failure_detector_interval_ms
                ),
                self.adapted_threshold(subject),
                flush,
            )
            for tier, subject in sorted(by_tier.items())
        )
