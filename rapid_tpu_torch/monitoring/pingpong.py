"""Default ping-pong edge failure detector.

The port's own copy of ``rapid_tpu/monitoring/pingpong.py``.

Reference: PingPongFailureDetector.java. Per tick: if the *cumulative* failed
probe count has reached FAILURE_THRESHOLD=10, notify once; otherwise send a
best-effort probe. A success does NOT reset the counter (the reference's
handleProbeOnSuccess only logs, :116-118) -- preserved for parity; see
WindowedPingPongFailureDetector for the paper's "40% of last 10" policy.
A subject answering BOOTSTRAPPING is tolerated BOOTSTRAP_COUNT_THRESHOLD=30
times before counting as failure (:44,100-106).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Deque, Optional

from ..messaging.base import IMessagingClient
from ..observability import Metrics, global_metrics
from ..runtime.futures import Promise
from ..types import Endpoint, NodeStatus, ProbeMessage, ProbeResponse
from .base import IEdgeFailureDetectorFactory

FAILURE_THRESHOLD = 10
BOOTSTRAP_COUNT_THRESHOLD = 30

# EWMA smoothing for the per-edge RTT estimate (TCP SRTT's classic alpha)
_RTT_ALPHA = 0.125
# EWMA smoothing for the RTT deviation estimate (TCP RTTVAR's classic beta)
_RTT_BETA = 0.25
# The deviation estimate is seeded from the spread of the first
# RTT_SEED_SAMPLES samples rather than TCP's single-sample R/2 point
# estimate: one slow first probe on a fresh WAN edge would otherwise pin an
# inflated variance (or, worse, a tiny one that flags normal jitter as
# outlier) for many EWMA half-lives. Until the seed window fills,
# rtt_var_ms() is None and suspicion scoring stays inactive.
RTT_SEED_SAMPLES = 4


def _wall_ms() -> int:
    return int(time.monotonic() * 1000)


class PingPongFailureDetector:
    def __init__(
        self,
        address: Endpoint,
        subject: Endpoint,
        client: IMessagingClient,
        notifier: Callable[[], None],
        failure_threshold: int = FAILURE_THRESHOLD,
        metrics: Optional[Metrics] = None,
        clock: Optional[Callable[[], int]] = None,
    ) -> None:
        self._address = address
        self._subject = subject
        self._client = client
        self._notifier = notifier
        self._failure_threshold = failure_threshold
        self._metrics = metrics if metrics is not None else global_metrics()
        # ``clock``: ms source for RTT measurement -- the node's scheduler
        # clock when available (virtual-time determinism; also the seam a
        # ClockSkewRule drifts), else the wall clock
        self._clock = clock if clock is not None else _wall_ms
        self._failure_count = 0
        self._bootstrap_response_count = 0
        self._notified = False
        self._probe = ProbeMessage(sender=address)
        self._rtt_ms: Optional[float] = None  # per-edge EWMA estimate
        self._rtt_var_ms: Optional[float] = None  # EWMA |deviation| estimate
        self._seed_window: list = []  # first RTT_SEED_SAMPLES raw samples
        self._sample_count = 0

    def has_failed(self) -> bool:
        return self._failure_count >= self._failure_threshold

    def rtt_ms(self) -> Optional[float]:
        """Smoothed probe round-trip estimate for this edge (None until the
        first answered probe). The observable that separates a gray node
        from a dead one: a SlowNodeRule victim inside the timeout shows an
        inflated estimate here long before any eviction."""
        return self._rtt_ms

    def rtt_var_ms(self) -> Optional[float]:
        """Smoothed mean-absolute-deviation of the probe RTT, None until
        RTT_SEED_SAMPLES answered probes seeded it (cold-start guard)."""
        return self._rtt_var_ms

    def sample_count(self) -> int:
        """Answered probes observed on this edge (RTT samples)."""
        return self._sample_count

    def suspicion(self) -> float:
        """Gray-failure suspicion score in [0, inf): 0 means healthy, >= 1
        means the edge warrants an alert. The static detector never
        suspects (alerts only via the hard failure_threshold); the adaptive
        subclass overrides this with the tier-relative outlier score."""
        return 0.0

    def __call__(self) -> None:
        if self.has_failed() and not self._notified:
            self._notified = True
            self._notifier()
        else:
            self._metrics.incr("fd.probes")
            sent_ms = self._clock()
            self._client.send_message_best_effort(
                self._subject, self._probe
            ).add_callback(lambda p: self._on_probe_result(p, sent_ms))

    def _on_probe_result(self, promise: Promise, sent_ms: int) -> None:
        if promise.exception() is None and isinstance(
            promise.peek(), ProbeResponse
        ):
            rtt = max(0, self._clock() - sent_ms)
            self._metrics.observe("fd.rtt_ms", rtt)
            srtt_before = self._rtt_ms
            self._rtt_ms = (
                float(rtt) if self._rtt_ms is None
                else (1 - _RTT_ALPHA) * self._rtt_ms + _RTT_ALPHA * rtt
            )
            self._update_variance(float(rtt), srtt_before)
            self._sample_count += 1
            self._record_sample(float(rtt))
        self._on_probe_done(promise)

    def _update_variance(self, rtt: float, srtt_before: Optional[float]) -> None:
        if self._rtt_var_ms is None:
            self._seed_window.append(rtt)
            if len(self._seed_window) >= RTT_SEED_SAMPLES:
                mean = sum(self._seed_window) / len(self._seed_window)
                self._rtt_var_ms = sum(
                    abs(x - mean) for x in self._seed_window
                ) / len(self._seed_window)
                self._seed_window = []
            return
        deviation = abs(rtt - (srtt_before if srtt_before is not None else rtt))
        self._rtt_var_ms = (
            (1 - _RTT_BETA) * self._rtt_var_ms + _RTT_BETA * deviation
        )

    def _record_sample(self, rtt: float) -> None:
        """Per-answered-probe hook for subclasses (adaptive scoring)."""

    def _record_failure(self) -> None:
        self._failure_count += 1
        self._metrics.incr("fd.probe_failures")

    def _on_probe_done(self, promise: Promise) -> None:
        if promise.exception() is not None:
            self._record_failure()
            return
        response = promise.peek()
        if not isinstance(response, ProbeResponse):
            self._record_failure()
            return
        if response.status == NodeStatus.BOOTSTRAPPING:
            self._bootstrap_response_count += 1
            if self._bootstrap_response_count > BOOTSTRAP_COUNT_THRESHOLD:
                self._record_failure()


class EdgeRegistryMixin:
    """Tracks the live detector per monitored subject so the service can
    expose per-edge RTT EWMAs and suspicion scores through cluster_status
    (and statusz can render a worst-edges digest)."""

    _edges: dict

    def _register_edge(self, subject: Endpoint, detector) -> None:
        if not hasattr(self, "_edges"):
            self._edges = {}
        self._edges[subject] = detector

    def begin_configuration(self, subjects) -> None:
        """Drop edges no longer monitored (called by the service before it
        recreates detectors for a new configuration)."""
        keep = set(subjects)
        edges = getattr(self, "_edges", {})
        for gone in [s for s in edges if s not in keep]:
            del edges[gone]

    def edge_digest(self):
        """((subject_str, rtt_ms|None, suspicion), ...) sorted worst-first:
        by suspicion desc, then smoothed RTT desc, then subject."""
        edges = getattr(self, "_edges", {})
        rows = [
            (str(subject), det.rtt_ms(), det.suspicion())
            for subject, det in edges.items()
        ]
        rows.sort(key=lambda r: (-r[2], -(r[1] or 0.0), r[0]))
        return tuple(rows)


class PingPongFailureDetectorFactory(EdgeRegistryMixin,
                                     IEdgeFailureDetectorFactory):
    def __init__(self, address: Endpoint, client: IMessagingClient,
                 failure_threshold: int = FAILURE_THRESHOLD,
                 metrics: Optional[Metrics] = None,
                 clock: Optional[Callable[[], int]] = None) -> None:
        self._address = address
        self._client = client
        self._failure_threshold = failure_threshold
        self._metrics = metrics
        self._clock = clock
        self._edges = {}

    def create_instance(
        self, subject: Endpoint, notifier: Callable[[], None]
    ) -> Callable[[], None]:
        detector = PingPongFailureDetector(
            self._address, subject, self._client, notifier,
            self._failure_threshold, metrics=self._metrics,
            clock=self._clock,
        )
        self._register_edge(subject, detector)
        return detector


class WindowedPingPongFailureDetector(PingPongFailureDetector):
    """The paper's policy (atc-2018 §6): mark the edge faulty when >= 40% of
    the last ``window`` probes failed. Offered as an option; the reference
    code's cumulative counter remains the parity default."""

    def __init__(self, address, subject, client, notifier,
                 window: int = 10, threshold: float = 0.4,
                 metrics: Optional[Metrics] = None,
                 clock: Optional[Callable[[], int]] = None) -> None:
        super().__init__(address, subject, client, notifier, metrics=metrics,
                         clock=clock)
        self._window: Deque[bool] = deque(maxlen=window)
        self._threshold = threshold

    def has_failed(self) -> bool:
        window = self._window
        if len(window) < window.maxlen:  # type: ignore[arg-type]
            return False
        return sum(window) >= self._threshold * window.maxlen  # type: ignore[operator]

    def _on_probe_done(self, promise: Promise) -> None:
        # only genuine failures enter the window: BOOTSTRAPPING replies within
        # the 30-reply tolerance are not failures (they increment
        # failure_count only past the tolerance, matching the cumulative
        # policy), else the windowed policy would flap on joining subjects
        before = self._failure_count
        super()._on_probe_done(promise)
        self._window.append(self._failure_count > before)


class WindowedPingPongFailureDetectorFactory(EdgeRegistryMixin,
                                             IEdgeFailureDetectorFactory):
    def __init__(self, address: Endpoint, client: IMessagingClient,
                 window: int = 10, threshold: float = 0.4,
                 metrics: Optional[Metrics] = None,
                 clock: Optional[Callable[[], int]] = None) -> None:
        self._address = address
        self._client = client
        self._window = window
        self._threshold = threshold
        self._metrics = metrics
        self._clock = clock
        self._edges = {}

    def create_instance(self, subject, notifier):
        detector = WindowedPingPongFailureDetector(
            self._address, subject, self._client, notifier,
            self._window, self._threshold, metrics=self._metrics,
            clock=self._clock,
        )
        self._register_edge(subject, detector)
        return detector
