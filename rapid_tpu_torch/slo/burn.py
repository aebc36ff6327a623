"""Multi-window multi-burn-rate alerting over declared SLO targets: the
port of ``rapid_tpu/slo/burn.py``.

An alert fires only when BOTH a short and a long window burn error budget
faster than the pair's threshold: a fast pair (5m/1h at 14.4x budget) and
a slow pair (6h/3d at 6x). Burn rate is ``error_rate / (1 - objective)``.
``SLOSettings.window_scale`` multiplies every declared window before use,
which maps the wall-scale windows onto virtual time. ``SLI_CATALOG`` /
``SLO_CATALOG`` / ``BURN_WINDOWS`` are the JAX package's literals.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .attrib import Episode, attribute_burn, episodes_from_journal
from .sli import SliTracker

# The good-event predicates the tracker scores per request. A latency SLO
# is expressed as availability-of-fast-requests (good = OK AND latency at
# or under the objective's threshold) so one burn arithmetic covers both.
SLI_CATALOG = {
    "availability": {
        "doc": "good requests / total requests; good = the request "
               "completed with STATUS_OK (NOT_FOUND counts as good for "
               "reads: the store answered correctly)",
    },
    "fast-availability": {
        "doc": "requests both OK and completing within the declaring "
               "SLO's latency_threshold_ms / total requests -- the "
               "latency SLO as an availability ratio",
    },
    "goodput": {
        "doc": "completed-good requests vs offered open-loop arrivals; "
               "diverges from availability under overload because "
               "never-completed arrivals count against it",
    },
}

# Window pairs, wall-scale seconds. "burn" is the fire threshold in
# multiples of budget-exhaustion rate; the canonical SRE pairings.
BURN_WINDOWS = {
    "fast": {"short_s": 300, "long_s": 3600, "burn": 14.4},
    "slow": {"short_s": 21600, "long_s": 259200, "burn": 6.0},
}

# Declared SLO targets over the serving path. Every entry must name a
# cataloged SLI and valid window pairs;
# fast-availability SLOs must declare latency_threshold_ms.
SLO_CATALOG = {
    "serving.availability": {
        "sli": "availability",
        "objective": 0.999,
        "windows": ("fast", "slow"),
        "doc": "99.9% of serving requests complete OK",
    },
    "serving.latency": {
        "sli": "fast-availability",
        "objective": 0.99,
        "latency_threshold_ms": 25.0,
        "windows": ("fast", "slow"),
        "doc": "99% of serving requests complete OK within 25 ms of their "
               "scheduled arrival (open-loop: queueing delay included)",
    },
}


@dataclass
class BurnAlert:
    """Live state of one (SLO, window-pair) alert."""

    slo: str
    window: str
    objective: float
    threshold: float          # fire threshold (burn multiple)
    short_ms: int             # scaled short-window duration
    long_ms: int              # scaled long-window duration
    firing: bool = False
    fired_at_ms: int = 0
    cleared_at_ms: int = 0
    burn_short: float = 0.0   # latest short-window burn rate
    burn_long: float = 0.0    # latest long-window burn rate
    peak_burn: float = 0.0    # max short-window burn observed
    fired_count: int = 0
    attributed: Optional[Episode] = None

    @property
    def name(self) -> str:
        return f"{self.slo}:{self.window}"


class BurnRateEngine:
    """Burn-rate evaluation for one declared SLO over a shared tracker.

    ``tick(now_ms)`` recomputes both windows of every declared pair and
    runs the fire/clear state machine:

    * FIRE when short-window burn >= threshold AND long-window burn >=
      threshold (both, per the multi-window rule);
    * CLEAR only when both burns drop below ``clear_fraction`` x the
      threshold (hysteresis: a burn hovering at the threshold cannot
      flap the alert).
    """

    def __init__(self, slo: str, spec: Dict[str, object],
                 tracker: SliTracker, *, window_scale: float = 1.0,
                 clear_fraction: float = 0.9,
                 windows: Optional[Dict[str, Dict[str, float]]] = None,
                 ) -> None:
        self.slo = slo
        self.spec = spec
        self.tracker = tracker
        self.sli = str(spec["sli"])
        self.objective = float(spec["objective"])  # type: ignore[arg-type]
        self.budget = 1.0 - self.objective
        assert self.budget > 0.0, f"objective for {slo} leaves no budget"
        self.clear_fraction = float(clear_fraction)
        window_table = windows if windows is not None else BURN_WINDOWS
        self.alerts: List[BurnAlert] = []
        for pair in spec["windows"]:  # type: ignore[union-attr]
            w = window_table[str(pair)]
            self.alerts.append(BurnAlert(
                slo=slo, window=str(pair),
                objective=self.objective, threshold=float(w["burn"]),
                short_ms=max(1, int(round(
                    float(w["short_s"]) * 1000.0 * window_scale))),
                long_ms=max(1, int(round(
                    float(w["long_s"]) * 1000.0 * window_scale))),
            ))

    def burn_rate(self, now_ms: int, duration_ms: int) -> float:
        """Error-budget consumption multiple over one trailing window."""
        window = self.tracker.window(now_ms, duration_ms)
        return window.error_rate(self.sli) / self.budget

    def tick(self, now_ms: int) -> List[Tuple[str, BurnAlert]]:
        """Re-evaluate every pair; returns ("fired"|"cleared", alert)
        transitions that happened on this tick."""
        transitions: List[Tuple[str, BurnAlert]] = []
        for alert in self.alerts:
            alert.burn_short = self.burn_rate(now_ms, alert.short_ms)
            alert.burn_long = self.burn_rate(now_ms, alert.long_ms)
            alert.peak_burn = max(alert.peak_burn, alert.burn_short)
            if not alert.firing:
                if (alert.burn_short >= alert.threshold
                        and alert.burn_long >= alert.threshold):
                    alert.firing = True
                    alert.fired_at_ms = int(now_ms)
                    alert.fired_count += 1
                    transitions.append(("fired", alert))
            else:
                clear_at = alert.threshold * self.clear_fraction
                if (alert.burn_short < clear_at
                        and alert.burn_long < clear_at):
                    alert.firing = False
                    alert.cleared_at_ms = int(now_ms)
                    transitions.append(("cleared", alert))
        return transitions


class SloPlane:
    """The online SLO plane: one shared SLI tracker fed from the serving
    path, a burn engine per declared SLO, and episode attribution against
    the flight-recorder journal.

    Composition-only: callers hand in the clock value with every call, so
    the same object serves the simulator's virtual clock and the protocol
    plane's scheduler clock. ``metrics``/``recorder`` are optional -- the
    plane works bare (bench/tests) and instruments when wired into a node.
    """

    def __init__(self, settings=None, metrics=None, recorder=None,
                 catalog: Optional[Dict[str, Dict[str, object]]] = None,
                 windows: Optional[Dict[str, Dict[str, float]]] = None,
                 ) -> None:
        if settings is None:
            from ..settings import SLOSettings

            settings = SLOSettings(enabled=True)
        self.settings = settings
        self.metrics = metrics
        self.recorder = recorder
        self.catalog = dict(catalog if catalog is not None else SLO_CATALOG)
        self._thresholds: Dict[str, float] = {}
        predicates = sorted({str(s["sli"]) for s in self.catalog.values()})
        self.tracker = SliTracker(
            bucket_ms=settings.bucket_ms,
            max_buckets=settings.max_buckets,
            predicates=tuple(predicates),
        )
        self.engines: Dict[str, BurnRateEngine] = {}
        for name, spec in sorted(self.catalog.items()):
            self.engines[name] = BurnRateEngine(
                name, spec, self.tracker,
                window_scale=settings.window_scale,
                clear_fraction=settings.clear_fraction,
                windows=windows,
            )
            if str(spec["sli"]) == "fast-availability":
                self._thresholds[name] = float(
                    spec["latency_threshold_ms"])  # type: ignore[arg-type]
        self._fast_threshold_ms = min(
            self._thresholds.values(), default=float("inf")
        )
        # single execution context per owner: the membership service feeds
        # the plane from its protocol executor (serving handlers and their
        # completion callbacks run there), bench/sim from the driving thread
        self._last_tick_bucket: Optional[int] = None  # guarded-by: protocol-executor
        # forensics-plane seam: invoked with the transition list whenever a
        # tick produces one (the burn-alert evidence-capture trigger); the
        # owner sets it, the plane never requires it
        self.on_transition: Optional[
            Callable[[List[Tuple[str, BurnAlert]]], None]
        ] = None

    # -- feeding ------------------------------------------------------------

    def record(self, now_ms: int, ok: bool, latency_ms: float) -> None:
        """Score one completed serving request."""
        good: List[str] = []
        if ok:
            good.append("availability")
            good.append("goodput")
            if latency_ms <= self._fast_threshold_ms:
                good.append("fast-availability")
        self.tracker.record(now_ms, latency_ms, good)
        if self.metrics is not None:
            self.metrics.incr("slo.requests")
        self.tick(now_ms)

    def record_offered(self, now_ms: int, n: int = 1) -> None:
        """Count open-loop arrivals offered to the serving path."""
        self.tracker.record_offered(now_ms, n)
        if self.metrics is not None:
            self.metrics.incr("slo.offered", n)

    # -- alerting -----------------------------------------------------------

    def tick(self, now_ms: int, force: bool = False) -> List[Tuple[str, BurnAlert]]:
        """Run every burn engine (at most once per SLI bucket unless
        ``force``), emit metrics + journal events on transitions."""
        bucket = int(now_ms) // self.tracker.bucket_ms
        if not force and bucket == self._last_tick_bucket:
            return []
        self._last_tick_bucket = bucket
        transitions: List[Tuple[str, BurnAlert]] = []
        for name, engine in self.engines.items():
            transitions.extend(engine.tick(now_ms))
            if self.metrics is not None:
                window = self.tracker.window(
                    now_ms, engine.alerts[0].long_ms
                )
                self.metrics.set_gauge(
                    "slo.availability",
                    round(window.availability(engine.sli) * 1000.0),
                    slo=name,
                )
                for alert in engine.alerts:
                    self.metrics.set_gauge(
                        "slo.burn_rate", alert.burn_short,
                        slo=name, window=alert.window,
                    )
        for kind, alert in transitions:
            if self.metrics is not None:
                self.metrics.incr(
                    "slo.alerts_fired" if kind == "fired"
                    else "slo.alerts_cleared"
                )
            if self.recorder is not None:
                self.recorder.record(
                    "slo_alert_fired" if kind == "fired"
                    else "slo_alert_cleared",
                    virtual_ms=int(now_ms),
                    slo=alert.slo, window=alert.window,
                    burn_milli=int(round(alert.burn_short * 1000)),
                )
        if self.metrics is not None and (transitions or force):
            self.metrics.set_gauge("slo.firing", self.firing_count())
        if transitions and self.on_transition is not None:
            try:
                self.on_transition(transitions)
            except Exception:  # noqa: BLE001 -- an evidence capture must
                # never sink the serving/status path that ticked the plane
                pass
        return transitions

    def alerts(self) -> List[BurnAlert]:
        out: List[BurnAlert] = []
        for name in sorted(self.engines):
            out.extend(self.engines[name].alerts)
        return out

    def firing_count(self) -> int:
        return sum(1 for a in self.alerts() if a.firing)

    # -- attribution --------------------------------------------------------

    def attribute(self, journal: Sequence[Dict[str, object]]) -> None:
        """Correlate every alert that has ever fired with the membership
        episode overlapping its burn window (attrib.py); idempotent, so
        status calls can re-run it as the journal grows."""
        episodes = episodes_from_journal(journal)
        if not episodes:
            return
        for alert in self.alerts():
            if alert.fired_count == 0:
                continue
            end = alert.cleared_at_ms if not alert.firing else None
            alert.attributed = attribute_burn(
                episodes,
                alert.fired_at_ms - alert.short_ms,
                end if end is not None else alert.fired_at_ms + alert.short_ms,
            ) or alert.attributed

    # -- export -------------------------------------------------------------

    def status_digest(self) -> Tuple[Tuple[str, ...], Tuple[int, ...],
                                     Tuple[int, ...], Tuple[int, ...]]:
        """Parallel arrays for ClusterStatusResponse: alert names
        ("slo:window"), short-window burn in thousandths, firing flags,
        and the attributed episode's trace id (0 = unattributed)."""
        alerts = self.alerts()
        return (
            tuple(a.name for a in alerts),
            tuple(int(round(a.burn_short * 1000)) for a in alerts),
            tuple(int(a.firing) for a in alerts),
            tuple(
                int(a.attributed.trace_id) if a.attributed is not None else 0
                for a in alerts
            ),
        )

    def summary(self, now_ms: int) -> Dict[str, object]:
        """JSON-ready SLI/alert summary (the bench artifact rides this)."""
        out: Dict[str, object] = {}
        for name, engine in sorted(self.engines.items()):
            long_ms = max(a.long_ms for a in engine.alerts)
            window = self.tracker.window(now_ms, long_ms)
            out[name] = {
                "objective": engine.objective,
                "availability": window.availability(engine.sli),
                "p99_ms": window.quantile(0.99),
                "goodput_ratio": window.goodput_ratio(engine.sli),
                "peak_burn": max(a.peak_burn for a in engine.alerts),
                "alerts": {
                    a.window: {
                        "firing": a.firing,
                        "fired_count": a.fired_count,
                        "burn_short": a.burn_short,
                        "burn_long": a.burn_long,
                    }
                    for a in engine.alerts
                },
            }
        return out
