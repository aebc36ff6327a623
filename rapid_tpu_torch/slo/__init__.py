"""SLO plane: online SLIs, multi-window burn-rate alerts, and
churn-episode attribution for the serving path -- the port of
``rapid_tpu/slo``.

* sli.py -- windowed availability with explicit good-event predicates,
  latency percentiles from mergeable fixed-bucket histograms,
  goodput-vs-offered-load, and the open-loop arrival-rate load generator.
* burn.py -- declared SLO targets evaluated by multi-window
  multi-burn-rate alerting, composed into SloPlane behind the
  ``slo.enabled`` kill switch.
* attrib.py -- episode attribution against the flight-recorder journal.
"""

from .attrib import Episode, attribute_burn, describe, episodes_from_journal
from .burn import (
    BURN_WINDOWS,
    SLI_CATALOG,
    SLO_CATALOG,
    BurnAlert,
    BurnRateEngine,
    SloPlane,
)
from .sli import (
    Arrival,
    OpenLoopGenerator,
    SliTracker,
    WindowStats,
    histogram_quantile,
)

__all__ = [
    "BURN_WINDOWS",
    "SLI_CATALOG",
    "SLO_CATALOG",
    "Arrival",
    "BurnAlert",
    "BurnRateEngine",
    "Episode",
    "OpenLoopGenerator",
    "SliTracker",
    "SloPlane",
    "WindowStats",
    "attribute_burn",
    "describe",
    "episodes_from_journal",
    "histogram_quantile",
]
