"""The continuous profiling plane of the port.

- ``PhaseProfiler`` (phases.py): sampled shadow attribution of the
  simulator's device round pipeline -- wall time split into FD-scan /
  cut-detector / consensus-count / host-transfer phases via phase prefixes
  of ``sim.engine.step``, differenced so the phases sum to the full step by
  construction. Off by default (``settings.ProfilingSettings.enabled`` is
  the kill switch); when on, only one of every N dispatches is sampled.
- ``MetricsHistory`` (re-exported from observability.py): bounded,
  downsample-on-overflow snapshot rings giving every counter, gauge and
  histogram a queryable recent history.
- ``cluster_timeseries`` (scrape.py): assembles the per-node history lines
  scraped off ``ClusterStatusResponse.history`` into a cluster-wide
  timeseries view (the form tools/statusz.py and tools/perfscope.py render).
"""

from ..observability import MetricsHistory
from .phases import DEVICE_PHASES, PHASES, PhaseProfiler
from .scrape import cluster_timeseries, merge_by_series, node_segments

__all__ = [
    "DEVICE_PHASES",
    "PHASES",
    "PhaseProfiler",
    "MetricsHistory",
    "cluster_timeseries",
    "merge_by_series",
    "node_segments",
]
