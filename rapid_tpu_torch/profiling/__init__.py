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

The JAX package's third piece, the cluster-wide scrape (``scrape.py``),
assembles protocol-plane status responses and comes with the port's bridge.
"""

from ..observability import MetricsHistory
from .phases import DEVICE_PHASES, PHASES, PhaseProfiler

__all__ = ["DEVICE_PHASES", "PHASES", "PhaseProfiler", "MetricsHistory"]
