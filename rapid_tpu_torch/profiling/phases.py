"""Per-phase device attribution for the simulator's round pipeline.

The port of ``rapid_tpu/profiling/phases.py``. The dispatch loop is
untouched: attribution is a *shadow* measurement. Every sampled dispatch,
the profiler re-executes the current round's computation through three
prefixes of ``sim.engine.step`` (outputs discarded) and differences their
wall times:

    fd_scan         = t(step_fd_scan)
    cut_detector    = t(step_cut_detector) - t(step_fd_scan)
    consensus_count = t(step)              - t(step_cut_detector)

so the three device phases sum to the measured full-step time by
construction. Each time is host wall time up to ``jitwatch.drain`` (a device
synchronize on the card), as in JAX. On a CUDA state every prefix runs the
FD phase in the kernel ``fd_phase_fused``, as ``step`` does. The fourth
phase, ``host_transfer``, is not shadowed: the driver times the real
decision fetch (``jitwatch.fetch("sim.decision_words", ...)``) and reports
it here.

The shadow must not perturb the run. The prefixes leave the state as it
came, and where JAX's prefixes are pure because the PRNG key lives in the
state, the port's random-loss draw comes from the simulator's
``torch.Generator``: every prefix call draws from a copy of it, so a run
with profiling on draws exactly what it draws with profiling off.

Overhead discipline: ``warm()`` runs every prefix once (building and
loading the kernels outside any timed window), and sampling is 1-of-N
dispatches (``ProfilingSettings.sample_every_dispatches``).
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from ..observability import PROFILE_PHASE_BUCKETS_MS, Metrics, MetricsHistory
from ..runtime import jitwatch
from ..settings import ProfilingSettings
from ..sim.engine import step, step_cut_detector, step_fd_scan

DEVICE_PHASES = ("fd_scan", "cut_detector", "consensus_count")
PHASES = DEVICE_PHASES + ("host_transfer",)

# the shadow entry points, in phase order
_PROFILE_FNS = (step_fd_scan, step_cut_detector, step)


def _copy(generator: Optional[torch.Generator]) -> Optional[torch.Generator]:
    """A generator in ``generator``'s state, so a prefix's draw leaves the
    simulator's own generator where it was."""
    if generator is None:
        return None
    out = torch.Generator(device=generator.device)
    out.set_state(generator.get_state())
    return out


class PhaseProfiler:  # guarded-by: dispatch-thread
    """Sampled per-phase attribution plus the owning plane's history ring.

    One instance per Simulator (``sim/driver.py`` ``enable_profiling``),
    driven entirely from the dispatch loop's thread. Phase times land in the
    ``profile.phase_ms`` histogram (labels: phase, plane) and accumulate in
    ``attribution()``; ``history`` is the plane's MetricsHistory ring,
    ticked once per dispatch."""

    def __init__(self, metrics: Metrics,
                 settings: Optional[ProfilingSettings] = None,
                 plane: str = "sim") -> None:
        self.settings = (
            settings if settings is not None else ProfilingSettings(enabled=True)
        )
        self.metrics = metrics
        self.plane = plane
        self.samples = 0
        self.last_sample: Optional[Dict[str, float]] = None
        self._dispatches = 0
        self._totals: Dict[str, float] = {phase: 0.0 for phase in PHASES}
        self.history = MetricsHistory(
            metrics,
            interval_s=self.settings.history_interval_ms / 1000.0,
            capacity=self.settings.history_capacity,
        )

    @property
    def enabled(self) -> bool:
        return bool(self.settings.enabled)

    def should_sample(self) -> bool:
        """Advance the dispatch counter; True on 1 of every N dispatches."""
        if not self.enabled:
            return False
        self._dispatches += 1
        return (
            (self._dispatches - 1) % self.settings.sample_every_dispatches == 0
        )

    # -- measurement --------------------------------------------------------

    def _timed_ms(self, fn, config, state, inputs, random_loss: bool,
                  generator: Optional[torch.Generator]) -> float:
        generator = _copy(generator)
        t0 = time.perf_counter()
        out = fn(config, state, inputs, random_loss, generator)
        jitwatch.drain("sim.profile.sample", out)
        return (time.perf_counter() - t0) * 1000.0

    def warm(self, config, state, inputs, random_loss: bool = False,
             generator: Optional[torch.Generator] = None) -> None:
        """Run every shadow prefix once for this (config, shapes,
        random_loss) class, outside any timed window, so the kernels are
        built and loaded before a sample is timed."""
        for fn in _PROFILE_FNS:
            jitwatch.drain("sim.profile.warm",
                           fn(config, state, inputs, random_loss, _copy(generator)))

    def sample(self, config, state, inputs, random_loss: bool = False,
               generator: Optional[torch.Generator] = None,
               repeats: int = 1) -> Dict[str, float]:
        """One shadow attribution of the current round's computation.
        ``repeats`` takes the best-of-N per prefix (timing noise guard for
        assertions; the in-loop default is one shot)."""
        t_fd, t_cut, t_full = (
            min(self._timed_ms(fn, config, state, inputs, random_loss, generator)
                for _ in range(max(1, int(repeats))))
            for fn in _PROFILE_FNS
        )
        phases = {
            "fd_scan": t_fd,
            "cut_detector": max(t_cut - t_fd, 0.0),
            "consensus_count": max(t_full - t_cut, 0.0),
        }
        for phase, ms in phases.items():
            self.metrics.observe(
                "profile.phase_ms", ms, buckets=PROFILE_PHASE_BUCKETS_MS,
                phase=phase, plane=self.plane,
            )
            self._totals[phase] += ms
        self.metrics.observe(
            "profile.step_ms", t_full, buckets=PROFILE_PHASE_BUCKETS_MS,
            plane=self.plane,
        )
        self.metrics.incr("profile.samples")
        self.samples += 1
        self.last_sample = dict(phases, step_ms=t_full)
        return self.last_sample

    def record_host_transfer(self, ms: float) -> None:
        """The real decision-fetch leg, timed by the driver per dispatch."""
        self.metrics.observe(
            "profile.phase_ms", ms, buckets=PROFILE_PHASE_BUCKETS_MS,
            phase="host_transfer", plane=self.plane,
        )
        self._totals["host_transfer"] += ms

    def tick_history(self, now_s: Optional[float] = None) -> bool:
        return self.history.maybe_snapshot(now_s)

    # -- reading ------------------------------------------------------------

    def attribution(self) -> Dict[str, float]:
        """Accumulated per-phase wall ms across every sample so far."""
        return dict(self._totals)
