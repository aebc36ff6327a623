"""Per-phase device attribution for the simulator's round pipeline.

The port of ``rapid_tpu/profiling/phases.py``. The dispatch loop is
untouched: attribution is a *shadow* measurement. Every sampled dispatch,
the profiler re-executes the current round's computation through three
prefixes of ``sim.engine.step`` (outputs discarded) and differences their
times:

    fd_scan         = t(step_fd_scan)
    cut_detector    = t(step_cut_detector) - t(step_fd_scan)
    consensus_count = t(step)              - t(step_cut_detector)

so the three device phases sum to the measured full-step time by
construction. The fourth phase, ``host_transfer``, is not shadowed: the
driver times the real decision fetch (``jitwatch.fetch("sim.decision_words",
...)``) and reports it here.

What a prefix's time is depends on the device. JAX times one compiled XLA
executable a prefix, nearly all of it device work. On the card the port's
prefix is hundreds of eager ops whose host enqueue outweighs their device
time, so a host wall would mostly time the enqueue. There each prefix is
captured once per (config, shapes, ``random_loss``) class as a CUDA graph
over static input buffers, in a private memory pool, between two CUDA
events recorded inside the graph (external event nodes); a sample copies
the current state and inputs into those buffers, replays each graph and
reads its events: device time from the graph's first node to its last,
with no host enqueue inside it (events recorded around the replay on the
host's side would count the host's delay in launching it). A
captured kernel (``fd_phase_fused``, which also splits the key) counts in
``kernels.LAUNCHES`` once a replay. A
prefix that cannot be captured raises. On the CPU a prefix's time is the
host wall up to ``jitwatch.drain``, JAX's own source.

A sample takes its three times in turns (``step_fd_scan``, then
``step_cut_detector``, then ``step``) and keeps the turn with the least
full step, never minima taken apart: each prefix runs a strict superset of
the ops of the one before it, so a turn's times rise, and where each
prefix's time is the same in every turn the result is what separate minima
give. On the card a turn whose times do not rise was disturbed by
something outside the round's work (a replay now and then takes a few
tenths of a millisecond more, about one turn in a thousand): it is taken
again, up to ``TURN_ATTEMPTS`` times in all, so that no phase of a real
round is clamped to 0. ``turns`` counts the turns taken, so a caller knows
the replays (three a turn) and the drains exactly. On the CPU a turn is
taken once, as JAX takes its prefixes, and the clamp guards as in JAX.

The three prefixes are separate programs, each timed whole, because that
is what JAX times and what the CPU twins hold the port to prefix by
prefix; events recorded at the phase boundaries inside one captured
``step`` would need hooks in the engine's round and would time something
JAX does not.

The shadow must not perturb the run. As in JAX, the PRNG key lives in the
state: a prefix reads the key from its copy of the state (a captured prefix
from the graphs' static buffers, loaded before each replay) and the key it
returns is thrown away, so a run with profiling on draws exactly what it
draws with profiling off. The key is one of the graphs' static inputs.

Overhead discipline: ``warm()`` runs every prefix once (building and loading
the kernels) and, on the card, captures them, outside any timed window; a
class first met in ``sample()`` is warmed there. Sampling is 1-of-N
dispatches (``ProfilingSettings.sample_every_dispatches``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

import torch

from ..observability import PROFILE_PHASE_BUCKETS_MS, Metrics, MetricsHistory
from ..runtime import jitwatch
from ..settings import ProfilingSettings
from ..sim import kernels
from ..sim.engine import step, step_cut_detector, step_fd_scan

DEVICE_PHASES = ("fd_scan", "cut_detector", "consensus_count")
PHASES = DEVICE_PHASES + ("host_transfer",)

# the shadow entry points, in phase order
_PROFILE_FNS = (step_fd_scan, step_cut_detector, step)
TURN_ATTEMPTS = 3  # takes of a turn whose times do not rise


def wall_ms(fn, config, state, inputs, random_loss: bool) -> float:
    """Host wall ms of one prefix call up to ``jitwatch.drain``: a prefix's
    time on the CPU, as JAX's ``_timed_ms`` takes it."""
    t0 = time.perf_counter()
    out = fn(config, state, inputs, random_loss)
    jitwatch.drain("sim.profile.sample", out)
    return (time.perf_counter() - t0) * 1000.0


def _on_card(state) -> bool:
    return state.active.device.type == "cuda"


def _tensors(tree) -> Dict[str, torch.Tensor]:
    return {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)
            if isinstance(getattr(tree, f.name), torch.Tensor)}


def _class_key(config, state, inputs, random_loss: bool) -> Tuple:
    shapes = tuple((name, tuple(t.shape), t.dtype, t.device)
                   for tree in (state, inputs) for name, t in _tensors(tree).items())
    return config, bool(random_loss), shapes


@dataclasses.dataclass
class _Captured:
    """The three prefixes of one (config, shapes, ``random_loss``) class,
    captured as CUDA graphs over static input buffers."""

    state: object  # the SimState of static buffers the graphs read, its key included
    inputs: object  # the RoundInputs of static buffers
    graphs: Tuple[torch.cuda.CUDAGraph, ...]  # in _PROFILE_FNS order
    events: Tuple[Tuple[torch.cuda.Event, torch.cuda.Event], ...]  # each graph's first, last node
    outputs: Tuple  # each graph's outputs, kept alive in the class's pool
    launches: Tuple[Dict[str, int], ...]  # the kernel launches of one replay

    def load(self, state, inputs) -> None:
        """Copy the current state and inputs into the static buffers."""
        for static, live in ((self.state, state), (self.inputs, inputs)):
            for name, t in _tensors(live).items():
                getattr(static, name).copy_(t)


def _capture(config, state, inputs, random_loss: bool) -> _Captured:
    """Capture every prefix of this class, each in its own graph, all in
    one private pool; the prefixes have run eagerly before, so nothing is
    built or loaded inside a capture."""
    static_state = dataclasses.replace(
        state, **{name: t.clone() for name, t in _tensors(state).items()})
    static_inputs = dataclasses.replace(
        inputs, **{name: t.clone() for name, t in _tensors(inputs).items()})
    pool = torch.cuda.graph_pool_handle()
    graphs, events, outputs, launches = [], [], [], []
    for fn in _PROFILE_FNS:
        graph = torch.cuda.CUDAGraph()
        start, end = (torch.cuda.Event(enable_timing=True, external=True) for _ in range(2))
        with kernels.captured_launches() as counted, kernels.no_collection():
            with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
                start.record()
                out = fn(config, static_state, static_inputs, random_loss)
                end.record()
        graphs.append(graph)
        events.append((start, end))
        outputs.append(out)
        launches.append(counted)
    return _Captured(static_state, static_inputs, tuple(graphs), tuple(events),
                     tuple(outputs), tuple(launches))


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
        self.turns = 0  # turns taken, three prefix times (replays on the card) each
        self.last_sample: Optional[Dict[str, float]] = None
        self._dispatches = 0
        self._totals: Dict[str, float] = {phase: 0.0 for phase in PHASES}
        self._captured: Dict[Tuple, _Captured] = {}  # by _class_key, on the card
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

    def _timed_ms(self, fn, config, state, inputs, random_loss: bool) -> float:
        """One prefix's time: on a CUDA state the device ms of its graph's
        replay, between the events inside it, else its host wall
        (``wall_ms``)."""
        if not _on_card(state):
            return wall_ms(fn, config, state, inputs, random_loss)
        key = _class_key(config, state, inputs, random_loss)
        if key not in self._captured:
            self.warm(config, state, inputs, random_loss)
        captured = self._captured[key]
        i = _PROFILE_FNS.index(fn)
        captured.load(state, inputs)
        captured.graphs[i].replay()
        kernels.count_replay(captured.launches[i])
        jitwatch.drain("sim.profile.sample", state)
        start, end = captured.events[i]
        return start.elapsed_time(end)

    def warm(self, config, state, inputs, random_loss: bool = False) -> None:
        """Run every shadow prefix once for this (config, shapes,
        random_loss) class, so the kernels are built and loaded, and on a
        CUDA state capture the prefixes; a capture is recorded with
        ``jitwatch`` as the class's compile (a violation inside a timed
        window, as a JAX compile is)."""
        for fn in _PROFILE_FNS:
            jitwatch.drain("sim.profile.warm", fn(config, state, inputs, random_loss))
        key = _class_key(config, state, inputs, random_loss)
        if not _on_card(state) or key in self._captured:
            return
        t0 = time.perf_counter()
        # torch.cuda.graph synchronizes the device before it captures
        with jitwatch.host_transfer("sim.profile.capture"):
            self._captured[key] = _capture(config, state, inputs, random_loss)
        jitwatch.record_compile("sim.profile.prefixes", time.perf_counter() - t0, "capture")

    def _turn(self, config, state, inputs, random_loss: bool) -> Tuple[float, float, float]:
        """The three prefixes' times in order; on the card taken again
        while they do not rise, at most ``TURN_ATTEMPTS`` times."""
        for _ in range(TURN_ATTEMPTS if _on_card(state) else 1):
            times = tuple(self._timed_ms(fn, config, state, inputs, random_loss)
                          for fn in _PROFILE_FNS)
            self.turns += 1
            if times[0] < times[1] < times[2]:
                break
        return times

    def sample(self, config, state, inputs, random_loss: bool = False,
               repeats: int = 1) -> Dict[str, float]:
        """One shadow attribution of the current round's computation, from
        the turn with the least full step of ``repeats`` turns (the in-loop
        default is one)."""
        turns = [self._turn(config, state, inputs, random_loss)
                 for _ in range(max(1, int(repeats)))]
        t_fd, t_cut, t_full = min(turns, key=lambda turn: turn[2])
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
        """Accumulated per-phase ms across every sample so far."""
        return dict(self._totals)
