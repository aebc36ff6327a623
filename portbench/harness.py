"""One run of one cell: set-up, the measured window, the traced slice, and
the check of every view change against the reference.

Set-up builds one ``rapid_tpu_torch.sim.driver.Simulator`` on the card for
the cell's configuration and warms it with one failure episode and one
restart wave of the cell's own mix. The window is a closed loop of the
mix's episodes (``generator.py``) on that same simulator, each inside
``jitwatch.timed_window``, so a kernel build or an unaudited host sync in it
fails the run:

- a failure episode injects the fault into its burst and runs
  ``run_until_decision`` until a view holds none of the burst, then waits
  for the device (``Simulator.ready``); its time to a stable view runs from
  the injection to there;
- a restart wave re-seats every slot that failed since the last wave with a
  fresh NodeId at its old endpoint, clears its loss, requests the joins and
  runs ``run_until_decision`` until every one is admitted.

The window closes at the first wave that ends after ``seconds``, so that
it holds whole cycles of the mix. With ``trace`` a slice follows it under
the profiler: ``TRACE_CYCLES`` more whole cycles. The reference then replays every episode of the run, set-up's
included, and every view change the program made is compared with it.
"""

from __future__ import annotations

import contextlib
import gc
import os
import statistics
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import check, trace as tracing
from .generator import Episode, Generator
from .spec import Cell

BATCH = 16  # rounds a dispatch
CALL_ROUNDS = 64  # rounds a run_until_decision call may take
ROUND_BUDGET = 256  # rounds an episode may take before it counts as failed
TRACE_CYCLES = 2  # whole cycles of the mix (its failure episodes and wave) traced


class BandError(RuntimeError):
    """The membership left the band the mix keeps it in."""


@dataclass
class EpisodeRecord:
    kind: str
    ms: float  # host clock, injection to the stable view, synchronized
    view_changes: int
    decided: bool


@dataclass
class Run:
    """What the metric readers read."""

    cell: Cell
    setup_s: float
    window_s: float
    episodes: List[EpisodeRecord]  # the window's
    spans: List[Tuple[str, float]]  # the program's spans in the window: (name, ms)
    counters: Dict[str, int]  # the program's counters' increase over the window
    trace: Optional[tracing.Trace] = None

    def failures_ms(self) -> List[float]:
        return [e.ms for e in self.episodes if e.kind == "failure" and e.decided]


def p90(values: List[float]) -> Optional[float]:
    """The 90th percentile by nearest rank (ten samples or more beyond it
    from a hundred)."""
    if not values:
        return None
    ordered = sorted(values)
    return ordered[max(0, int(np.ceil(0.9 * len(ordered))) - 1)]


class Driver:
    """The cell's simulator and the episodes it has been through."""

    def __init__(self, cell: Cell, seed: int, device: str) -> None:
        from rapid_tpu_torch.observability import Metrics, Tracer
        from rapid_tpu_torch.sim.driver import Simulator
        from rapid_tpu_torch.sim.engine import SimConfig

        cfg = cell.config
        self.members = int(cfg["members"])
        self.config = SimConfig(
            capacity=self.members, k=cfg["k"], h=cfg["h"], l=cfg["l"],
            fd_threshold=cfg["fd_threshold"], fd_interval_ms=cfg["fd_interval_ms"],
            batching_window_ms=cfg["batching_window_ms"], fd_policy=cfg["fd_policy"])
        self.tracer = Tracer(max_spans=0)
        self.metrics = Metrics()
        self.sim = Simulator(self.members, config=self.config, seed=seed,
                             metrics=self.metrics, tracer=self.tracer, device=device)
        self.gen = Generator(cell.traffic, self.members, seed)
        self.log: List[Episode] = []
        # (wave, slot) -> the observers the join path armed for that joiner:
        # ``_arm_pending_joins`` asks ``_expected_observers`` once a joiner
        # and configuration, and the first answer of each wave is kept, as it
        # was armed, so the check asks the program nothing in the window
        self.join_observers: Dict[Tuple[int, int], np.ndarray] = {}
        self._wave = 0
        armed = self.sim._expected_observers

        def tap(node: int):
            ids, alive = armed(node)
            self.join_observers.setdefault((self._wave, int(node)), ids)
            return ids, alive

        self.sim._expected_observers = tap
        self.marks: List[Tuple[str, float, float]] = []  # the harness's spans
        self.profiling = False
        self.undecided = 0  # episodes not decided within ROUND_BUDGET

    @contextlib.contextmanager
    def _mark(self, name: str):
        """A harness span; under the profiler also a named range."""
        t0 = time.perf_counter()
        with (torch.profiler.record_function(name) if self.profiling
              else contextlib.nullcontext()):
            yield
        self.marks.append((name, t0, time.perf_counter()))

    def _decide_until(self, done) -> bool:
        """``run_until_decision`` until ``done()``, within ROUND_BUDGET."""
        for _ in range(ROUND_BUDGET // CALL_ROUNDS):
            if done():
                return True
            self.sim.run_until_decision(max_rounds=CALL_ROUNDS, batch=BATCH)
        return done()

    def run(self, ep: Episode, timed: bool = True) -> EpisodeRecord:
        """One episode; ``timed``: inside ``jitwatch.timed_window`` (set-up's
        are not: they load the kernels)."""
        from rapid_tpu_torch.runtime import jitwatch

        sim = self.sim
        before = len(sim.view_changes)
        self.log.append(ep)
        with (jitwatch.timed_window(f"portbench.{ep.kind}") if timed
              else contextlib.nullcontext()):
            t0 = time.perf_counter()
            if ep.kind == "failure":
                with self._mark("episode.inject"):
                    if self.gen.fault == "crash":
                        sim.crash(ep.slots)
                    else:
                        sim.ingress_loss(ep.slots, self.gen.loss)
                with self._mark("episode.decide"):
                    ok = self._decide_until(lambda: not sim.active[ep.slots].any())
                    sim.ready()
            else:
                with self._mark("wave.reseat"):
                    for slot, (high, low) in zip(ep.slots, ep.ids):
                        host, port = sim.endpoint_of(int(slot))
                        sim.assign_identity(int(slot), host, port, int(high), int(low))
                    sim.ingress_loss(ep.slots, 0.0)
                    self._wave = ep.number
                    sim.request_joins(ep.slots)
                with self._mark("wave.decide"):
                    ok = self._decide_until(lambda: sim.active[ep.slots].all())
                    sim.ready()
            ms = (time.perf_counter() - t0) * 1000.0
        self.undecided += not ok
        size = int(sim.active.sum())
        lo, hi = self.gen.band
        if ok and not lo <= size <= hi:
            raise BandError(f"membership {size} left its band [{lo}, {hi}]")
        return EpisodeRecord(ep.kind, ms, len(sim.view_changes) - before, ok)


def _counters(metrics) -> Dict[str, int]:
    return {name: metrics.get(name) for name in ("rounds", "view_changes")}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, setup_clock,
             device: str = "cuda") -> dict:
    """One run; returns the result's fields (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, ``breakdown``, ``checks``)."""
    os.environ["RAPID_JITWATCH"] = "1"
    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    drv = Driver(cell, seed, device)
    sim = drv.sim
    # set-up: one failure episode and one wave of the mix
    if drv.run(drv.gen.failure(), timed=False).decided:
        drv.run(drv.gen.wave(), timed=False)
    # the kernels' builds in this set-up (a checkout's first run), shown apart
    build_s = _build_seconds()
    # set-up's objects (the identifier history's set among them) leave the
    # collector's generations, so no full collection walks them in the window
    gc.collect()
    gc.freeze()
    # the window
    episodes: List[EpisodeRecord] = []
    spans0 = len(drv.tracer.spans)
    counters0 = _counters(drv.metrics)
    setup_s = setup_clock()
    cpu0 = time.process_time()
    t0 = time.perf_counter()
    # whole cycles of the mix: the window closes after a wave, once
    # ``seconds`` have passed, so every run holds failures and waves alike
    while not drv.undecided and (time.perf_counter() - t0 < seconds
                                 or drv.gen.failures_since_wave):
        episodes.append(drv.run(drv.gen.next()))
    window_s = time.perf_counter() - t0
    cpu_s = time.process_time() - cpu0
    gc.unfreeze()
    counters = {k: v - counters0[k] for k, v in _counters(drv.metrics).items()}
    spans = [(s.name, s.wall_ms) for s in drv.tracer.spans[spans0:]]
    run = Run(cell=cell, setup_s=setup_s, window_s=window_s, episodes=episodes,
              spans=spans, counters=counters)
    if trace and not drv.undecided:
        if drv.gen.waiting:
            drv.run(drv.gen.wave())
        run.trace = _traced_slice(drv) if on_card else None
    failed = drv.undecided
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    # the program's answers, then its state freed before the reference runs
    answers = check.Answers(
        records=list(sim.view_changes),
        join_observers={key: [int(x) for x in ids] for key, ids in drv.join_observers.items()},
        log=list(drv.log), seed=seed, capacity=drv.config.capacity)
    del sim, drv
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = check.compare(cell, answers, ROUND_BUDGET)
    reference_s = time.perf_counter() - t_ref
    correct = failed == 0 and all(v <= limit for v, limit in numbers.values())
    metrics = _read(cell.per_layer if trace else cell.end_to_end, run)
    device_info = {"platform": "gpu" if on_card else "cpu", "kind": kind,
                   "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": len(episodes), "failed": failed,
           "metrics": metrics, "device": device_info, "build_s": build_s}
    if run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s()
        device_info["window_s"] = run.trace.wall_s
        out["breakdown"] = {"device_ops": run.trace.top_ops(),
                            "idle_gaps": run.trace.idle_gaps()}
    out["_timings"] = {"setup_s": setup_s, "build_s": build_s, "window_s": window_s,
                       "episodes": len(episodes), "view_changes": counters["view_changes"],
                       "reference_s": reference_s, "window_cpu_s": cpu_s,
                       "failure_ms_median": statistics.median(run.failures_ms() or [0.0]),
                       "failure_s": sum(e.ms for e in episodes if e.kind == "failure") / 1e3,
                       "wave_s": sum(e.ms for e in episodes if e.kind == "wave") / 1e3,
                       "wave_ms_median": statistics.median(
                           [e.ms for e in episodes if e.kind == "wave"] or [0.0]),
                       "trace_wall_s": run.trace.wall_s if run.trace is not None else 0.0}
    out["checks"] = {name: {"value": v, "limit": limit} for name, (v, limit) in numbers.items()}
    return out


def _build_seconds() -> float:
    """Seconds this process spent building kernels (nvcc and g++), which
    ``setup_s`` includes; 0 where every kernel was already built."""
    from rapid_tpu_torch.runtime import jitwatch

    return sum(e.wall_s for e in jitwatch.compile_events() if e.kind in ("nvcc", "g++"))


def _read(metrics, run: Run) -> dict:
    out = {}
    for m in metrics:
        value = m.read(run)
        if value is not None:
            out[m.name] = {"value": value, "unit": m.unit}
    return out


def _traced_slice(drv: Driver) -> tracing.Trace:
    """TRACE_CYCLES whole cycles of the mix under the profiler."""
    start_rounds = drv.metrics.get("rounds")
    spans0 = len(drv.tracer.spans)
    marks0 = len(drv.marks)

    def slice_() -> int:
        for _ in range(TRACE_CYCLES * (drv.gen.wave_every + 1)):
            drv.run(drv.gen.next())
        return drv.metrics.get("rounds") - start_rounds

    def program_spans():
        return [(s.name, s.wall_start_s, s.wall_end_s) for s in drv.tracer.spans[spans0:]]

    drv.profiling = True
    try:
        tr = tracing.profile(slice_, lambda: drv.marks[marks0:], program_spans)
    finally:
        drv.profiling = False
    return tr
