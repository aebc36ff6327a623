"""The traced slice of a run: a ``torch.profiler`` trace of the device,
reduced to what the per-layer readers and the result's ``breakdown`` need.

The arithmetic is the program's ``sim/profile_decision.py`` ``profile_gpu``,
copied here so that the yardstick stays put: the device's operations are the
kernels and copies on its timeline; the ranges that the program names around
a hand-written kernel's launch show there too, overlap the kernels they
name, and are counted apart (``annotations``), never as busy time. Busy time
is the union of the operations' intervals, and the idle share is one less
busy over the slice's wall. Host spans (the harness's own, and the
program's tracer spans, placed on the trace's clock through the harness's
spans, which both clocks saw) say what the host was doing in each idle gap.
"""

from __future__ import annotations

import bisect
import re
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

Interval = Tuple[str, float, float]  # (name, start µs, end µs) on the trace's clock


@dataclass
class Trace:
    wall_s: float  # the slice, host clock, ending in a device synchronize
    ops: List[Interval]  # kernels and copies
    annotations: List[Interval]  # named ranges on the device's timeline
    host: List[Interval]  # harness and program spans, innermost last
    rounds: int  # protocol rounds the program executed in the slice

    def busy_s(self) -> float:
        total, end = 0.0, float("-inf")
        for _, s, e in sorted(self.ops, key=lambda x: x[1]):
            if e <= end:
                continue
            total += e - max(s, end)
            end = e
        return total / 1e6

    def inside(self, label: str) -> Tuple[int, float]:
        """(ranges named ``label``, µs of the device operations that start
        inside one of them)."""
        ranges = sorted((s, e) for n, s, e in self.annotations if n == label)
        if not ranges:
            return 0, 0.0
        starts = [s for s, _ in ranges]
        us = 0.0
        for _, s, e in self.ops:
            i = bisect.bisect_right(starts, s) - 1
            if i >= 0 and s <= ranges[i][1]:
                us += e - s
        return len(ranges), us

    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for name, s, e in self.ops:
            key = short_name(name)
            by[key] = by.get(key, 0.0) + (e - s) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """Idle seconds of the device, summed by what the host was doing
        when each gap opened (the innermost host span over its start)."""
        ops = sorted(self.ops, key=lambda x: x[1])
        host = sorted(self.host, key=lambda x: x[1])
        by: Dict[str, float] = {}
        end = ops[0][2] if ops else 0.0
        for _, s, e in ops[1:]:
            if s > end:
                label = _label(host, end)
                by[label] = by.get(label, 0.0) + (s - end) / 1e6
            end = max(end, e)
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def _label(host: List[Interval], t: float) -> str:
    inner = [name for name, s, e in host if s <= t < e]
    return "/".join(inner) if inner else "outside"


def short_name(name: str) -> str:
    """A kernel's name without its return type and arguments."""
    name = re.sub(r"^void |\(anonymous namespace\)::", "", name)
    name = re.sub(r"\(.*$", "", name)
    return name[:80] or "(unnamed)"


def profile(fn: Callable[[], int], host_spans: Callable[[], List[Tuple[str, float, float]]],
            program_spans: Callable[[], List[Tuple[str, float, float]]]) -> Trace:
    """Run ``fn`` (which returns the rounds it executed) under the
    profiler. ``host_spans()`` gives the harness's spans of the slice (name,
    perf_counter start, end), each also opened as a ``record_function``;
    ``program_spans()`` the program's, on the host clock."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rounds = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ops: List[Interval] = []
    annotations: List[Interval] = []
    marks: Dict[str, List[Tuple[float, float]]] = {}
    for e in prof.events():
        tr = e.time_range
        if e.device_type == torch.autograd.DeviceType.CUDA:
            (annotations if e.is_user_annotation else ops).append((e.name, tr.start, tr.end))
        elif e.name.startswith(("episode.", "wave.")):
            marks.setdefault(e.name, []).append((tr.start, tr.end))
    # the clock of the trace against the host's, from the harness's spans
    marked = host_spans()
    pairs = []
    seen: Dict[str, int] = {}
    for name, s, _ in marked:
        i = seen.get(name, 0)
        seen[name] = i + 1
        got = sorted(marks.get(name, []))
        if i < len(got):
            pairs.append(got[i][0] - s * 1e6)
    host: List[Interval] = []
    if pairs:
        offset = sorted(pairs)[len(pairs) // 2]
        host = [(n, s * 1e6 + offset, e * 1e6 + offset) for n, s, e in marked]
        host += [(n, s * 1e6 + offset, e * 1e6 + offset) for n, s, e in program_spans()]
    return Trace(wall_s=wall, ops=ops, annotations=annotations, host=host, rounds=rounds)
