"""The port's own spans (``observability.PORT_SPANS``) and its profiler
ranges, on the CPU.

A simulator of 32 runs a crash (the closed form), a join wave and a lossy
episode (the scan path). Every span of the join path, the dispatch and the
view change sits under the parent the telemetry plane names for it, once a
configuration, view change or dispatch; under ``torch.profiler`` every
tracer span is also a range of the same name and nesting on the profiler's
clock, beside a ``route_and_tally`` range for each round a dispatch runs;
with the profiler off no range is opened.
"""

import collections
import contextlib
import dataclasses

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import rapid_tpu_torch.observability as obs
from rapid_tpu_torch.sim import kernels
from rapid_tpu_torch.sim.driver import Simulator

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py

PARENTS = {
    "join_arm": None,
    "ring_order": "join_arm",
    "dispatch_inputs": None,
    "dispatch_enqueue": "device_rounds",
    "decision_fetch": "device_rounds",
    "config_id": "view_change",
    "fresh_state": "view_change",
}


def _episodes(sim):
    """A crash, a two-member join wave, then 80% ingress loss on two
    members: one view change each."""
    sim.crash(np.array([3]))
    records = [sim.run_until_decision(max_rounds=40)]
    sim.request_joins(np.array([30, 31]))
    records.append(sim.run_until_decision(max_rounds=40))
    sim.ingress_loss(np.array([5, 6]), 0.8)
    records.append(sim.run_until_decision(max_rounds=64, batch=8))
    assert [r.cut.tolist() for r in records] == [[3], [30, 31], [5, 6]]
    return records


def _sim(**kw):
    return Simulator(30, capacity=32, seed=3, device="cpu",
                     tracer=obs.Tracer(max_spans=0), metrics=obs.Metrics(), **kw)


def test_port_spans_sit_under_their_parents():
    sim = _sim()
    asked = collections.Counter()
    armed = sim._expected_observers

    def tap(node):
        asked[int(node)] += 1
        return armed(node)

    sim._expected_observers = tap
    _episodes(sim)
    spans = sim.tracer.spans
    by_id = {s.span_id: s for s in spans}
    names = collections.Counter(s.name for s in spans)
    assert set(obs.PORT_SPANS) <= set(names)
    for s in spans:
        if s.name in PARENTS:
            parent = by_id.get(s.parent_id)
            assert (parent.name if parent else None) == PARENTS[s.name], s.name
            assert not s.name.startswith(("episode.", "wave."))
    # one arming, one ring re-sort, for the one configuration that armed
    # joins; the observers asked once for each joiner
    assert names["join_arm"] == names["ring_order"] == 1
    assert next(s for s in spans if s.name == "join_arm").attrs == {"joiners": 2}
    assert asked == {30: 1, 31: 1}
    # one id fold and one fresh state for each view change
    assert names["config_id"] == names["fresh_state"] == names["view_change"] == 3
    # the parts of every dispatch lie within it, once each
    assert names["dispatch_inputs"] == names["dispatch_enqueue"] == names[
        "decision_fetch"] == names["device_rounds"] == sim.metrics.get("device_dispatches")
    for s in spans:
        if s.name in ("dispatch_enqueue", "decision_fetch", "config_id", "fresh_state"):
            parent = by_id[s.parent_id]
            assert parent.wall_start_s <= s.wall_start_s <= s.wall_end_s <= parent.wall_end_s
    # the port's own spans keep their numbers apart from the spans both
    # packages record
    assert all((s.span_id >= 1 << 48) == (s.name in obs.PORT_SPANS) for s in spans)


def _ranged(s):
    return s.name in obs.SPAN_CATALOG


def test_every_span_is_a_profiler_range_of_the_same_name_and_nesting():
    sim = _sim()
    sim.ready()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _episodes(sim)
    spans = [s for s in sim.tracer.spans if _ranged(s)]
    wanted = {s.name for s in spans}
    events = [e for e in prof.events() if e.name in wanted]
    # match each name's spans and ranges in the order they opened
    ranges = {}
    for name in wanted:
        mine = sorted((s for s in spans if s.name == name), key=lambda s: s.wall_start_s)
        theirs = sorted((e for e in events if e.name == name),
                        key=lambda e: e.time_range.start)
        assert len(theirs) == len(mine), name
        ranges.update({s.span_id: e for s, e in zip(mine, theirs)})
    by_id = {s.span_id: s for s in sim.tracer.spans}
    for s in spans:
        ancestor = ranges[s.span_id].cpu_parent
        while ancestor is not None and ancestor.name not in wanted:
            ancestor = ancestor.cpu_parent
        parent = by_id.get(s.parent_id)
        if parent is not None and _ranged(parent):
            assert ancestor is ranges[parent.span_id], s.name
        else:
            # a root, or parented under an instant (the churn episode's
            # fd_signal), which opens no range
            assert ancestor is None, s.name
    # a route_and_tally range for each round a dispatch ran: the scan's
    # rounds and every round of the closed form's loop, masked ones too
    rounds = sum(s.attrs["rounds"] for s in spans if s.name == "device_rounds")
    tallies = [e for e in prof.events() if e.name == "route_and_tally"]
    assert len(tallies) == rounds > sim.metrics.get("rounds")
    enqueues = [ranges[s.span_id] for s in spans if s.name == "dispatch_enqueue"]
    for e in tallies:
        assert any(q.time_range.start <= e.time_range.start
                   and e.time_range.end <= q.time_range.end for q in enqueues)


def test_no_range_opens_while_the_profiler_is_off(monkeypatch):
    opened = collections.Counter()
    record_function = torch.profiler.record_function

    def counting(name, *args):
        opened[name] += 1
        return record_function(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert isinstance(obs.profiler_range("route_and_tally"), contextlib.nullcontext)
    _episodes(_sim())
    assert not opened
    tracer = obs.Tracer()
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.profiler_range("route_and_tally"):
            pass
        tracer.end(tracer.begin("config_id"))
        with tracer.remote_span("view_change", None):
            pass
    assert opened == {"route_and_tally": 1, "config_id": 1, "view_change": 1}
    # a begin's range is closed by its end and kept off the span's fields
    assert tracer._ranges == {}
    assert [f.name for f in dataclasses.fields(obs.Span)] == [
        "name", "wall_start_s", "wall_end_s", "virtual_start_ms", "virtual_end_ms",
        "attrs", "span_id", "parent_id", "plane", "track", "trace_id"]


def test_the_kernels_name_their_launches_with_the_one_helper():
    assert not hasattr(kernels, "_traced")
    assert kernels.profiler_range is obs.profiler_range
