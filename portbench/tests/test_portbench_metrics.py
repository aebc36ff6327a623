"""Each metric reader's arithmetic on a synthetic run and trace."""

import pytest

from portbench import spec
from portbench.harness import EpisodeRecord, Run, p90
from portbench.trace import Trace
from portbench.tests.conftest import tiny_cell


def _run(trace=None):
    cell = tiny_cell("lossy-burst")
    episodes = [EpisodeRecord("failure", float(ms), 1, True) for ms in range(1, 101)]
    episodes.append(EpisodeRecord("wave", 5000.0, 1, True))
    spans = [("view_change", 4.0), ("view_change", 6.0), ("device_rounds", 10.0),
             ("device_rounds", 30.0), ("fd_signal", 0.0)]
    return Run(cell=cell, setup_s=12.5, window_s=20.0, episodes=episodes, spans=spans,
               counters={"rounds": 80, "device_dispatches": 2, "view_changes": 101},
               trace=trace)


def _trace():
    # two fd_phase_fused ranges, each holding two kernels of 30 µs; a copy
    # outside them; 1 ms of wall
    ops = [("void (anonymous namespace)::node_pass<true>(Params)", 100.0, 130.0), ("observer_pass", 130.0, 160.0),
           ("node_pass", 300.0, 330.0), ("observer_pass", 330.0, 360.0),
           ("Memcpy DtoH (Device -> Pinned)", 500.0, 600.0)]
    ann = [("fd_phase_fused", 95.0, 165.0), ("fd_phase_fused", 295.0, 365.0)]
    host = [("episode.decide", 0.0, 1000.0), ("device_rounds", 150.0, 400.0)]
    return Trace(wall_s=1e-3, ops=ops, annotations=ann, host=host, rounds=4)


def read(name, run):
    return spec.reader(name)(run)


def test_end_to_end_readers():
    run = _run()
    assert read("setup_s", run) == 12.5
    assert read("view_changes_per_s", run) == pytest.approx(101 / 20.0)
    assert read("stable_view_ms.p90.sampled", run) == 90.0
    assert read("stable_view_ms.p90.closed_form", run) == 90.0
    assert read("join_wave_ms.mean", run) == 5000.0
    assert p90([]) is None and p90([3.0]) == 3.0


def test_span_readers():
    run = _run()
    assert read("view_change_ms.mean", run) == pytest.approx(5.0)
    assert read("dispatch_ms.per_round", run) == pytest.approx(40.0 / 80)


def test_trace_readers():
    run = _run(_trace())
    assert read("device.idle_share", run) == pytest.approx(100.0 * (1 - 220e-6 / 1e-3))
    assert read("device.ops_per_round", run) == pytest.approx(5 / 4)
    c, k = 1000, 10
    bound = 2 * (c * k * 11 + c * 7 + 37) / 3.35e12
    assert read("fd_phase_fused_roofline", run) == pytest.approx(100 * bound / 120e-6)


def test_readers_return_nothing_without_a_trace():
    run = _run()
    for name in ("device.idle_share", "device.ops_per_round", "fd_phase_fused_roofline"):
        assert read(name, run) is None
    no_ranges = _trace()
    no_ranges.annotations = []
    assert read("fd_phase_fused_roofline", _run(no_ranges)) is None


def test_breakdown():
    tr = _trace()
    assert tr.busy_s() == pytest.approx(220e-6)
    ops = dict(tr.top_ops())
    assert ops["node_pass<true>"] == pytest.approx(30e-6)
    gaps = dict(tr.idle_gaps())
    assert gaps["episode.decide/device_rounds"] == pytest.approx(140e-6 + 140e-6)
