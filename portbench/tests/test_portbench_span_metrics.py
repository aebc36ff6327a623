"""The readers of the program's spans inside its join path, dispatch and
view change, and of the ``route_and_tally`` ranges on the device trace."""

import pytest

from portbench.harness import EpisodeRecord
from portbench.tests.test_portbench_metrics import _run, _trace, read

PROGRAM_SPAN_READERS = ("join_arm_ms.per_wave", "ring_order_ms.per_wave",
                        "dispatch_inputs_ms.per_round", "dispatch_enqueue_ms.per_round",
                        "decision_wait_ms.per_round", "config_id_ms.mean",
                        "fresh_state_ms.mean")


def _program_run():
    """``_run`` with a second decided wave, an undecided one, and the
    spans inside the program's join path, dispatch and view change."""
    run = _run()
    run.episodes += [EpisodeRecord("wave", 4000.0, 1, True),
                     EpisodeRecord("wave", 9000.0, 0, False)]
    run.spans += [("join_arm", 300.0), ("ring_order", 100.0), ("join_arm", 500.0),
                  ("ring_order", 140.0), ("dispatch_inputs", 8.0), ("dispatch_inputs", 4.0),
                  ("dispatch_enqueue", 24.0), ("decision_fetch", 4.0),
                  ("dispatch_enqueue", 16.0), ("decision_fetch", 2.0),
                  ("config_id", 2.0), ("fresh_state", 1.0), ("config_id", 4.0),
                  ("fresh_state", 3.0), ("config_id", 6.0), ("fresh_state", 5.0)]
    return run


def test_program_span_readers():
    run = _program_run()
    assert read("join_arm_ms.per_wave", run) == pytest.approx(800.0 / 2)
    assert read("ring_order_ms.per_wave", run) == pytest.approx(240.0 / 2)
    assert read("dispatch_inputs_ms.per_round", run) == pytest.approx(12.0 / 80)
    assert read("dispatch_enqueue_ms.per_round", run) == pytest.approx(40.0 / 80)
    assert read("decision_wait_ms.per_round", run) == pytest.approx(6.0 / 80)
    assert read("config_id_ms.mean", run) == pytest.approx(4.0)
    assert read("fresh_state_ms.mean", run) == pytest.approx(3.0)
    # the parts of a dispatch leave its whole as it was
    assert read("dispatch_ms.per_round", run) == pytest.approx(40.0 / 80)
    assert read("view_change_ms.mean", run) == pytest.approx(5.0)


@pytest.mark.parametrize("name", PROGRAM_SPAN_READERS)
def test_program_span_readers_return_nothing_without_their_spans(name):
    # the parent commit's program records none of these spans
    assert read(name, _run()) is None
    no_rounds = _program_run()
    no_rounds.counters = {"rounds": 0}
    no_waves = _program_run()
    no_waves.episodes = [e for e in no_waves.episodes if e.kind == "failure"]
    per = name.rsplit(".", 1)[1]
    if per == "per_round":
        assert read(name, no_rounds) is None
    elif per == "per_wave":
        assert read(name, no_waves) is None
    else:
        assert read(name, no_rounds) is not None


def test_route_and_tally_reader():
    tr = _trace()
    # one range over the first observer_pass (the node_pass before it starts
    # outside), one over the copy from its first µs, one over no op
    tr.annotations += [("route_and_tally", 125.0, 161.0), ("route_and_tally", 500.0, 600.0),
                       ("route_and_tally", 700.0, 710.0)]
    run = _run(tr)
    assert read("route_and_tally.ops_per_round", run) == pytest.approx(2 / 4)
    # the ranges are annotations, never operations
    assert read("device.ops_per_round", run) == pytest.approx(5 / 4)
    c, k = 1000, 10
    bound = 2 * (c * k * 11 + c * 7 + 37) / 3.35e12
    assert read("fd_phase_fused_roofline", run) == pytest.approx(100 * bound / 120e-6)


def test_route_and_tally_reader_returns_nothing_without_its_ranges():
    assert read("route_and_tally.ops_per_round", _run()) is None
    assert read("route_and_tally.ops_per_round", _run(_trace())) is None
    no_rounds = _trace()
    no_rounds.annotations.append(("route_and_tally", 95.0, 165.0))
    no_rounds.rounds = 0
    assert read("route_and_tally.ops_per_round", _run(no_rounds)) is None
