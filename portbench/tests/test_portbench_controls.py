"""The controls come out not correct: the reference in bfloat16 (a lossy
mix), and the configuration id without the identifier history (any mix).
Run at cell size on the card's machine with ``python3 -m
portbench.controls``; here at a size a test run holds."""

import pytest

from portbench import controls, spec


def _cell(mix, members, burst):
    config = dict(spec.config_by_name("rapid-100k"), members=members, capacity=members)
    return config, dict(spec.traffic_by_name(mix), burst_fraction=burst)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_no_history_control_fails(mix, seed):
    config, traffic = _cell(mix, 1000, 0.004)
    numbers = controls.run_control(config, traffic, seed, 12, "no_history")
    assert controls.fails(numbers)
    assert numbers["config_id_mismatch"][0] > 0


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_bfloat16_control_fails(seed):
    # the mix's 1% burst at 10k members over 300 episodes: a flipped draw
    # moves a decision's round only now and then (in one to three episodes
    # of a hundred at this size), so a shorter run can come out with none
    config, traffic = _cell("lossy-burst", 10_000, 0.01)
    numbers = controls.run_control(config, traffic, seed, 300, "bfloat16")
    assert controls.fails(numbers)
    assert numbers["virtual_ms_mismatch"][0] > 0


def test_reference_against_itself_passes(mix):
    config, traffic = _cell(mix, 1000, 0.004)
    answers_log = controls.episode_log(traffic, 1000, 7, 12)
    from portbench import check
    answers = check.Answers([], {}, answers_log, 7, 1000)
    a = check.replay(config, traffic, answers, 256)
    b = check.replay(config, traffic, answers, 256)
    numbers = check.judge(a.changes, b.changes, a.join_observers, b.join_observers, b.unfinished)
    assert not controls.fails(numbers)
