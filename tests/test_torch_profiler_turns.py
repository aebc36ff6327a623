"""The port's ``PhaseProfiler.sample`` takes its three prefix times in turns
and keeps the turn with the least full step; the JAX package's (and the
port's before) took each prefix's minimum apart and clamped the
differences at 0. Pinned on the CPU with the timing seam stubbed:

- a host whose walls shrink over the sample, each turn's walls rising with
  the prefix's ops: minima taken apart put the least full step (taken
  last) under the least cut-detector prefix and clamp consensus_count to
  0, while the turn rule gives every phase above 0;
- walls that are the same in every turn: the port's sample equals JAX's;
- on the card a turn whose times do not rise (one replay held up) is taken
  again, at most ``TURN_ATTEMPTS`` times, after which the clamp still
  guards, and ``turns`` counts every turn taken; on the CPU a turn is
  taken once and the sample equals JAX's on the same walls.

And what the card's captures use: the launch accounting of a captured
prefix (``kernels.captured_launches`` and ``count_replay``), and no garbage
collection inside a capture (``kernels.no_collection``)."""

from types import SimpleNamespace

import pytest
import torch

from rapid_tpu.observability import Metrics as JaxMetrics
from rapid_tpu.profiling import phases as jax_phases
from rapid_tpu.settings import ProfilingSettings as JaxProfilingSettings
from rapid_tpu_torch.observability import Metrics
from rapid_tpu_torch.profiling import phases
from rapid_tpu_torch.settings import ProfilingSettings
from rapid_tpu_torch.sim import kernels

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py

OPS = (1.0, 2.0, 2.5)  # each prefix's work, fd_scan < cut_detector < full step
SHRINK = 0.95  # the host's wall factor from one prefix call to the next
REPEATS = 5
# the only field of a state the sample reads: where its tensors lie
CPU_STATE = SimpleNamespace(active=torch.zeros(1, dtype=torch.bool))
CARD_STATE = SimpleNamespace(active=SimpleNamespace(device=torch.device("cuda")))


def _stub(profiled_fns, shrink):
    """A timing seam: the k-th call's wall is its prefix's ``OPS`` times
    ``shrink ** k``."""
    calls = []

    def timed_ms(fn, *_args):
        calls.append(fn)
        return OPS[profiled_fns.index(fn)] * shrink ** (len(calls) - 1)

    return timed_ms, calls


def _port_sample(shrink, repeats=REPEATS):
    prof = phases.PhaseProfiler(Metrics(), ProfilingSettings(enabled=True))
    prof._timed_ms, calls = _stub(phases._PROFILE_FNS, shrink)
    return prof.sample(None, CPU_STATE, None, True, repeats=repeats), prof, calls


def test_turns_keep_every_phase_above_zero_where_minima_apart_clamp():
    got, prof, calls = _port_sample(SHRINK)
    assert all(got[p] > 0 for p in phases.DEVICE_PHASES), got
    # every turn is fd_scan, cut_detector, full step, in that order
    assert calls == list(phases._PROFILE_FNS) * REPEATS and prof.turns == REPEATS
    # the turn with the least full step is the last one
    last = [OPS[i] * SHRINK ** (3 * (REPEATS - 1) + i) for i in range(3)]
    assert got["step_ms"] == last[2]
    assert got["fd_scan"] == last[0]
    assert got["cut_detector"] == pytest.approx(last[1] - last[0])
    assert got["consensus_count"] == pytest.approx(last[2] - last[1])
    # the same walls, each prefix's minimum taken apart (the JAX package's
    # order of calls: every fd_scan, then every cut_detector, then every full)
    jax = jax_phases.PhaseProfiler(JaxMetrics(), JaxProfilingSettings(enabled=True))
    jax._timed_ms, _ = _stub(jax_phases._PROFILE_FNS, SHRINK)
    apart = jax.sample(None, None, None, True, repeats=REPEATS)
    assert apart["consensus_count"] == 0.0, apart


def _scripted(walls):
    """A timing seam that returns ``walls`` in order, one a call."""
    left, calls = list(walls), []

    def timed_ms(fn, *_args):
        calls.append(fn)
        return left.pop(0)

    return timed_ms, calls


DISTURBED = (0.03, 0.63, 0.34)  # the cut_detector prefix's replay held up: over the full step
CLEAN = (0.03, 0.17, 0.33)


def test_a_turn_whose_times_do_not_rise_is_taken_again_on_the_card():
    prof = phases.PhaseProfiler(Metrics(), ProfilingSettings(enabled=True))
    prof._timed_ms, calls = _scripted(DISTURBED + CLEAN)
    got = prof.sample(None, CARD_STATE, None, True)
    assert calls == list(phases._PROFILE_FNS) * 2 and prof.turns == 2
    assert got == pytest.approx({"fd_scan": 0.03, "cut_detector": 0.14,
                                 "consensus_count": 0.16, "step_ms": 0.33})
    # a one-shot sample of the disturbed turn alone, as JAX takes it, clamps
    jax = jax_phases.PhaseProfiler(JaxMetrics(), JaxProfilingSettings(enabled=True))
    jax._timed_ms, _ = _scripted(DISTURBED)
    assert jax.sample(None, None, None, True)["consensus_count"] == 0.0


def test_a_turn_disturbed_at_every_attempt_keeps_the_clamp_as_a_guard():
    prof = phases.PhaseProfiler(Metrics(), ProfilingSettings(enabled=True))
    prof._timed_ms, calls = _scripted(DISTURBED * phases.TURN_ATTEMPTS)
    got = prof.sample(None, CARD_STATE, None, True)
    assert len(calls) == 3 * phases.TURN_ATTEMPTS == 3 * prof.turns
    assert got["consensus_count"] == 0.0 and min(got.values()) >= 0.0


def test_on_the_cpu_a_turn_is_taken_once_as_jax_takes_it():
    prof = phases.PhaseProfiler(Metrics(), ProfilingSettings(enabled=True))
    prof._timed_ms, calls = _scripted(DISTURBED + CLEAN)
    got = prof.sample(None, CPU_STATE, None, True)
    assert calls == list(phases._PROFILE_FNS) and prof.turns == 1
    jax = jax_phases.PhaseProfiler(JaxMetrics(), JaxProfilingSettings(enabled=True))
    jax._timed_ms, _ = _scripted(DISTURBED)
    assert got == jax.sample(None, None, None, True)
    assert got["consensus_count"] == 0.0


@pytest.mark.parametrize("repeats", [1, 3, REPEATS])
def test_walls_equal_in_every_turn_give_what_jax_gives(repeats):
    got, prof, _ = _port_sample(1.0, repeats)
    jax = jax_phases.PhaseProfiler(JaxMetrics(), JaxProfilingSettings(enabled=True))
    jax._timed_ms, _ = _stub(jax_phases._PROFILE_FNS, 1.0)
    want = jax.sample(None, None, None, True, repeats=repeats)
    assert got == want
    assert prof.attribution() == jax.attribution()


def test_a_captured_launch_counts_once_a_replay_not_at_capture():
    kernels.reset_launches()
    kernels.LAUNCHES["placement_topr"] += 1  # a launch before the capture stays
    with kernels.captured_launches() as counted:
        kernels.LAUNCHES["fd_phase_fused"] += 1  # what a wrapper counts while captured
    assert counted == {"fd_phase_fused": 1}
    assert kernels.LAUNCHES["fd_phase_fused"] == 0 and kernels.LAUNCHES["placement_topr"] == 1
    for _ in range(3):
        kernels.count_replay(counted)
    assert kernels.LAUNCHES["fd_phase_fused"] == 3
    kernels.reset_launches()


def test_no_garbage_collection_inside_a_capture_block():
    import gc

    assert gc.isenabled()
    with kernels.no_collection():
        assert not gc.isenabled()
    assert gc.isenabled()
    gc.disable()
    try:
        with kernels.no_collection():
            pass
        assert not gc.isenabled()  # left as the caller had it
    finally:
        gc.enable()
