"""The paper's experiment harnesses on the port
(``rapid_tpu_torch.experiments``) against ``experiments/``: the twins of
``tests/test_experiments.py``'s join-wave and message-load tests and of
``tests/test_timing_conflicts.py``'s trials, through the port's
``run_size``, ``run_strategy``, ``run_trial`` and ``drive_to_convergence``
beside the JAX package's. Each holds the same assertions as its JAX test
and equal outputs: the join wave's record but for its wall, the message
load's whole line, and each trial's conflict, cut, classic-round flag,
configuration id and final membership. The simulators run on
``device="cpu"``; the message load is host code on both.

``experiments/scaling_sweep.py`` (``bench.py``'s ``warmed_run``) is not
ported: it goes with the port's bench entry.
"""

import json

import numpy as np
import pytest
import torch

from experiments import fig11_conflict_sweep as jax_fig11
from experiments import join_wave as jax_join_wave
from experiments import message_load as jax_message_load
from rapid_tpu_torch.experiments import fig11_conflict_sweep as port_fig11
from rapid_tpu_torch.experiments import join_wave as port_join_wave
from rapid_tpu_torch.experiments import message_load as port_message_load

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU path runs these scenarios as thousands of small ops;
    beside other test workers, intra-op threads wait on each other (the WAN
    replay took 58 s against 2.4 s on one thread on a loaded 8-core host),
    so the module runs torch on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TRIALS = [(seed, victims) for seed in range(3) for victims in ([5, 40], [11, 52])]


def _wave_record(out):
    out = dict(out)
    out.pop("warmed_wall_ms")
    return out


def test_join_wave_single_view_change():
    out = port_join_wave.run_size(300, 0.01, seed=7, device="cpu")
    assert out["admitted_ok"] and out["wave"] == 3
    # a whole wave lands in ONE view change: join reports arrive in round 1,
    # the vote-delivery hop is round 2, plus the batching window
    assert out["virtual_ms"] == 2 * 1000 + 100
    assert _wave_record(out) == _wave_record(jax_join_wave.run_size(300, 0.01, seed=7))


def test_join_wave_record_equals_jax_at_a_wave_count():
    port_wall, port_rec = port_join_wave.timed_wave(1000, 25, seed=3, device="cpu")
    _, jax_rec = jax_join_wave.timed_wave(1000, 25, seed=3)
    assert port_wall > 0
    for field in ("added", "cut", "removed"):
        assert sorted(int(x) for x in getattr(port_rec, field)) == \
            sorted(int(x) for x in getattr(jax_rec, field))
    for field in ("configuration_id", "virtual_time_ms", "membership_size"):
        assert int(getattr(port_rec, field)) == int(getattr(jax_rec, field))


def test_join_wave_main_prints_a_line_a_size(capsys):
    port_join_wave.main(["--sizes", "200,400", "--wave", "4", "--device", "cpu"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [(line["n"], line["wave"], line["admitted_ok"]) for line in lines] == \
        [(200, 4, True), (400, 4, True)]
    assert [_wave_record(line) for line in lines] == \
        [_wave_record(jax_join_wave.run_size(n, 4, seed=42)) for n in (200, 400)]


def test_message_load_strategies_agree_on_protocol_work():
    uni = port_message_load.run_strategy("unicast", n=16, crash=1, seed=5)
    gos = port_message_load.run_strategy("gossip", n=16, crash=1, seed=5)
    # the dissemination fabric must not change the protocol work performed
    assert uni["per_type_totals"]["BatchedAlertMessage"] == \
        gos["per_type_totals"]["BatchedAlertMessage"]
    assert uni["per_type_totals"]["FastRoundPhase2bMessage"] == \
        gos["per_type_totals"]["FastRoundPhase2bMessage"]
    # unicast delivers each broadcast exactly once per process; gossip pays
    # the epidemic redundancy on top
    assert "GossipEnvelope" not in uni["per_type_totals"]
    assert gos["per_type_totals"]["GossipEnvelope"] > 0
    assert gos["mean_msgs"] > uni["mean_msgs"]
    assert uni == jax_message_load.run_strategy("unicast", n=16, crash=1, seed=5)
    assert gos == jax_message_load.run_strategy("gossip", n=16, crash=1, seed=5)


@pytest.mark.parametrize("strategy,mode", [("gossip-pushpull", "crash"),
                                           ("unicast", "one-way")])
def test_message_load_line_equals_jax(strategy, mode):
    got = port_message_load.run_strategy(strategy, n=12, crash=1, seed=11, failure_mode=mode)
    want = jax_message_load.run_strategy(strategy, n=12, crash=1, seed=11, failure_mode=mode)
    assert got == want
    assert got["crashed"] == 1 and got["failure_mode"] == mode


def test_message_load_main_prints_three_strategies(capsys):
    port_message_load.main(["--n", "8", "--crash", "1", "--seed", "4"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [line["strategy"] for line in lines] == ["unicast", "gossip", "gossip-pushpull"]
    assert lines == [jax_message_load.run_strategy(s, 8, 1, 4)
                     for s in ("unicast", "gossip", "gossip-pushpull")]


# --------------------------------------------------------------------- #
# The timing-conflict regime (tests/test_timing_conflicts.py's twins)
# --------------------------------------------------------------------- #

def _outcome(conflict, rec, sim):
    """A trial's outcome as comparable data."""
    return {
        "conflict": conflict,
        "record": None if rec is None else {
            "cut": sorted(int(c) for c in rec.cut),
            "configuration_id": int(rec.configuration_id),
            "virtual_time_ms": int(rec.virtual_time_ms),
            "via_classic_round": bool(rec.via_classic_round),
        },
        "members": [int(m) for m in np.flatnonzero(sim.active)],
    }


def trial_twins(seed, victims, skew, fallback=None):
    jax_out = jax_fig11.run_trial(seed, victims, skew=skew, fallback=fallback)
    port_out = port_fig11.run_trial(seed, victims, skew=skew, fallback=fallback,
                                    device="cpu")
    assert _outcome(*port_out) == _outcome(*jax_out)
    return port_out, jax_out


def test_no_conflicts_without_latency_heterogeneity():
    """Uniform timing never diverges: same stream, same crossings, one
    proposal, fast-path decision."""
    for seed, victims in TRIALS:
        (conflict, rec, _), _ = trial_twins(seed, victims, skew=0)
        assert not conflict
        assert rec is not None and not rec.via_classic_round
        assert sorted(rec.cut) == sorted(victims)


def test_latency_heterogeneity_induces_conflicting_proposals():
    """With a 9-sub-round skew (under one FD interval), every trial makes the
    two delivery classes cross H on different snapshots and propose different
    cuts; the 50/50 vote split blocks the 3/4 quorum."""
    for seed, victims in TRIALS:
        (conflict, rec, _), _ = trial_twins(seed, victims, skew=9)
        assert conflict, f"no divergence for seed={seed} victims={victims}"
        assert rec is None, "conflicting 32/32 split must stall the fast round"


def test_conflicts_resolve_through_classic_fallback():
    """The fallback converges on every timing conflict: the coordinator rule
    picks one of the proposed cuts, and any residual victim is removed by a
    follow-up view change -- final membership is exact, and the same on
    both packages."""
    for seed, victims in TRIALS:
        (conflict, stalled, sim), (_, _, jax_sim) = trial_twins(seed, victims, skew=9)
        assert conflict and stalled is None
        rec = sim.run_until_decision(
            max_rounds=100, batch=40, classic_fallback_after_rounds=20
        )
        jax_rec = jax_sim.run_until_decision(
            max_rounds=100, batch=40, classic_fallback_after_rounds=20
        )
        assert rec is not None and rec.via_classic_round
        assert set(rec.cut) <= set(victims)  # a proposed value, never invented
        assert _outcome(False, rec, sim) == _outcome(False, jax_rec, jax_sim)
        port_fig11.drive_to_convergence(sim, 62)
        jax_fig11.drive_to_convergence(jax_sim, 62)
        assert not sim.active[np.array(victims)].any()
        assert sim.active.tolist() == jax_sim.active.tolist()
        assert sim.configuration_id() == jax_sim.configuration_id()


def test_conflict_rate_grows_with_stagger():
    """The experiment behind the BASELINE.md row: conflict probability is
    monotone in the latency skew (0 at skew 0, 1 at skew 9 for this grid)."""
    rates = {}
    for skew in (0, 5, 9):
        conflicts = 0
        for seed, victims in TRIALS:
            (conflict, _, _), _ = trial_twins(seed, victims, skew=skew)
            conflicts += conflict
        rates[skew] = conflicts / len(TRIALS)
    assert rates[0] == 0.0
    assert rates[0] <= rates[5] <= rates[9]
    assert rates[9] == 1.0


def test_sweep_main_prints_the_table(capsys, monkeypatch):
    """``main`` on a cut grid (one seed, one victim pair) prints the table's
    rows, each trial driven to convergence."""
    monkeypatch.setattr(port_fig11, "SEEDS", range(1))
    monkeypatch.setattr(port_fig11, "VICTIM_PAIRS", ([5, 40],))
    port_fig11.main(["--skews", "0,9", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out == ["| latency skew (sub-rounds) | 0 | 9 |",
                   "skew 0: conflicts 0/1, stalls 0/1, all converged",
                   "skew 9: conflicts 1/1, stalls 1/1, all converged",
                   "| conflict rate | 0/1 | 1/1 |",
                   "| fast round stalled | 0/1 | 1/1 |"]
