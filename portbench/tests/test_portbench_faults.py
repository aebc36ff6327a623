"""A run with the timed path broken underneath comes out not correct, for
each fault the cells can have: a step that returns its state unchanged;
half of a burst's loss left out; an answer altered where it is produced
(the configuration id, and the decided cut). The harness runs as on the
card, on the CPU at a tiny size."""

import numpy as np
import pytest

from portbench import harness
from portbench.tests.conftest import tiny_cell
from rapid_tpu_torch.sim import driver as sim_driver


def _run(mix):
    return harness.run_cell(tiny_cell(mix), 2**31 + 5, 1.5, False, lambda: 0.0, device="cpu")


def test_sound_run_is_correct(mix):
    assert _run(mix)["correct"] is True


def test_state_unchanged(mix, monkeypatch):
    monkeypatch.setattr(sim_driver, "run_rounds_const", lambda config, state, *a, **k: state)
    monkeypatch.setattr(sim_driver, "run_until_decided_const", lambda config, state, *a, **k: state)
    out = _run(mix)
    assert out["correct"] is False and out["failed"] > 0


def test_half_the_burst_left_out(monkeypatch):
    real = sim_driver.Simulator.ingress_loss

    def half(self, node_ids, probability):
        node_ids = np.atleast_1d(node_ids)
        return real(self, node_ids[: max(1, len(node_ids) // 2)] if probability > 0 else node_ids,
                    probability)

    monkeypatch.setattr(sim_driver.Simulator, "ingress_loss", half)
    out = _run("lossy-burst")
    assert out["correct"] is False


def test_config_id_altered(mix, monkeypatch):
    real = sim_driver.Simulator._fold_configuration_id
    monkeypatch.setattr(sim_driver.Simulator, "_fold_configuration_id",
                        lambda self, active: real(self, active) ^ 1)
    out = _run(mix)
    assert out["correct"] is False
    assert out["checks"]["config_id_mismatch"]["value"] > 0


def test_cut_altered(mix, monkeypatch):
    real = sim_driver.unpack_decision

    def drop_one(config, words):
        decided, announced, announced_round, proposal, group, decided_round, round_ = real(
            config, words)
        proposal = proposal.copy()
        row = proposal[int(group)]
        if decided and row.sum() > 1:
            row[np.flatnonzero(row)[0]] = False
        return decided, announced, announced_round, proposal, group, decided_round, round_

    monkeypatch.setattr(sim_driver, "unpack_decision", drop_one)
    out = _run(mix)
    assert out["correct"] is False
