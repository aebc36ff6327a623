"""The PyTorch port on an NVIDIA GPU against the same port on the CPU (which
the other test_torch_* files hold against the JAX package), every state
field. Exact equality: the engine is integer and boolean only.

Every test here needs the card and skips without one. This file imports
neither JAX nor rapid_tpu, so it also runs where JAX is not installed; there,
skip tests/conftest.py (which sets JAX up). With the kernel tests:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_fd_phase.py tests/test_torch_fd_fused.py \
        tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from rapid_tpu_torch.shard.engine import gather_state, make_mesh
from rapid_tpu_torch.sim import engine
from rapid_tpu_torch.sim.driver import Simulator

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _scenarios():
    return {
        "crash": lambda s: s.crash(np.arange(0, 1000, 97)),
        "ingress_loss_1.0": lambda s: s.ingress_loss(np.arange(5, 1000, 89), 1.0),
        "join_and_leave": lambda s: (s.request_joins(np.arange(990, 1000)),
                                     s.leave(np.array([17, 400]))),
    }


@pytest.mark.parametrize("name", list(_scenarios()))
def test_simulator_on_card_matches_cpu(cuda_device, name):
    records, states = [], []
    for device in ("cpu", cuda_device):
        sim = Simulator(990, capacity=1000, seed=5, device=device)
        _scenarios()[name](sim)
        rec = sim.run_until_decision(max_rounds=32, batch=16)
        assert rec is not None
        records.append((rec.cut.tolist(), rec.configuration_id, rec.virtual_time_ms))
        states.append(engine.state_to_numpy(sim.state))
    assert records[0] == records[1]
    for field, value in states[0].items():
        np.testing.assert_array_equal(states[1][field], value, err_msg=field)


@pytest.mark.parametrize("name", list(_scenarios()))
def test_sharded_simulator_on_card_matches_cpu(cuda_device, name):
    """A mesh of 8 shards, all on the card, against the same mesh on the
    CPU: a dispatch that does not decide, then the decision; every field."""
    records, states = [], []
    for device in ("cpu", cuda_device):
        sim = Simulator(990, capacity=1000, seed=5, mesh=make_mesh(devices=[device] * 8))
        _scenarios()[name](sim)
        rec = sim.run_until_decision(max_rounds=1, batch=1)
        states.append(engine.state_to_numpy(gather_state(sim.state)))
        rec = rec or sim.run_until_decision(max_rounds=32, batch=16)
        assert rec is not None
        records.append((rec.cut.tolist(), rec.configuration_id, rec.virtual_time_ms))
        states.append(engine.state_to_numpy(gather_state(sim.state)))
    assert records[0] == records[1]
    for field, value in states[0].items():
        np.testing.assert_array_equal(states[2][field], value, err_msg=field)
    for field, value in states[1].items():
        np.testing.assert_array_equal(states[3][field], value, err_msg=field)


def test_scan_path_state_on_card_matches_cpu(cuda_device):
    """Every field after a lossy scan (drop probability 1.0, so the two
    generators' draws cannot matter) and the packed words."""
    config = engine.SimConfig(capacity=512, groups=2, fd_gray_confirm=3)
    outs = []
    for device in ("cpu", cuda_device):
        sim = Simulator(500, capacity=512, config=config, seed=2, device=device)
        sim.set_delivery_groups(np.arange(512, dtype=np.int32) % 2)
        sim.ingress_loss(np.array([3, 77]), 1.0)
        sim.crash(np.array([100]))
        sim.drop_broadcasts(1, np.array([9]))
        state = engine.run_rounds_const(
            config, sim.state, sim._const_inputs(None), 14, True, sim._generator
        )
        outs.append((engine.state_to_numpy(state),
                     engine.pack_decision(config, state).cpu().numpy()))
    np.testing.assert_array_equal(outs[1][1], outs[0][1])
    for field, value in outs[0][0].items():
        np.testing.assert_array_equal(outs[1][0][field], value, err_msg=field)


def _decide_in_window(sim, name):
    from rapid_tpu_torch.runtime import jitwatch

    with jitwatch.timed_window(name):
        rec = sim.run_until_decision(max_rounds=16, batch=16)
    assert rec is not None and not jitwatch.consume_violations()
    return rec.cut.tolist(), rec.configuration_id, rec.virtual_time_ms, rec.membership_size


@pytest.mark.parametrize("branch", ["closed_form", "scan"])
def test_speculation_and_timed_window_on_card(cuda_device, monkeypatch, branch):
    """At 1000 members on the card, each decision inside a timed window
    (sync debug mode "error": only the audited seams may sync): speculation
    on and off give identical records, equal to the CPU's, with both hits
    only when on; the speculation worker alone in a timed window, which no
    seam lifts while it runs; then a decision with metrics, tracer and
    profiling (every dispatch sampled) on."""
    from rapid_tpu_torch.runtime import jitwatch
    from rapid_tpu_torch.settings import ProfilingSettings

    monkeypatch.setenv("RAPID_JITWATCH", "1")
    victims = np.arange(0, 1000, 97)

    def fresh(speculate, device, profiled=False):
        sim = Simulator(1000, seed=5, speculate=speculate, device=device).ready()
        if profiled:
            sim.enable_profiling(ProfilingSettings(enabled=True, sample_every_dispatches=1))
        sim.crash(victims)
        if branch == "scan":
            sim.ingress_loss(victims, 1.0)
        return sim

    want = fresh(True, "cpu").run_until_decision(max_rounds=16, batch=16)
    want = (want.cut.tolist(), want.configuration_id, want.virtual_time_ms,
            want.membership_size)
    jitwatch.reset()
    for speculate in (True, False):
        sim = fresh(speculate, cuda_device)
        assert _decide_in_window(sim, f"{branch} {speculate}") == want
        hits = (sim.metrics.get("speculation_hits_config_id"),
                sim.metrics.get("speculation_hits_fresh_state"))
        assert hits == ((1, 1) if speculate else (0, 0))
    sim = fresh(True, cuda_device)
    with jitwatch.timed_window(f"{branch} speculation worker"):
        sim._speculate_view_change().join()
    assert sim._spec is not None and not jitwatch.consume_violations()
    sim = fresh(True, cuda_device, profiled=True)
    assert _decide_in_window(sim, f"{branch} profiled") == want
    assert sim._profiler.samples == 1
    counts = jitwatch.sync_counts()
    assert counts["sim.decision_words"] == 3 and counts["sim.profile.sample"] == 3


def test_profiling_prefixes_on_card_match_cpu(cuda_device):
    """``step_fd_scan`` and ``step_cut_detector`` on the card (through
    ``fd_phase_fused``) against the CPU, every field, mid-decision."""
    outs = []
    for device in ("cpu", cuda_device):
        sim = Simulator(1000, seed=8, device=device)
        sim.crash(np.arange(3, 1000, 101))
        sim.ingress_loss(np.arange(5, 1000, 89), 1.0)
        inputs = sim._const_inputs(None)
        state = engine.run_rounds_const(sim.config, sim.state, inputs, 9, True, sim._generator)
        partial, down = engine.step_fd_scan(sim.config, state, inputs, True, sim._generator)
        cut = engine.step_cut_detector(sim.config, state, inputs, True, sim._generator)
        outs.append((engine.state_to_numpy(partial), down.cpu().numpy(),
                     engine.state_to_numpy(cut)))
    np.testing.assert_array_equal(outs[1][1], outs[0][1])
    for i in (0, 2):
        for field, value in outs[0][i].items():
            np.testing.assert_array_equal(outs[1][i][field], value, err_msg=field)
    assert outs[0][2]["announced"].any()


def test_bridged_join_crash_and_leave_on_card_match_cpu(cuda_device):
    """``chip_smoke.py``'s bridge phase at 1000 members (the port's default
    protocol, a scripted member's join, a crash in the closed form and one
    under ingress loss 1.0, its leave, then the join and crash on a mesh of
    4 shards) on the card and on the CPU: the same records and
    configuration ids, each equal to a plain simulator's."""
    import chip_smoke

    runs = [chip_smoke.bridge_sequence(1000, device, [device] * 4)
            for device in ("cpu", cuda_device)]
    keys = ("name", "cut", "configuration_id", "plain_configuration_id", "virtual_time_ms",
            "members_before")
    assert [[p[k] for k in keys] for p in runs[1]["pumps"]] == [
        [p[k] for k in keys] for p in runs[0]["pumps"]]
    scan = runs[1]["pumps"][2]
    assert scan["name"] == "crash, scan" and scan["launches"]["fd_phase_fused"] > 0


def test_gateway_join_crash_and_leave_on_card_match_cpu(cuda_device, monkeypatch):
    """``chip_smoke.py``'s gateway phase at 1000 virtual members (the port's
    ``SwarmGateway`` and a member in its own OS process over TCP: its join,
    a closed-form crash and one under ingress loss 1.0 run on the gateway's
    protocol thread, its leave) on the card and on the CPU: the same cuts,
    virtual times (the leave's aside) and sizes; in each run every configuration id equal to the
    member's own and to a plain simulator's (the ids differ between runs
    only by the member's port until it leaves)."""
    import chip_smoke

    monkeypatch.setenv("RAPID_JITWATCH", "1")  # the labels the debug mode's count is held to
    runs = [chip_smoke.gateway_sequence(1000, device) for device in ("cpu", cuda_device)]
    # the leave's virtual time counts the idle pumps that ran while the loss
    # stayed armed, which wall time decides; the steps before are exact
    keys = ("name", "cut", "virtual_time_ms", "members_before")
    assert [[r[k] for k in keys] for r in runs[1]["steps"][:3]] == [
        [r[k] for k in keys] for r in runs[0]["steps"][:3]]
    assert [r["cut"] for r in runs[1]["steps"]] == [r["cut"] for r in runs[0]["steps"]]
    for run in runs:
        for row in run["steps"]:
            assert row["configuration_id"] == row["plain_configuration_id"], row["name"]
            if "member_configuration_id" in row:
                assert row["member_configuration_id"] == row["configuration_id"], row["name"]
    assert runs[0]["steps"][-1]["configuration_id"] == runs[1]["steps"][-1]["configuration_id"]
    scan = runs[1]["steps"][2]
    assert scan["name"] == "crash, scan" and scan["pump_launches"]["fd_phase_fused"] > 0
    for row in runs[1]["steps"]:
        assert row["counted_syncs"] == sum(row["syncs"].values()), row["name"]
