"""The port's profiling plane: the engine's phase prefixes against the JAX
engine's field by field, the PhaseProfiler's cadence, kill switch and
attribution (tests/test_profiling.py's calls), invisibility (records with
profiling on equal those with it off, under lossy traffic too), and the
runtime watchdog's audited syncs (``runtime/jitwatch.py``)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapid_tpu.sim import engine as jeng
from rapid_tpu.sim.driver import Simulator as JaxSimulator
from rapid_tpu_torch.observability import Metrics, json_snapshot
from rapid_tpu_torch.profiling import DEVICE_PHASES, PHASES, MetricsHistory, PhaseProfiler
from rapid_tpu_torch.runtime import jitwatch
from rapid_tpu_torch.settings import ProfilingSettings
from rapid_tpu_torch.shard.engine import make_mesh
from rapid_tpu_torch.sim import engine as teng
from rapid_tpu_torch.sim.driver import Simulator
from test_torch_engine import (
    BASE,
    _assert_states_equal,
    _port_config,
    _port_inputs,
    _port_state,
)
from tools.perfscope import extract_phases

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py

POLICIES = {
    "cumulative": {},
    "windowed": {"fd_policy": "windowed", "fd_window": 4, "fd_window_threshold": 0.5},
}


def _mid_run(policy, loss, rounds_before):
    """A JAX state ``rounds_before`` rounds into a crash of two members, and
    the round's fault plane: no random loss (``loss`` 0), or ingress loss
    ``loss`` on two more, drawn from the state's key in both packages."""
    config = jeng.SimConfig(**{**BASE, **POLICIES[policy]})
    sim = JaxSimulator(28, capacity=32, config=config, seed=7, speculate=False)
    sim.crash(np.array([6, 21]))
    drop_prob = np.zeros(32, np.float32)
    drop_prob[[2, 13]] = loss
    inputs = jeng.const_inputs(config, sim.alive, drop_prob=drop_prob)
    state = sim.state
    if rounds_before:
        state = jeng.run_rounds_const(config, state, inputs, rounds_before, loss > 0)
    return config, state, inputs


LOSSES = dict(argvalues=[0.0, 1.0, 0.5], ids=["no_loss", "loss_1.0", "loss_0.5"])


@pytest.mark.parametrize("rounds_before", [0, 3, 9])
@pytest.mark.parametrize("loss", **LOSSES)
@pytest.mark.parametrize("policy", list(POLICIES))
def test_prefixes_match_jax(policy, loss, rounds_before):
    config, state, inputs = _mid_run(policy, loss, rounds_before)
    port_config = _port_config(config)
    port_state = _port_state(config, state)
    port_inputs = _port_inputs(config, inputs)
    random_loss = loss > 0

    want_partial, want_down = jeng.step_fd_scan(config, state, inputs, random_loss)
    got_partial, got_down = teng.step_fd_scan(port_config, port_state, port_inputs, random_loss)
    _assert_states_equal(want_partial, got_partial)
    np.testing.assert_array_equal(got_down.numpy(), np.asarray(want_down))

    want = jeng.step_cut_detector(config, state, inputs, random_loss)
    got = teng.step_cut_detector(port_config, port_state, port_inputs, random_loss)
    _assert_states_equal(want, got)
    if rounds_before == 9:
        assert bool(want.announced.any()), "the cut detector should have announced"
    # the prefixes left their arguments as they came
    _assert_states_equal(state, port_state)


@pytest.mark.parametrize("loss", **LOSSES)
def test_run_rounds_matches_jax(loss):
    """``run_rounds`` over stacked per-round inputs: a flip-flop of the
    crashed pair across 12 rounds."""
    config, state, inputs = _mid_run("cumulative", loss, 0)
    alive = np.stack([np.asarray(inputs.alive)] * 12)
    alive[4:7, [6, 21]] = True  # revived for three rounds
    stacked = dataclasses.replace(
        jax.tree_util.tree_map(lambda x: jnp.stack([x] * 12), inputs), alive=jnp.asarray(alive))
    want = jeng.run_rounds(config, state, stacked)
    got = teng.run_rounds(_port_config(config), _port_state(config, state),
                          _port_inputs(config, stacked), True)
    _assert_states_equal(want, got)
    assert bool(want.decided)


def test_step_fd_scan_draws_from_the_generator_it_is_given():
    """The prefix's generator is the state's key: it draws from it, leaves
    it where it was and returns it split, so two prefixes of one state draw
    alike, and a state with another key draws otherwise."""
    config = teng.SimConfig(capacity=16, k=4, h=3, l=1, fd_threshold=2)
    state = teng.initial_state(config, _cluster(config), np.ones(16, bool), seed=5,
                               device="cpu")
    drop = np.zeros(16, np.float32)
    drop[3] = 0.5
    inputs = teng.const_inputs(config, np.ones(16, bool), drop_prob=drop, device="cpu")
    key = state.rng_key.clone()
    first = teng.step_fd_scan(config, state, inputs, True)
    again = teng.step_fd_scan(config, state, inputs, True)
    assert torch.equal(first[0].fd_fail, again[0].fd_fail)
    assert torch.equal(state.rng_key, key)
    assert torch.equal(first[0].rng_key, again[0].rng_key)
    assert not torch.equal(first[0].rng_key, key)
    draws = set()
    for seed in range(8):
        other = dataclasses.replace(state, rng_key=teng.threefry.prng_key(seed))
        draws.add(teng.step_fd_scan(config, other, inputs, True)[0].fd_fail.numpy().tobytes())
    assert len(draws) > 1, "the draw follows the key"


def _cluster(config):
    from rapid_tpu_torch.sim.topology import VirtualCluster

    return VirtualCluster.synthesize(config.capacity, config.k, seed=0)


# -- the PhaseProfiler --------------------------------------------------------


def _profiled_sim(n, seed, sample_every=1, **kw):
    sim = Simulator(n, seed=seed, metrics=Metrics(), device="cpu", **kw).ready()
    prof = sim.enable_profiling(ProfilingSettings(enabled=True,
                                                  sample_every_dispatches=sample_every))
    assert prof is not None and prof.enabled
    return sim, prof


def test_sampling_cadence_is_one_of_n():
    prof = PhaseProfiler(Metrics(), ProfilingSettings(enabled=True, sample_every_dispatches=4))
    pattern = [prof.should_sample() for _ in range(8)]
    assert pattern == [True, False, False, False, True, False, False, False]


def test_kill_switch_disables_everything():
    prof = PhaseProfiler(Metrics(), ProfilingSettings(enabled=False))
    assert not prof.enabled
    assert not any(prof.should_sample() for _ in range(32))
    sim = Simulator(64, seed=3, metrics=Metrics(), device="cpu")
    assert sim.enable_profiling(ProfilingSettings(enabled=False)) is None
    assert sim._profiler is None


def test_shadow_sample_attributes_the_phase_pipeline():
    """One shadow sample yields every device phase, non-negative, in the
    registry shape tools/perfscope.py parses."""
    sim, prof = _profiled_sim(128, seed=7)
    inputs = sim._const_inputs(None)
    s = prof.sample(sim.config, sim.state, inputs, False, repeats=2)
    assert set(s) == set(DEVICE_PHASES) | {"step_ms"}
    assert all(v >= 0.0 for v in s.values())
    phases, step = extract_phases(json_snapshot(sim.metrics))
    assert set(phases) >= set(DEVICE_PHASES)
    assert step is not None and step[0] >= 1
    totals = prof.attribution()
    assert set(totals) == set(PHASES)
    assert totals["fd_scan"] == pytest.approx(phases["fd_scan"][1])


def test_dispatch_loop_samples_and_times_host_transfer():
    """The decision loop records shadow samples, the real decision-fetch
    leg and history snapshots, and still decides the identical cut."""
    sim, prof = _profiled_sim(64, seed=5)
    sim.crash(np.array([3]))
    record = sim.run_until_decision(max_rounds=40)
    assert record is not None and set(record.cut.tolist()) == {3}
    assert prof.samples >= 1
    assert prof.attribution()["host_transfer"] > 0.0
    assert len(prof.history) >= 1
    assert sim.metrics.get("profile.samples") == prof.samples
    assert isinstance(prof.history, MetricsHistory)


def _lossy_run(profiled, mesh=None):
    kw = {"mesh": mesh} if mesh is not None else {"device": "cpu"}
    sim = Simulator(40, seed=11, metrics=Metrics(), **kw)
    if profiled:
        sim.enable_profiling(ProfilingSettings(enabled=True, sample_every_dispatches=1))
    sim.ingress_loss(np.array([4, 19]), 0.6)
    recs = [sim.run_until_decision(max_rounds=64, batch=4)]
    sim.crash(np.array([30]))
    recs.append(sim.run_until_decision(max_rounds=64, batch=4))
    assert all(r is not None for r in recs)
    return ([(r.cut.tolist(), r.configuration_id, r.virtual_time_ms) for r in recs]
            + [sim.metrics.get("rounds"), sim.state.rng_key.tolist()], sim)


@pytest.mark.parametrize("mesh_shards", [0, 4])
def test_records_with_profiling_equal_records_without(mesh_shards):
    """Under loss 0.6 every record depends on every draw: the shadow
    prefixes read the state's key and throw the key they split away, so
    profiling on and off decide alike, round for round, and end on the same
    key. On a mesh only the history ring and the host-transfer phase are
    recorded."""
    mesh = make_mesh(devices=["cpu"] * mesh_shards) if mesh_shards else None
    plain, _ = _lossy_run(False, mesh)
    profiled, sim = _lossy_run(True, mesh)
    assert profiled == plain
    prof = sim._profiler
    assert (prof.samples > 0) == (mesh is None)
    assert prof.attribution()["host_transfer"] > 0.0 and len(prof.history) >= 1


# -- the runtime watchdog -----------------------------------------------------


@pytest.fixture
def watched(monkeypatch):
    monkeypatch.setenv("RAPID_JITWATCH", "1")
    jitwatch.reset()
    yield jitwatch
    jitwatch.reset()


def test_decision_words_fetched_once_per_dispatch(watched):
    sim = Simulator(32, seed=4, device="cpu")
    sim.crash(np.array([7, 8]))
    assert sim.run_until_decision(max_rounds=40, batch=4) is not None
    sim.ingress_loss(np.array([2]), 1.0)
    assert sim.run_until_decision(max_rounds=40, batch=8) is not None
    counts = watched.sync_counts()
    assert counts["sim.decision_words"] == sim.metrics.get("device_dispatches") >= 5
    assert set(counts) == {"sim.decision_words"}


def test_seams_count_and_fetch_keeps_structure(watched):
    tree = {"a": torch.arange(3), "b": (torch.ones(2, dtype=torch.bool),)}
    out = watched.fetch("test.tree", tree)
    assert isinstance(out["a"], np.ndarray) and out["a"].tolist() == [0, 1, 2]
    assert out["b"][0].dtype == np.bool_
    watched.drain("test.drain", tree)
    with watched.host_transfer("test.upload"):
        pass
    assert watched.sync_counts() == {"test.tree": 1, "test.drain": 1, "test.upload": 1}


def test_kernel_build_inside_a_timed_window_is_a_violation(watched):
    watched.record_compile("outside", 0.5, "nvcc")
    with pytest.raises(watched.JitwatchViolation):
        with watched.timed_window("steady"):
            watched.record_compile("inside", 0.1, "load")
    assert len(watched.consume_violations()) == 1
    assert watched.compile_count() == 2 and watched.compile_count("inside") == 1
    assert watched.stats()["compiles"] == 2
    assert [e.steady for e in watched.compile_events()] == [False, True]


def test_watchdog_off_records_nothing(monkeypatch):
    monkeypatch.setenv("RAPID_JITWATCH", "0")
    jitwatch.reset()
    out = jitwatch.fetch("test.off", torch.arange(2))
    jitwatch.record_compile("off", 1.0, "nvcc")
    with jitwatch.timed_window("off"):
        jitwatch.record_compile("off", 1.0, "nvcc")
    assert out.tolist() == [0, 1]
    assert jitwatch.sync_counts() == {} and jitwatch.compile_count() == 0


def test_profiler_snapshot_is_json():
    sim, prof = _profiled_sim(32, seed=2)
    sim.crash(np.array([1]))
    assert sim.run_until_decision(max_rounds=40) is not None
    snap = json.loads(json.dumps(json_snapshot(sim.metrics, sim.tracer)))
    assert snap["counters"]["profile.samples"] == prof.samples
    assert "device_rounds" in snap["spans"]
