"""The PyTorch port's round engine against the JAX engine: both start from the
same state (carried across with ``state_from_numpy``) under the same fault
plane, made with numpy from a seed, and every ``SimState`` field must come out
equal, dtype included, the PRNG key among them. The engine is integer and
boolean only, and its random ingress loss draws JAX's own threefry bits, so
the tolerance is zero at every loss probability."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapid_tpu.sim import engine as jeng
from rapid_tpu.sim.driver import Simulator as JaxSimulator
from rapid_tpu.sim.topology import VirtualCluster
from rapid_tpu_torch.sim import engine as teng
from rapid_tpu_torch.sim import threefry
from rapid_tpu_torch.sim.topology import VirtualCluster as PortCluster

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py

BASE = dict(capacity=32, k=5, h=4, l=2, fd_threshold=3)


def _port_config(config):
    return teng.SimConfig(**dataclasses.asdict(config))


def _port_state(config, state):
    arrays = {name: np.asarray(getattr(state, name)) for name in state.__dataclass_fields__}
    return teng.state_from_numpy(_port_config(config), arrays, device="cpu")


def _port_inputs(config, inputs):
    return teng.RoundInputs(**{
        name: torch.from_numpy(np.array(getattr(inputs, name)))
        for name in inputs.__dataclass_fields__
    })


def _assert_states_equal(jax_state, port_state):
    got = teng.state_to_numpy(port_state)
    assert set(got) == set(jax_state.__dataclass_fields__)
    for name, value in got.items():
        want = np.asarray(getattr(jax_state, name))
        assert value.dtype == want.dtype, name
        np.testing.assert_array_equal(value, want, err_msg=f"field {name} diverged")


# --------------------------------------------------------------------- #
# Scenarios: (config overrides, fault-plane setup on a JAX Simulator)
# --------------------------------------------------------------------- #


def _crash(sim):
    sim.crash(np.array([6, 21]))
    return {}


def _one_way(sim):
    sim.one_way_ingress_partition(np.array([4, 9]))
    return {"probe_drop": sim._probe_drop_mask()}


def _down_reports(sim):
    sim.crash(np.array([10]))
    sim.leave(np.array([3, 28]))
    return {"down_reports": np.asarray(sim._down_reports())}


def _join_reports(sim):
    sim.request_joins(np.array([28, 29]))
    return {"join_reports": sim._arm_pending_joins()}


def _groups_deliver(sim):
    sim.set_delivery_groups(np.arange(32, dtype=np.int32) % 2)
    sim.crash(np.array([11]))
    sim.drop_broadcasts(1, np.array([5, 6, 7]))
    return {"deliver": sim._deliver}


def _delivery_delay(sim):
    sim.set_delivery_groups(np.arange(32, dtype=np.int32) % 2)
    sim.crash(np.array([11, 12]))
    sim.delay_broadcasts(1, np.arange(0, 32, 3), 2)
    sim.delay_broadcasts(0, np.arange(1, 32, 5), 1)
    sim.drop_broadcasts(0, np.array([9]))
    return {"deliver": sim._deliver, "deliver_delay": sim._deliver_delay}


SCENARIOS = {
    "crash": ({}, _crash, 28),
    "one_way_partition": ({}, _one_way, 28),
    "down_reports": ({}, _down_reports, 32),
    "join_reports": ({}, _join_reports, 28),
    "groups_deliver": ({"groups": 2}, _groups_deliver, 32),
    "delivery_delay": ({"groups": 2, "max_delivery_delay": 2}, _delivery_delay, 32),
    "staggered_phases": ({"rounds_per_interval": 4}, _crash, 32),
    "gray_streak": ({"fd_gray_confirm": 3, "fd_threshold": 8}, _crash, 32),
}


def _scenario(name):
    overrides, setup, n_nodes = SCENARIOS[name]
    config = jeng.SimConfig(**{**BASE, **overrides})
    sim = JaxSimulator(n_nodes, capacity=32, config=config, seed=7, speculate=False)
    state = sim.state
    if config.fd_gray_confirm:
        # healthy rounds first, so edges establish the history the gray
        # streak alert requires (fd_ok >= fd_gray_warmup)
        state = jeng.run_rounds_const(config, state, jeng.const_inputs(config, sim.alive), 4, False)
        sim.state = state
    extra = setup(sim)
    return config, sim.state, jeng.const_inputs(config, sim.alive, **extra)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_run_rounds_const_matches_jax(name):
    config, state, inputs = _scenario(name)
    want = jeng.run_rounds_const(config, state, inputs, 14, False)
    got = teng.run_rounds_const(
        _port_config(config), _port_state(config, state), _port_inputs(config, inputs),
        14, False,
    )
    _assert_states_equal(want, got)
    if name != "join_reports":
        assert bool(want.decided), "scenario should reach a decision"


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_run_until_decided_const_matches_jax(name):
    config, state, inputs = _scenario(name)
    uniform = bool(np.asarray(inputs.deliver).all())
    want = jeng.run_until_decided_const(config, state, inputs, jnp.int32(14), uniform)
    got = teng.run_until_decided_const(
        _port_config(config), _port_state(config, state), _port_inputs(config, inputs),
        14, uniform,
    )
    _assert_states_equal(want, got)


@pytest.mark.parametrize("budget", [3, 16])
def test_run_until_decided_const_stop_when_announced_matches_jax(budget):
    config, state, inputs = _scenario("crash")
    want = jeng.run_until_decided_const(config, state, inputs, jnp.int32(budget), True, True)
    got = teng.run_until_decided_const(
        _port_config(config), _port_state(config, state), _port_inputs(config, inputs),
        budget, True, True,
    )
    _assert_states_equal(want, got)
    if budget == 16:
        assert bool(want.announced.any()) and not bool(want.decided)


def test_run_until_decided_const_resumes_across_dispatches():
    """Flip-flop between dispatches: the closed form resumes from the FD state
    it reconstructed, in both engines alike."""
    config = jeng.SimConfig(**{**BASE, "fd_threshold": 6})
    sim = JaxSimulator(32, config=config, seed=9, speculate=False)
    want, got = sim.state, _port_state(config, sim.state)
    victims = np.array([3, 17])
    for crash in (True, False, True, True):
        (sim.crash if crash else sim.revive)(victims)
        inputs = jeng.const_inputs(config, sim.alive)
        want = jeng.run_until_decided_const(config, want, inputs, jnp.int32(3), True)
        got = teng.run_until_decided_const(
            _port_config(config), got, _port_inputs(config, inputs), 3, True
        )
        _assert_states_equal(want, got)


def test_random_loss_at_probability_one_matches_jax():
    """At drop probability 1.0 every draw drops: the scan path matches the
    JAX scan in every field, the key split once a round included."""
    config, state, crash_inputs = _scenario("crash")
    drop_prob = np.zeros(32, np.float32)
    drop_prob[[2, 13]] = 1.0
    inputs = jeng.const_inputs(config, np.asarray(crash_inputs.alive), drop_prob=drop_prob)
    want = jeng.run_rounds_const(config, state, inputs, 14, True)
    got = teng.run_rounds_const(
        _port_config(config), _port_state(config, state), _port_inputs(config, inputs),
        14, True,
    )
    _assert_states_equal(want, got)
    assert bool(want.decided)


@pytest.mark.parametrize("name", ["crash", "groups_deliver", "staggered_phases", "gray_streak"])
@pytest.mark.parametrize("probability", [0.3, 0.5, 0.8])
def test_random_loss_below_probability_one_matches_jax(name, probability):
    """Below probability 1.0 the draw decides which probes drop: the port's
    threefry draw is JAX's, so every field, the key included, is equal after
    each of several dispatches of the scan."""
    config, state, base = _scenario(name)
    drop_prob = np.zeros(32, np.float32)
    drop_prob[[2, 13, 20]] = probability
    inputs = jeng.const_inputs(config, np.asarray(base.alive), drop_prob=drop_prob,
                               deliver=np.asarray(base.deliver))
    want, got = state, _port_state(config, state)
    for rounds in (5, 9, 16):
        want = jeng.run_rounds_const(config, want, inputs, rounds, True)
        got = teng.run_rounds_const(_port_config(config), got, _port_inputs(config, inputs),
                                    rounds, True)
        _assert_states_equal(want, got)


def test_step_matches_jax():
    config, state, inputs = _scenario("groups_deliver")
    want, got = state, _port_state(config, state)
    for _ in range(4):
        want = jeng.step(config, want, inputs, False)
        got = teng.step(_port_config(config), got, _port_inputs(config, inputs), False)
    _assert_states_equal(want, got)


@pytest.mark.parametrize("n_active", [0, 1, 2, 5, 200])
def test_device_initial_state_matches_jax(n_active):
    cluster = VirtualCluster.synthesize(256, 10, seed=4)
    rng = np.random.default_rng(n_active)
    active = np.zeros(256, dtype=bool)
    active[rng.choice(256, size=n_active, replace=False)] = True
    alive = active & (rng.random(256) < 0.9)
    group_of = np.zeros(256, np.int32)
    auto_vote = np.ones(256, bool)
    config = jeng.SimConfig(capacity=256)
    want = jeng.device_initial_state(
        config, jnp.asarray(cluster.ring_rank()), jnp.asarray(active),
        jnp.asarray(alive), jnp.asarray(group_of), jnp.asarray(auto_vote),
        jax.random.PRNGKey(n_active),
    )
    got = teng.device_initial_state(
        _port_config(config), torch.from_numpy(cluster.ring_rank()),
        torch.from_numpy(active), torch.from_numpy(alive),
        torch.from_numpy(group_of), torch.from_numpy(auto_vote),
        threefry.prng_key(n_active),
    )
    _assert_states_equal(want, got)


@pytest.mark.parametrize("name", ["crash", "groups_deliver", "join_reports"])
def test_pack_decision_words_match_jax(name):
    config, state, inputs = _scenario(name)
    state = jeng.run_rounds_const(config, state, inputs, 14, False)
    want = np.asarray(jeng.pack_decision(config, state))
    got = teng.pack_decision(_port_config(config), _port_state(config, state)).numpy()
    assert got.min() >= 0 and got.max() < 2**32
    np.testing.assert_array_equal(got.astype(np.uint32), want)
    unpacked = teng.unpack_decision(_port_config(config), got)
    for a, b in zip(unpacked, jeng.unpack_decision(config, want)):
        np.testing.assert_array_equal(a, b)


def test_state_numpy_round_trip_keeps_jax_dtypes():
    config, state, _ = _scenario("delivery_delay")
    arrays = {name: np.asarray(getattr(state, name)) for name in state.__dataclass_fields__}
    back = teng.state_to_numpy(_port_state(config, state))
    for name, value in back.items():
        assert value.dtype == arrays[name].dtype, name
        np.testing.assert_array_equal(value, arrays[name])
    assert _port_state(config, state).fd_hist.dtype == torch.int32


def test_const_inputs_and_initial_state_match_jax():
    config = jeng.SimConfig(**BASE)
    active = np.arange(32) < 30
    want = jeng.initial_state(config, VirtualCluster.synthesize(32, 5, seed=1), active)
    got = teng.initial_state(
        _port_config(config), PortCluster.synthesize(32, 5, seed=1), active, device="cpu"
    )
    _assert_states_equal(want, got)
    j_inputs = jeng.const_inputs(config, active)
    t_inputs = teng.const_inputs(_port_config(config), active, device="cpu")
    for name in j_inputs.__dataclass_fields__:
        np.testing.assert_array_equal(
            getattr(t_inputs, name).numpy(), np.asarray(getattr(j_inputs, name)), err_msg=name
        )


def test_unported_options_raise():
    """Every engine entry point is ported (the profiling prefixes since they
    were stubs, random loss on and off); what raises is a state whose key is
    not the int64 ``[2]`` the draw takes, and a config the JAX engine rejects
    too."""
    config, state, inputs = _scenario("crash")
    pconfig, pstate, pinputs = (_port_config(config), _port_state(config, state),
                                _port_inputs(config, inputs))
    bad = dataclasses.replace(pstate, rng_key=pstate.rng_key.to(torch.int32))
    for prefix in (teng.step_fd_scan, teng.step_cut_detector, teng.step):
        for loss in (False, True):
            prefix(pconfig, pstate, pinputs, loss)
            with pytest.raises(TypeError, match="int64"):
                prefix(pconfig, bad, pinputs, loss)
    with pytest.raises(AssertionError):
        teng.SimConfig(capacity=8, fd_threshold=256)
