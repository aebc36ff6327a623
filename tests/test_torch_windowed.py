"""The windowed FD policy in the PyTorch port against the JAX engine: the
window rule (``window_step``, ``windowed_fd_phase``), the scan round's plain
FD phase (``kernels.fd_phase_fused_plain``), both dispatch branches from
partly filled windows, and the driver's decisions. Exact equality: the
policy is integer and boolean only, and a random-loss round reads the draw
JAX's reads, threefry's bits from the state's key, at any drop probability.
The port keeps ``fd_hist`` as int32; it carries the JAX engine's uint16
bits."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rapid_tpu.sim import engine as jeng
from rapid_tpu.sim.driver import Simulator as JaxSimulator
from rapid_tpu_torch.sim import engine as teng
from rapid_tpu_torch.sim import kernels
from rapid_tpu_torch.sim.driver import Simulator

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py

OUTPUTS = ("alive", "fd_fail", "alerted", "fd_streak", "fd_ok", "down_arrivals",
           "fd_hist", "fd_seen")
WINDOWS = [1, 10, 16]
THRESHOLDS = [0.4, 0.5, 0.7, 1.0]


def _port_config(config):
    return teng.SimConfig(**dataclasses.asdict(config))


def _port_state(config, state):
    arrays = {name: np.asarray(getattr(state, name)) for name in state.__dataclass_fields__}
    return teng.state_from_numpy(_port_config(config), arrays, device="cpu")


def _port_inputs(inputs):
    return teng.RoundInputs(**{
        name: torch.from_numpy(np.array(getattr(inputs, name)))
        for name in inputs.__dataclass_fields__
    })


def _assert_states_equal(jax_state, port_state):
    for name, value in teng.state_to_numpy(port_state).items():
        want = np.asarray(getattr(jax_state, name))
        assert value.dtype == want.dtype, name
        np.testing.assert_array_equal(value, want, err_msg=f"field {name} diverged")


def _window_planes(rng, shape, w):
    """Partly filled, partly failed windows: fill counts in [0, W] (half of
    them full), failure bits within the window."""
    bits = rng.random(shape + (w,)) < 0.6
    hist = (bits << np.arange(w)).sum(axis=-1).astype(np.uint16)
    seen = np.where(rng.random(shape) < 0.5, w, rng.integers(0, w + 1, shape)).astype(np.uint8)
    return hist, seen


# --------------------------------------------------------------------- #
# The window rule
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("w", WINDOWS)
@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_window_step_and_phase_match_jax(w, threshold):
    config = jeng.SimConfig(capacity=64, fd_policy="windowed", fd_window=w,
                            fd_window_threshold=threshold)
    rng = np.random.default_rng(w * 100 + int(threshold * 10))
    hist, seen = _window_planes(rng, (64, 10), w)
    seen[rng.random((64, 10)) < 0.02] = 255  # the uint8 count wraps before the clamp
    probed = rng.random((64, 10)) < 0.8
    fail = probed & (rng.random((64, 10)) < 0.5)
    alerted = rng.random((64, 10)) < 0.1
    assert teng.window_params(_port_config(config))[:2] == jeng._window_params(config)[:2]
    want = jeng.window_step(config, jnp.asarray(hist), jnp.asarray(seen),
                            jnp.asarray(probed), jnp.asarray(fail))
    got = teng.window_step(_port_config(config), torch.from_numpy(hist.astype(np.int32)),
                           torch.from_numpy(seen), torch.from_numpy(probed),
                           torch.from_numpy(fail))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]).astype(np.int32))
    for g, x in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))
    state = jeng.initial_state(config, _cluster(64), np.ones(64, bool))
    state = dataclasses.replace(state, fd_hist=jnp.asarray(hist), fd_seen=jnp.asarray(seen),
                                alerted=jnp.asarray(alerted))
    want = jeng.windowed_fd_phase(config, state, jnp.asarray(probed), jnp.asarray(fail))
    got = teng.windowed_fd_phase(_port_config(config), _port_state(config, state),
                                 torch.from_numpy(probed), torch.from_numpy(fail))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]).astype(np.int32))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    if threshold < 1.0 and w > 1:
        assert np.asarray(want[2]).any(), "some edges should cross"


def _cluster(c, k=10):
    from rapid_tpu.sim.topology import VirtualCluster

    return VirtualCluster.synthesize(c, k, seed=1)


def test_popcount16_counts_every_16_bit_value():
    x = torch.arange(1 << 16, dtype=torch.int32)
    want = np.array([bin(i).count("1") for i in range(1 << 16)])
    np.testing.assert_array_equal(kernels.popcount16(x).numpy(), want)


# --------------------------------------------------------------------- #
# The scan round's FD phase, plain version, against the JAX _fd_phase
# --------------------------------------------------------------------- #


def _crash(sim):
    sim.crash(np.array([6, 21, 40]))
    return {}


def _one_way(sim):
    sim.one_way_ingress_partition(np.array([4, 9]))
    return {"probe_drop": sim._probe_drop_mask()}


def _joiners_and_leavers(sim):
    sim.crash(np.array([10]))
    sim.leave(np.array([3, 28]))
    sim.request_joins(np.array([60, 61, 62]))
    joins = sim._arm_pending_joins()
    return {"down_reports": np.asarray(sim._down_reports()), "join_reports": joins}


def _lossy(sim):
    sim.crash(np.array([7]))
    drop = np.zeros(sim.config.capacity, dtype=np.float32)
    drop[[2, 30, 44]] = 1.0
    return {"drop_prob": drop}


def _half_lossy(sim):
    sim.crash(np.array([7]))
    drop = np.zeros(sim.config.capacity, dtype=np.float32)
    drop[[2, 30, 44]] = 1.0
    drop[[5, 11, 19, 50]] = (0.2, 0.5, 0.5, 0.9)
    return {"drop_prob": drop}


def _jax_windowed_case(setup, w, threshold, rpi=1, round_=0, seed=3):
    config = jeng.SimConfig(capacity=64, k=10, h=9, l=4, fd_policy="windowed",
                            fd_window=w, fd_window_threshold=threshold,
                            rounds_per_interval=rpi)
    sim = JaxSimulator(60, capacity=64, config=config, seed=seed, speculate=False)
    extra = setup(sim) or {}
    rng = np.random.default_rng(seed + w)
    hist, seen = _window_planes(rng, (64, 10), w)
    state = dataclasses.replace(
        sim.state, fd_hist=jnp.asarray(hist), fd_seen=jnp.asarray(seen),
        fd_fail=jnp.asarray(rng.integers(0, 256, (64, 10)).astype(np.uint8)),
        alerted=jnp.asarray(rng.random((64, 10)) < 0.1), round=jnp.int32(round_),
    )
    return config, state, jeng.const_inputs(config, sim.alive, **extra)


def _assert_plain_matches_jax(config, state, inputs, random_loss=False):
    out = jeng._fd_phase(config, state, inputs, random_loss)
    want = dict(zip(OUTPUTS, (out[2], out[3], out[8], out[6], out[7], out[9], out[4], out[5])))
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    w, fire, _ = teng.window_params(_port_config(config))
    got = kernels.fd_phase_fused_plain(
        t(state.active), t(inputs.alive), t(inputs.drop_prob) if random_loss else None,
        t(state.subjects), t(state.observers), t(inputs.probe_drop), t(inputs.down_reports),
        t(state.rng_key).long(), t(state.fd_fail), t(state.alerted), t(state.fd_streak),
        t(state.fd_ok),
        t(state.round), threshold=config.fd_threshold,
        rounds_per_interval=config.rounds_per_interval,
        fd_hist=t(np.asarray(state.fd_hist).astype(np.int32)), fd_seen=t(state.fd_seen),
        window=w, window_fire=fire,
    )
    for name, g in zip(OUTPUTS, got):
        x = np.asarray(want[name])
        if name == "fd_hist":
            x = x.astype(np.int32)
        assert g.numpy().dtype == x.dtype, name
        np.testing.assert_array_equal(g.numpy(), x, err_msg=name)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(state.fd_fail))
    # the split key JAX's round returns, with loss or without
    np.testing.assert_array_equal(got[8].numpy().astype(np.uint32), np.asarray(out[0]))
    return want


@pytest.mark.parametrize("w, threshold", [(10, 0.4), (16, 0.7), (1, 1.0), (10, 0.5)])
def test_fused_plain_windowed_matches_jax_crash(w, threshold):
    want = _assert_plain_matches_jax(*_jax_windowed_case(_crash, w, threshold))
    assert np.asarray(want["down_arrivals"]).any(), "the case should raise alerts"


@pytest.mark.parametrize("setup", [_one_way, _joiners_and_leavers])
def test_fused_plain_windowed_matches_jax_partitions_joiners_leavers(setup):
    _assert_plain_matches_jax(*_jax_windowed_case(setup, 10, 0.4))


@pytest.mark.parametrize("round_", range(5))
def test_fused_plain_windowed_matches_jax_staggered_phases(round_):
    _assert_plain_matches_jax(*_jax_windowed_case(_crash, 10, 0.4, rpi=4, round_=round_))


def test_fused_plain_windowed_matches_jax_random_loss_at_probability_zero_and_one():
    _assert_plain_matches_jax(*_jax_windowed_case(_lossy, 16, 0.4), random_loss=True)


@pytest.mark.parametrize("w, threshold, rpi", [(16, 0.4, 1), (10, 0.5, 1), (10, 0.4, 4)])
def test_fused_plain_windowed_matches_jax_random_loss_below_one(w, threshold, rpi):
    _assert_plain_matches_jax(*_jax_windowed_case(_half_lossy, w, threshold, rpi=rpi),
                              random_loss=True)


def test_fused_cpu_wrapper_windowed_takes_plain_path_and_counts_no_launch():
    config, state, inputs = _jax_windowed_case(_crash, 10, 0.4)
    port, port_inputs = _port_state(config, state), _port_inputs(inputs)
    before = dict(kernels.LAUNCHES)
    key, *got = teng._fd_phase(_port_config(config), port, port_inputs, False)
    assert kernels.LAUNCHES == before
    out = jeng._fd_phase(config, state, inputs, False)
    np.testing.assert_array_equal(key.numpy().astype(np.uint32), np.asarray(out[0]))
    np.testing.assert_array_equal(got[6].numpy(), np.asarray(out[4]).astype(np.int32))
    np.testing.assert_array_equal(got[5].numpy(), np.asarray(out[9]))
    assert got[1] is port.fd_fail  # the windowed policy leaves fd_fail as it came


def test_fused_wrapper_rejects_bad_window_arguments():
    config, state, inputs = _jax_windowed_case(_crash, 10, 0.4)
    port = _port_state(config, state)
    i = _port_inputs(inputs)
    args = (port.active, i.alive, i.drop_prob, port.subjects, port.observers, i.probe_drop,
            i.down_reports, port.rng_key, port.fd_fail, port.alerted, port.fd_streak,
            port.fd_ok, port.round)
    with pytest.raises(ValueError, match="fd_hist"):
        kernels.fd_phase_fused(*args, threshold=10, window=10, window_fire=4)
    with pytest.raises(TypeError):
        kernels.fd_phase_fused(*args, threshold=10, window=10, window_fire=4,
                               fd_hist=port.fd_hist.to(torch.int16), fd_seen=port.fd_seen)
    with pytest.raises(ValueError):
        kernels.fd_phase_fused(*args, threshold=10, window=17, window_fire=4,
                               fd_hist=port.fd_hist, fd_seen=port.fd_seen)
    with pytest.raises(ValueError, match="gray"):
        kernels.fd_phase_fused(*args, threshold=10, gray_confirm=3, window=10,
                               window_fire=4, fd_hist=port.fd_hist, fd_seen=port.fd_seen)


# --------------------------------------------------------------------- #
# Both dispatch branches from partly filled windows
# --------------------------------------------------------------------- #


def _branch_case(w, threshold, rpi=1, seed=0, crash=(5, 21), n=32, k=5, counted=True):
    config = jeng.SimConfig(capacity=n, k=k, h=k - 1, l=2, fd_policy="windowed",
                            fd_window=w, fd_window_threshold=threshold,
                            rounds_per_interval=rpi)
    sim = JaxSimulator(n, config=config, seed=seed, speculate=False)
    sim.crash(np.array(crash))
    rng = np.random.default_rng(seed)
    hist, seen = _window_planes(rng, (n, k), w)
    if not counted:  # stale bits, but no probe counted yet
        seen[:] = 0
    state = dataclasses.replace(sim.state, fd_hist=jnp.asarray(hist),
                                fd_seen=jnp.asarray(seen))
    return config, state, jeng.const_inputs(config, sim.alive)


BRANCH_CASES = {
    "w10_t0.4": (10, 0.4, 1),
    "w16_t0.7": (16, 0.7, 1),
    "w16_t1.0": (16, 1.0, 1),
    "w1_t0.5": (1, 0.5, 1),
    "w5_t0.4_rpi4": (5, 0.4, 4),
    "w16_t0.4_rpi5": (16, 0.4, 5),
}


@pytest.mark.parametrize("name", list(BRANCH_CASES))
def test_run_until_decided_const_windowed_matches_jax(name):
    """The closed form's prelude and its fd_hist reconstruction (shifts of up
    to 16, in int64 here, uint32 in JAX) from carried windows."""
    config, state, inputs = _branch_case(*BRANCH_CASES[name], seed=len(name))
    for budget in (3, 24):
        want = jeng.run_until_decided_const(config, state, inputs, jnp.int32(budget), True)
        got = teng.run_until_decided_const(_port_config(config), _port_state(config, state),
                                           _port_inputs(inputs), budget, True)
        _assert_states_equal(want, got)


@pytest.mark.parametrize("name", list(BRANCH_CASES))
def test_run_rounds_const_windowed_matches_jax(name):
    config, state, inputs = _branch_case(*BRANCH_CASES[name], seed=len(name))
    want = jeng.run_rounds_const(config, state, inputs, 20, False)
    got = teng.run_rounds_const(_port_config(config), _port_state(config, state),
                                _port_inputs(inputs), 20, False)
    _assert_states_equal(want, got)
    if name == "w10_t0.4":
        assert bool(want.decided), "the scenario should reach a decision"


def test_windowed_closed_form_at_w16_fills_and_shifts_a_whole_window():
    """Sixteen probes of one constant outcome shift every carried bit out:
    the reconstructed window is all failures on failing edges and all
    successes elsewhere, as the JAX uint32 shift gives. (No probe is counted
    in the carried windows, so none fires before the 16th.)"""
    config, state, inputs = _branch_case(16, 0.4, seed=5, counted=False)
    want = jeng.run_until_decided_const(config, state, inputs, jnp.int32(40), True)
    got = teng.run_until_decided_const(_port_config(config), _port_state(config, state),
                                       _port_inputs(inputs), 40, True)
    _assert_states_equal(want, got)
    hist = got.fd_hist.numpy()[np.asarray(inputs.alive)]  # live observers probed
    assert int(got.round) >= 16 and hist.max() == 0xFFFF
    assert set(np.unique(hist).tolist()) == {0, 0xFFFF}


def _run_both(config, state, inputs, rounds):
    scan = teng.run_rounds_const(config, state, inputs, rounds, False)
    fast = teng.run_until_decided_const(config, state, inputs, rounds, True)
    return scan, fast


@pytest.mark.parametrize("case", ["seed0", "seed1", "carried", "staggered"])
def test_windowed_closed_form_matches_scan_in_the_port(case):
    """Twins of tests/test_fast_path.py's windowed cases: in the port the
    closed form equals the scan over the same budget (the closed form masks
    the rounds after its decision, so no equalising tail is needed), and both
    equal the JAX scan, but for the key, which only the scan advances."""
    if case.startswith("seed"):
        seed = int(case[-1])
        config = jeng.SimConfig(capacity=48, k=6, h=5, l=2, fd_policy="windowed",
                                fd_window=6, fd_window_threshold=0.5)
        sim = JaxSimulator(48, capacity=48, config=config, seed=seed, speculate=False)
        sim.crash(np.random.default_rng(seed).choice(48, size=3, replace=False))
        state, rounds = sim.state, 14
    elif case == "carried":
        config = jeng.SimConfig(capacity=40, k=5, h=4, l=2, fd_policy="windowed",
                                fd_window=8, fd_window_threshold=0.4)
        sim = JaxSimulator(40, capacity=40, config=config, seed=3, speculate=False)
        sim.crash(np.array([7]))
        state = jeng.run_rounds_const(config, sim.state, jeng.const_inputs(config, sim.alive),
                                      3, False)
        sim.revive(np.array([7]))
        sim.crash(np.array([11, 12]))
        rounds = 16
    else:
        config = jeng.SimConfig(capacity=32, k=4, h=3, l=2, fd_policy="windowed",
                                fd_window=5, fd_window_threshold=0.4, rounds_per_interval=4)
        sim = JaxSimulator(32, capacity=32, config=config, seed=9, speculate=False)
        sim.crash(np.array([5, 21]))
        state, rounds = sim.state, 40
    inputs = jeng.const_inputs(config, sim.alive)
    scan, fast = _run_both(_port_config(config), _port_state(config, state),
                           _port_inputs(inputs), rounds)
    want = jeng.run_rounds_const(config, state, inputs, rounds, False)
    _assert_states_equal(want, scan)
    # the closed form draws nothing and leaves the key as it came, as JAX's
    # does (the scan splits it every round): every other field is the scan's
    _assert_states_equal(dataclasses.replace(want, rng_key=state.rng_key), fast)


# --------------------------------------------------------------------- #
# The driver
# --------------------------------------------------------------------- #


def _summary(rec):
    if rec is None:
        return None
    return (rec.cut.tolist(), rec.configuration_id, rec.virtual_time_ms,
            rec.membership_size)


def test_windowed_driver_decides_with_exact_timing_alike():
    """Twin of test_windowed_driver_fast_path_decides_with_exact_timing: the
    closed form decides after a full window (10 probes), the vote hop and the
    batching window, in one dispatch."""
    kw = dict(capacity=50, fd_policy="windowed", fd_window=10, fd_window_threshold=0.4)
    recs = []
    for sim in (JaxSimulator(50, config=jeng.SimConfig(**kw), seed=4),
                Simulator(50, config=teng.SimConfig(**kw), seed=4, device="cpu")):
        sim.crash(np.array([8, 9]))
        recs.append(_summary(sim.run_until_decision(max_rounds=64, batch=64,
                                                    classic_fallback_after_rounds=None)))
    assert recs[0] == recs[1]
    assert recs[1][0] == [8, 9] and recs[1][2] == 11 * 1000 + 100


@pytest.mark.parametrize("lossy", [False, True])
def test_windowed_driver_cuts_sustained_crash_alike(lossy):
    """Twin of test_windowed_fd_cuts_sustained_crash, on both dispatch
    branches (ingress loss 1.0 takes the scan)."""
    recs = []
    for sim in (JaxSimulator(32, config=jeng.SimConfig(capacity=32, fd_policy="windowed"),
                             seed=32),
                Simulator(32, config=teng.SimConfig(capacity=32, fd_policy="windowed"),
                          seed=32, device="cpu")):
        if lossy:
            sim.ingress_loss(np.array([7, 19]), 1.0)
        else:
            sim.crash(np.array([7, 19]))
        recs.append(_summary(sim.run_until_decision(max_rounds=20, batch=10)))
    assert recs[0] == recs[1]
    assert recs[1][0] == [7, 19] and recs[1][2] == 11 * 1000 + 100


@pytest.mark.parametrize("probability", [0.5, 0.8])
def test_windowed_driver_lossy_decision_alike(probability):
    """Ingress loss below 1.0 under the windowed policy: the draws decide
    when each window fills, and the twins agree on the cut, configuration
    id, virtual time, rounds and final state, the key included."""
    sims = (JaxSimulator(64, config=jeng.SimConfig(capacity=64, fd_policy="windowed"),
                         seed=33),
            Simulator(64, config=teng.SimConfig(capacity=64, fd_policy="windowed"),
                      seed=33, device="cpu"))
    recs = []
    for sim in sims:
        sim.ingress_loss(np.array([7, 19, 40]), probability)
        recs.append(_summary(sim.run_until_decision(max_rounds=64, batch=16))
                    + (sim.metrics.get("rounds"),))
    assert recs[0] == recs[1] and recs[1][0] == [7, 19, 40]
    for name, value in teng.state_to_numpy(sims[1].state).items():
        np.testing.assert_array_equal(value, np.asarray(getattr(sims[0].state, name)),
                                      err_msg=name)


def test_windowed_policy_stays_under_flip_flop_alike():
    """Twin of test_windowed_fd_stays_stable_under_flip_flop: 3 rounds down,
    7 up never fills a window with 4 failures, while the cumulative counter
    crosses its threshold."""
    victims = np.array([5])

    def run(make, policy):
        sim = make(policy)
        for _ in range(6):
            sim.crash(victims)
            rec = sim.run_until_decision(max_rounds=3, batch=3)
            sim.revive(victims)
            rec = rec or sim.run_until_decision(max_rounds=7, batch=7)
            if rec:
                return _summary(rec), sim.virtual_ms
        return None, sim.virtual_ms

    jax_make = lambda p: JaxSimulator(24, config=jeng.SimConfig(capacity=24, fd_policy=p), seed=31)  # noqa: E731
    port_make = lambda p: Simulator(24, config=teng.SimConfig(capacity=24, fd_policy=p),  # noqa: E731
                                    seed=31, device="cpu")
    for policy in ("windowed", "cumulative"):
        assert run(jax_make, policy) == run(port_make, policy)
    assert run(port_make, "windowed")[0] is None
    assert run(port_make, "cumulative")[0][0] == [5]


def _first_alert(make_sim, script, policy):
    """The sim side of tests/test_fd_policy.py: one round per script entry,
    toggling the victim's ingress partition; the round at which an observer
    edge toward the victim first alerts."""
    sim = make_sim(policy)
    victim = 4
    observers = np.asarray(sim.state.observers)
    for t, ok in enumerate(script):
        if ok:
            sim.clear_link_faults()
        else:
            sim.one_way_ingress_partition(np.array([victim]))
        sim.run_until_decision(max_rounds=1, batch=1, classic_fallback_after_rounds=None)
        alerted = np.asarray(sim.state.alerted)
        subj = np.asarray(sim.state.subjects)
        if any(alerted[int(o), k] for k in range(sim.config.k)
               for o in [observers[victim, k]] if subj[int(o), k] == victim):
            return t
    return None


def test_sim_plane_first_alert_matches_jax_under_a_scripted_probe_sequence():
    script = [True] * 6 + [False, True, False, True] * 12

    def cfg(mod, policy):
        return mod.SimConfig(capacity=16, fd_policy=policy, fd_window=10,
                             fd_window_threshold=0.4)

    for policy in ("windowed", "cumulative"):
        want = _first_alert(lambda p: JaxSimulator(16, config=cfg(jeng, p), seed=3), script,
                            policy)
        got = _first_alert(lambda p: Simulator(16, config=cfg(teng, p), seed=3, device="cpu"),
                           script, policy)
        assert want is not None and got == want, policy
