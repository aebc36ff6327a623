"""The port's Simulator has the JAX Simulator's public surface: the
constructor's and ``from_configuration``'s parameters in JAX's order (the
port adds ``device`` last), and the public methods other planes call,
``expected_observers`` and ``sorted_identifiers``, equal to JAX's."""

import inspect

import numpy as np
import pytest
import torch

from rapid_tpu.sim.driver import Simulator as JaxSimulator
from rapid_tpu_torch.sim.driver import Simulator


def _params(fn):
    return [(p.name, p.default) for p in inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize("name", ["__init__", "from_configuration"])
def test_signature_is_jax_order_plus_device(name):
    """Names and order are JAX's, then ``device``; so are the defaults,
    but for ``speculate``, whose None is JAX's True except on a CUDA device
    (test_speculate_defaults_to_jax_off_the_card)."""
    jax_params = _params(getattr(JaxSimulator, name))
    port_params = _params(getattr(Simulator, name))
    assert [p for p, _ in port_params] == [p for p, _ in jax_params] + ["device"]
    assert dict(port_params)["device"] is None
    for (p, default), (_, jax_default) in zip(port_params, jax_params):
        assert default == (None if p == "speculate" else jax_default), p


def test_speculate_defaults_to_jax_off_the_card(tmp_path):
    from rapid_tpu_torch.sim.driver import _speculates

    assert Simulator(8, seed=1, device="cpu").speculate is JaxSimulator(8, seed=1).speculate
    path = str(tmp_path / "conf.npz")
    Simulator(8, seed=1, device="cpu").save_configuration(path)
    assert Simulator.from_configuration(path, device="cpu").speculate is True
    assert _speculates(None, torch.device("cuda")) is False
    for device in ("cpu", "cuda"):
        for given in (True, False):
            assert _speculates(given, torch.device(device)) is given


def test_fifth_positional_argument_is_the_mesh():
    from rapid_tpu_torch.shard.engine import make_mesh

    mesh = make_mesh(devices=["cpu"] * 2)
    sim = Simulator(8, 8, None, 3, mesh, False)
    assert sim.mesh is mesh and sim.speculate is False and sim.seed == 3


@pytest.mark.parametrize("name", ["expected_observers", "sorted_identifiers",
                                  "enable_profiling", "configuration_id"])
def test_public_methods_exist(name):
    assert callable(getattr(Simulator, name))
    assert callable(getattr(JaxSimulator, name))


def test_every_public_member_of_the_jax_simulator_exists():
    """Since the host planes, the port's Simulator has every public method
    and property of the JAX one."""
    public = {n for n in dir(JaxSimulator) if not n.startswith("_")}
    assert sorted(n for n in public if not hasattr(Simulator, n)) == []


@pytest.mark.parametrize("name", [
    "enable_placement", "enable_handoff", "enable_serving", "serving_put", "serving_get",
    "serving_drive_open_loop", "enable_slo", "slo_plane", "enable_hierarchy",
    "hierarchy_rows", "global_fingerprint", "cell_of_slot", "enable_durability",
    "checkpoint_slot", "durable_pending", "restart_slot"])
def test_plane_methods_take_jax_parameters(name):
    """The planes' methods take JAX's parameters, in its order, with its
    defaults (the simulator's own device is the planes' device)."""
    assert _params(getattr(Simulator, name)) == _params(getattr(JaxSimulator, name))


def test_attributes_of_the_planes():
    sim = Simulator(8, seed=1, device="cpu")
    for attr in ("metrics", "tracer", "recorder", "speculate", "hlc"):
        assert hasattr(sim, attr), attr
    assert sim.speculate is True and sim.hlc is None


def _pair(n, capacity, seed):
    return (JaxSimulator(n, capacity=capacity, seed=seed),
            Simulator(n, capacity=capacity, seed=seed, device="cpu"))


@pytest.mark.parametrize("seed", [0, 4, 11])
def test_expected_observers_and_sorted_identifiers_twins(seed):
    """Every slot's expected observers (members and would-be joiners) and
    the sorted identifier history, before and after a join wave and a
    crash, equal to the JAX simulator's."""
    pair = _pair(40, 48, seed)

    def check():
        for slot in range(48):
            jax_ids, jax_alive = pair[0].expected_observers(slot)
            ids, alive = pair[1].expected_observers(slot)
            np.testing.assert_array_equal(ids, jax_ids)
            np.testing.assert_array_equal(alive, jax_alive)
        np.testing.assert_array_equal(pair[1].sorted_identifiers(),
                                      pair[0].sorted_identifiers())

    check()
    for sim in pair:
        sim.request_joins(np.arange(40, 46))
        sim.crash(np.array([3, 17]))
    recs = [sim.run_until_decision(max_rounds=40) for sim in pair]
    assert recs[1].added.tolist() == recs[0].added.tolist()
    check()
    assert len(pair[1].sorted_identifiers()) == 46


def test_from_configuration_by_keyword_and_position(tmp_path):
    jax_sim = JaxSimulator(20, seed=6)
    path = str(tmp_path / "snap.npz")
    jax_sim.save_configuration(path)
    by_keyword = Simulator.from_configuration(
        path, config_overrides={"extern_proposals": 1}, device="cpu")
    by_position = Simulator.from_configuration(path, None, {"extern_proposals": 1}, "cpu")
    for sim in (by_keyword, by_position):
        assert sim.configuration_id() == jax_sim.configuration_id()
        assert sim.config.extern_proposals == 1 and sim.speculate is True
        assert sim.metrics.get("view_changes") == 0
