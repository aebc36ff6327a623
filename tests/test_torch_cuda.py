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
