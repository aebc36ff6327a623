"""The PyTorch port's Simulator against the JAX Simulator, seeded alike and
driven through the same fault schedule: each view change must decide the same
cut, add and remove the same nodes, and land on the same configuration id,
virtual time, rounds run and member list, and the two states must be equal
field by field, the PRNG key included. Random ingress loss below probability
1.0 is held the same way: the port draws threefry's bits from the same key."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rapid_tpu.sim.driver import Simulator as JaxSimulator
from rapid_tpu.sim.engine import SimConfig as JaxConfig
from rapid_tpu_torch.sim import engine as teng
from rapid_tpu_torch.sim.driver import Simulator, _pow2_chunks

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py


def _pair(n_nodes, seed, capacity=None):
    return (
        JaxSimulator(n_nodes, capacity=capacity, seed=seed),
        Simulator(n_nodes, capacity=capacity, seed=seed, device="cpu"),
    )


def _summary(rec):
    if rec is None:
        return None
    return (
        rec.cut.tolist(), rec.added.tolist(), rec.removed.tolist(),
        rec.configuration_id, rec.virtual_time_ms, rec.membership_size,
    )


def _assert_same(jax_sim, port_sim, jax_rec, port_rec):
    assert _summary(port_rec) == _summary(jax_rec)
    np.testing.assert_array_equal(port_sim.members(), jax_sim.members())
    assert port_sim.virtual_ms == jax_sim.virtual_ms
    assert port_sim.configuration_id() == jax_sim.configuration_id()
    assert port_sim.metrics.get("rounds") == jax_sim.metrics.get("rounds")
    for name, value in teng.state_to_numpy(port_sim.state).items():
        np.testing.assert_array_equal(value, np.asarray(getattr(jax_sim.state, name)),
                                      err_msg=f"state field {name}")


def _drive(pair, fault, **run):
    recs = []
    for sim in pair:
        fault(sim)
        recs.append(sim.run_until_decision(**run))
    _assert_same(*pair, *recs)
    return recs[1]


def test_crash_burst():
    rec = _drive(_pair(50, seed=2), lambda s: s.crash(np.array([4, 17, 30, 42, 49])),
                 max_rounds=40)
    assert rec.cut.tolist() == [4, 17, 30, 42, 49]
    assert rec.virtual_time_ms == 11_100


def test_one_way_partition():
    rec = _drive(_pair(30, seed=3),
                 lambda s: s.one_way_ingress_partition(np.array([7, 22])), max_rounds=40)
    assert rec.cut.tolist() == [7, 22]


def test_ingress_loss_at_probability_one():
    pair = _pair(30, seed=4)
    rec = _drive(pair, lambda s: s.ingress_loss(np.array([11, 12]), 1.0),
                 max_rounds=64, batch=16)
    assert rec.cut.tolist() == [11, 12]
    assert rec.virtual_time_ms == 11_100


def test_ingress_loss_at_eighty_percent_decides_same_cut():
    pair = _pair(30, seed=4)
    # mid-decision first: the lossy scan's states equal after a dispatch
    _assert_same(*pair, *(s.ingress_loss(np.array([11]), 0.8) or s.run_until_decision(
        max_rounds=5, batch=5) for s in pair))
    rec = _drive(pair, lambda s: None, max_rounds=64)
    assert rec.cut.tolist() == [11]


def test_graceful_leave():
    rec = _drive(_pair(32, seed=21), lambda s: s.leave(np.array([4, 19])), max_rounds=8)
    assert rec.cut.tolist() == [4, 19]


def test_join_wave():
    rec = _drive(_pair(20, seed=6, capacity=24),
                 lambda s: s.request_joins(np.array([20, 21, 22, 23])), max_rounds=10)
    assert rec.added.tolist() == [20, 21, 22, 23]


def test_flip_flop_reachability():
    pair = _pair(20, seed=5)
    victims = np.array([2, 9])
    for cycle in range(30):
        recs = []
        for sim in pair:
            (sim.crash if cycle % 2 == 0 else sim.revive)(victims)
            recs.append(sim.run_until_decision(max_rounds=3, batch=3))
        _assert_same(*pair, *recs)
        if recs[1] is not None:
            break
    assert recs[1] is not None and recs[1].cut.tolist() == [2, 9]
    assert len(pair[1].view_changes) == 1


def test_two_sequential_view_changes():
    pair = _pair(30, seed=8)
    _drive(pair, lambda s: s.crash(np.array([29])), max_rounds=40)
    rec = _drive(pair, lambda s: s.crash(np.array([3, 28])), max_rounds=40, batch=16)
    assert rec.membership_size == 27


def test_concurrent_join_and_crash_over_several_dispatches():
    pair = _pair(20, seed=7, capacity=22)
    for sim in pair:
        sim.request_joins(np.array([20, 21]))
        sim.crash(np.array([5]))
    for _ in range(4):
        _assert_same(*pair, *(sim.run_until_decision(max_rounds=20) for sim in pair))


def _inject_reports(sim):
    for dst in (6, 13):
        sim.inject_down_report(dst, range(sim.config.k))


def _cancel_one_join(sim):
    sim.request_joins(np.array([20, 21]))
    sim.cancel_join(21)


def _partition_then_clear(sim):
    sim.one_way_ingress_partition(np.array([4]))
    sim.ingress_loss(np.array([9]), 1.0)
    sim.clear_link_faults()


@pytest.mark.parametrize("fault, cut", [
    (_inject_reports, [6, 13]),
    (_cancel_one_join, [20]),
    (_partition_then_clear, None),
])
def test_injected_reports_cancelled_joins_and_cleared_faults(fault, cut):
    pair = _pair(20, seed=9, capacity=22)
    for sim in pair:
        fault(sim)
    recs = [sim.run_until_decision(max_rounds=12) for sim in pair]
    _assert_same(*pair, *recs)
    assert (recs[1] and recs[1].cut.tolist()) == cut


def test_stop_when_announced_pauses_alike():
    pair = _pair(30, seed=12)
    recs = []
    for sim in pair:
        sim.crash(np.array([5]))
        recs.append(sim.run_until_decision(max_rounds=40, stop_when_announced=True))
    assert recs == [None, None]
    assert pair[1].virtual_ms == pair[0].virtual_ms
    for a, b in zip(pair[1].last_announcement, pair[0].last_announcement):
        np.testing.assert_array_equal(a, b)
    _assert_same(*pair, *(sim.run_until_decision(max_rounds=40) for sim in pair))


def test_no_decision_and_blocked_quorum_bill_the_same_time():
    pair = _pair(8, seed=10)
    _assert_same(*pair, *(sim.run_until_decision(max_rounds=15) for sim in pair))
    # 7 of 8 crash: no live majority, so the classic fallback stays stalled
    _drive(pair, lambda s: s.crash(np.arange(1, 8)), max_rounds=30)


def test_resume_from_jax_snapshot(tmp_path):
    jax_sim = JaxSimulator(30, seed=12)
    jax_sim.crash(np.array([29]))
    assert jax_sim.run_until_decision(max_rounds=40) is not None
    path = str(tmp_path / "snap.npz")
    jax_sim.save_configuration(path)

    port_sim = Simulator.from_configuration(path, device="cpu")
    assert port_sim.configuration_id() == jax_sim.configuration_id()
    assert port_sim.virtual_ms == jax_sim.virtual_ms
    np.testing.assert_array_equal(port_sim.members(), jax_sim.members())
    restored = JaxSimulator.from_configuration(path)
    rec = _drive((restored, port_sim), lambda s: s.crash(np.array([28])), max_rounds=40)
    assert rec.cut.tolist() == [28]
    # a lossy run resumed from the snapshot: the restored key draws alike
    port_sim = Simulator.from_configuration(path, device="cpu")
    restored = JaxSimulator.from_configuration(path)
    rec = _drive((restored, port_sim), lambda s: s.ingress_loss(np.array([3, 17]), 0.5),
                 max_rounds=64)
    assert rec.cut.tolist() == [3, 17]


def test_delivery_groups_and_delays():
    config = dict(capacity=32, groups=2, max_delivery_delay=2)
    pair = (
        JaxSimulator(32, config=JaxConfig(**config), seed=3),
        Simulator(32, config=teng.SimConfig(**config), seed=3, device="cpu"),
    )
    for sim in pair:
        sim.set_delivery_groups(np.arange(32, dtype=np.int32) % 2)
        sim.delay_broadcasts(1, np.arange(0, 32, 4), 2)
        sim.drop_broadcasts(0, np.array([13]))
    _drive(pair, lambda s: s.crash(np.array([11])), max_rounds=40)


@pytest.mark.parametrize("endpoint", ["kept", "fresh"])
def test_restart_wave_keeps_the_ring_order_of_unmoved_endpoints(endpoint):
    """A cycle of the benchmark's mix at 1000 members: 1% crash and are
    decided out, their slots are re-seated with fresh ids (on the endpoint
    they had, or on a new one) and join as one wave. Each joiner's armed
    observers, both view changes and the states equal the JAX Simulator's.
    Re-seats on the endpoints they had keep the ring order and the device's
    rank table; new endpoints sort and upload them anew."""
    pair = _pair(1000, seed=9)
    burst = np.arange(5, 1000, 100)
    _drive(pair, lambda s: s.crash(burst), max_rounds=40)
    ids = np.random.default_rng(9).integers(-(2**63), 2**63, size=(10, 2), dtype=np.int64)
    armed = []
    order, rank_dev = pair[1].cluster.full_ring_order(), pair[1]._ring_rank_dev
    for sim in pair:
        asked = {}
        ask = sim._expected_observers

        def tap(node, ask=ask, asked=asked):
            observers, alive = ask(node)
            asked[int(node)] = (observers.tolist(), alive.tolist())
            return observers, alive

        sim._expected_observers = tap
        armed.append(asked)
        for slot, (high, low) in zip(burst.tolist(), ids):
            host, port = (sim.endpoint_of(slot) if endpoint == "kept"
                          else (b"restarted-%d.example" % slot, 9000 + slot))
            sim.assign_identity(slot, host, port, int(high), int(low))
        sim.request_joins(burst)
    rec = _drive(pair, lambda s: None, max_rounds=40)
    assert rec.added.tolist() == burst.tolist()
    assert armed[1] == armed[0] and sorted(armed[1]) == burst.tolist()
    assert len([s for s in pair[1].tracer.spans if s.name == "ring_order"]) == 1
    kept = endpoint == "kept"
    assert (pair[1].cluster.full_ring_order() is order) == kept
    assert (pair[1]._ring_rank_dev is rank_dev) == kept


def test_simulator_without_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Simulator(8)
    with pytest.raises(RuntimeError):
        teng.const_inputs(teng.SimConfig(capacity=8), np.ones(8, bool))


def test_pow2_chunks():
    assert _pow2_chunks(16, 16) == [16]
    assert _pow2_chunks(23, 16) == [16, 4, 2, 1]
    assert sum(_pow2_chunks(64, 8)) == 64


def test_port_imports_neither_jax_nor_rapid_tpu():
    """In a fresh interpreter, the port (its simulator bridge, protocol
    classes, socket gateway, nemesis search, forensics timeline, the gRPC
    wire's codec and its HTTP/2 transport and their CLIs, statusz and slo
    too) and chip_smoke.py load
    no module of JAX, of the JAX package, of msgpack, of grpc or of
    protobuf."""
    code = (
        "import runpy, sys\n"
        "import rapid_tpu_torch.sim.driver, rapid_tpu_torch.sim.classic\n"
        "import rapid_tpu_torch.sim.profile_decision\n"
        "import rapid_tpu_torch.observability, rapid_tpu_torch.profiling\n"
        "import rapid_tpu_torch.runtime.jitwatch, rapid_tpu_torch.settings\n"
        "import rapid_tpu_torch.forensics.hlc\n"
        "import rapid_tpu_torch.sim.bridge, rapid_tpu_torch.types\n"
        "import rapid_tpu_torch.runtime.futures\n"
        "import rapid_tpu_torch.messaging.gateway, rapid_tpu_torch.cli.gateway\n"
        "import rapid_tpu_torch.search, rapid_tpu_torch.search.checkers\n"
        "import rapid_tpu_torch.search.coverage, rapid_tpu_torch.search.generator\n"
        "import rapid_tpu_torch.search.fabric, rapid_tpu_torch.search.runner\n"
        "import rapid_tpu_torch.search.shrinker, rapid_tpu_torch.search.hunt\n"
        "import rapid_tpu_torch.forensics.timeline\n"
        "import rapid_tpu_torch.cli.hunt, rapid_tpu_torch.cli.forensics\n"
        "import rapid_tpu_torch.cli.statusz, rapid_tpu_torch.cli.slo\n"
        "import rapid_tpu_torch.messaging.grpc_transport, rapid_tpu_torch.messaging.http2\n"
        "import rapid_tpu_torch.messaging.proto_wire, rapid_tpu_torch.messaging.wire_schema\n"
        "runpy.run_path('chip_smoke.py')\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'rapid_tpu', 'msgpack', 'grpc')\n"
        "             or m.startswith('google.protobuf'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stderr
