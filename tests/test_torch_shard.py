"""The port's multi-device round loop (``rapid_tpu_torch/shard/engine.py``)
and the driver's ``mesh``, against the JAX package's sharded engine and
driver (``rapid_tpu/shard/engine.py`` on the forced 8-device CPU mesh of
tests/conftest.py) and against the port's single-device engine. It holds a
twin of every test of tests/test_sharded_engine.py and
tests/test_sharded_driver.py, and of ``__graft_entry__.dryrun_multichip(8)``.
The port's meshes put every shard on the CPU: ``make_mesh(devices=["cpu"] *
8)``, and ``shape=(2, 4)`` for the 2D cases.

Tolerance: exact. Every ``SimState`` field, the PRNG key included, is
compared bit for bit: the port's sharded run with JAX's sharded run, with and
without random loss (each shard draws from the round's probe key folded with
its index, threefry's bits in both packages), and the scan runner with the
"until" runner; without random loss also with the port's single-device run.
Lossy drivers are held to JAX's record for record: cut, configuration id,
virtual time and round. A sharded lossy run differs from a single-device one
in both packages (the fold), so those two compare by cut and configuration id.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import rapid_tpu.shard.engine as jshard
from rapid_tpu.sim import engine as jeng
from rapid_tpu.sim.driver import Simulator as JaxSimulator
from rapid_tpu.sim.topology import VirtualCluster
from rapid_tpu_torch.shard import engine as shard
from rapid_tpu_torch.shard.engine import (
    gather_state,
    make_mesh,
    make_multihost_mesh,
    make_sharded_run,
    make_sharded_run_until,
    place_inputs,
    place_state,
)
from rapid_tpu_torch.sim import engine as teng
from rapid_tpu_torch.sim import kernels, threefry
from rapid_tpu_torch.sim.driver import Simulator

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py

CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def jax_mesh():
    assert len(jax.devices()) == 8, "conftest should have forced 8 CPU devices"
    return jshard.make_mesh(8)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(devices=CPU8)


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


def _fields(state):
    """Every field of a port state as numpy, gathered from a mesh."""
    if isinstance(state, shard.ShardedState):
        state = gather_state(state)
    return teng.state_to_numpy(state)


def _assert_equal(port, reference, what):
    """``port`` (a port state) equals ``reference`` (a port state or a JAX
    state), every field, dtype included."""
    got = _fields(port)
    if isinstance(reference, teng.SimState):
        want = _fields(reference)
    else:
        want = {name: np.asarray(getattr(reference, name)) for name in got}
    for name, value in got.items():
        assert value.dtype == want[name].dtype, (what, name)
        np.testing.assert_array_equal(value, want[name], err_msg=f"{what}: field {name}")


def build(c=64, seed=21, **overrides):
    """JAX and port configs and the same fresh state in both packages."""
    config = jeng.SimConfig(capacity=c, **overrides)
    vc = VirtualCluster.synthesize(c, config.k, seed=seed)
    state = jeng.initial_state(config, vc, np.ones(c, dtype=bool), seed=seed)
    return config, _port_config(config), state, _port_state(config, state)


def _three_way(jax_mesh, mesh, jconfig, pconfig, jstate, pstate, alive, rounds=12):
    """The same rounds sharded in JAX, sharded in the port and on one port
    device; every field compared. Returns the port's sharded state."""
    jinputs = jeng.const_inputs(jconfig, alive)
    pinputs = teng.const_inputs(pconfig, alive, device="cpu")
    jout = jshard.make_sharded_run(jconfig, jax_mesh, rounds=rounds)(
        jshard.place_state(jstate, jax_mesh), jshard.place_inputs(jinputs, jax_mesh))
    out = make_sharded_run(pconfig, mesh, rounds=rounds)(
        place_state(pstate, mesh), place_inputs(pinputs, mesh))
    single = teng.run_rounds_const(pconfig, pstate, pinputs, rounds, False)
    _assert_equal(out, jout, "port sharded vs JAX sharded")
    _assert_equal(out, single, "port sharded vs port single-device")
    return out


def _cut(state):
    return set(np.flatnonzero(state.proposal.numpy()).tolist())


# --------------------------------------------------------------------- #
# Twins of tests/test_sharded_engine.py
# --------------------------------------------------------------------- #


def test_sharded_crash_matches_single_device(jax_mesh, mesh):
    jconfig, pconfig, jstate, pstate = build()
    alive = np.ones(64, dtype=bool)
    alive[[5, 40, 41]] = False
    out = _three_way(jax_mesh, mesh, jconfig, pconfig, jstate, pstate, alive)
    assert bool(out.decided) and _cut(out) == {5, 40, 41}


def test_sharded_state_is_actually_sharded(jax_mesh, mesh):
    jconfig, pconfig, jstate, pstate = build()
    placed = place_state(pstate, mesh)
    assert len(placed.rows) == 8 and placed.fd_fail is None
    assert len(jshard.place_state(jstate, jax_mesh).fd_fail.addressable_shards) == 8
    for s, block in enumerate(placed.rows):
        assert block["fd_fail"].shape == (64 // 8, pconfig.k)
        assert torch.equal(block["subjects"], pstate.subjects[8 * s:8 * (s + 1)])
        # a fresh block, not a view of the whole plane
        assert block["alerted"].untyped_storage().data_ptr() != (
            pstate.alerted.untyped_storage().data_ptr())
    # replicated fields are whole, once, on the home device
    assert placed.reports.shape == (pconfig.groups, 64, pconfig.k)
    assert placed.reports.device == mesh.home
    tags = shard.state_shardings(mesh)
    assert {f for f in teng._FIELDS if getattr(tags, f) == shard.ROW} == set(
        shard.ROW_STATE_FIELDS)
    assert shard.input_shardings(mesh).probe_drop == shard.ROW
    _assert_equal(gather_state(placed), pstate, "place then gather")


def test_sharded_no_fault_no_decision(jax_mesh, mesh):
    jconfig, pconfig, jstate, pstate = build(seed=22)
    out = _three_way(jax_mesh, mesh, jconfig, pconfig, jstate, pstate,
                     np.ones(64, dtype=bool), rounds=8)
    assert not bool(out.decided)
    assert int(out.round) == 8


def test_sharded_uneven_capacity_rejected(mesh):
    """Capacity must divide the mesh for row sharding."""
    config = teng.SimConfig(capacity=60)  # 60 % 8 != 0
    with pytest.raises(AssertionError, match="divide evenly"):
        make_sharded_run(config, mesh, rounds=2)
    with pytest.raises(AssertionError, match="divide evenly"):
        make_sharded_run_until(config, mesh)
    with pytest.raises(AssertionError, match="divide evenly"):
        Simulator(60, mesh=mesh)


def test_sharded_windowed_fd_matches_single_device(jax_mesh, mesh):
    jconfig, pconfig, jstate, pstate = build(seed=23, fd_policy="windowed")
    alive = np.ones(64, dtype=bool)
    alive[[9, 50]] = False
    out = _three_way(jax_mesh, mesh, jconfig, pconfig, jstate, pstate, alive)
    assert bool(out.decided) and _cut(out) == {9, 50}


def test_2d_dcn_ici_mesh_matches_single_device():
    mesh2d = make_mesh(shape=(2, 4), devices=CPU8)
    assert mesh2d.axis_names == ("dcn", "ici")
    assert mesh2d.shape == {"dcn": 2, "ici": 4}
    jconfig, pconfig, jstate, pstate = build(seed=29)
    alive = np.ones(64, dtype=bool)
    alive[[7, 33]] = False
    out = _three_way(jshard.make_mesh(shape=(2, 4)), mesh2d, jconfig, pconfig, jstate,
                     pstate, alive)
    assert _cut(out) == {7, 33}


def test_make_mesh_1d_shape_names_ici():
    assert make_mesh(shape=(8,), devices=CPU8).axis_names == ("ici",)
    assert jshard.make_mesh(shape=(8,)).axis_names == ("ici",)


def test_make_multihost_mesh_rejects_uneven_rows():
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="uneven devices per process"):
        make_multihost_mesh(hosts=[[cpu, cpu], [cpu]])
    m = make_multihost_mesh(chips_per_host=1, hosts=[[cpu, cpu], [cpu]])
    assert m.axis_names == ("dcn", "ici")
    assert m.devices.shape == (2, 1)


# --------------------------------------------------------------------- #
# Twins of tests/test_sharded_driver.py
# --------------------------------------------------------------------- #


def _summary(rec):
    return rec and (sorted(rec.cut.tolist()), rec.configuration_id, rec.virtual_time_ms)


def _drive(sims, step):
    """``step`` on each simulator, the port's first; records and states
    must be equal."""
    recs = [step(sim) for sim in sims]
    assert len({repr(_summary(r)) for r in recs}) == 1, [_summary(r) for r in recs]
    for sim in sims[1:]:
        _assert_equal(sims[0].state, sim.state, "driver state")
    return recs[0]


def test_sharded_driver_crash_matches_single_device(jax_mesh, mesh):
    sharded = Simulator(256, seed=41, mesh=mesh)
    jax_sharded = JaxSimulator(256, seed=41, mesh=jax_mesh)
    for sim in (sharded, jax_sharded):
        sim.crash(np.array([10, 77, 200]))
    # a dispatch that does not decide: the mid-run states equal, bit for bit
    assert _drive([sharded, jax_sharded],
                  lambda s: s.run_until_decision(max_rounds=5, batch=5)) is None
    rec = _drive([sharded, jax_sharded], lambda s: s.run_until_decision(max_rounds=16, batch=8))
    single = Simulator(256, seed=41, device="cpu")
    single.crash(np.array([10, 77, 200]))
    single.run_until_decision(max_rounds=5, batch=5)
    assert _summary(single.run_until_decision(max_rounds=16, batch=8)) == _summary(rec)
    assert sorted(rec.cut.tolist()) == [10, 77, 200]


def test_sharded_driver_join_leave_cycle(jax_mesh, mesh):
    """Join headroom (capacity 128 > 120 members): inactive slots and the
    joiners' rows of expected observers, where the gather form of the alert
    routing could part from JAX's scatter form."""
    sims = [Simulator(120, capacity=128, seed=42, mesh=mesh),
            JaxSimulator(120, capacity=128, seed=42, mesh=jax_mesh)]
    for sim in sims:
        sim.request_joins(np.array([120, 121]))
    rec = _drive(sims, lambda s: s.run_until_decision(max_rounds=8, batch=4))
    assert sorted(rec.cut.tolist()) == [120, 121]
    assert sims[0].membership_size == 122
    for sim in sims:
        sim.leave(np.array([5]))
        sim.crash(np.array([70]))
    assert _drive(sims, lambda s: s.run_until_decision(max_rounds=1, batch=1)) is None
    # the leave's alerts arrive at once and decide first; the crash next
    rec2 = _drive(sims, lambda s: s.run_until_decision(max_rounds=16, batch=4))
    assert rec2.cut.tolist() == [5]
    rec3 = _drive(sims, lambda s: s.run_until_decision(max_rounds=16, batch=4))
    assert rec3.cut.tolist() == [70]
    assert sims[0].membership_size == 120

    ref = Simulator(120, capacity=128, seed=42, device="cpu")
    ref.request_joins(np.array([120, 121]))
    ref.run_until_decision(max_rounds=8, batch=4)
    ref.leave(np.array([5]))
    ref.crash(np.array([70]))
    ref.run_until_decision(max_rounds=1, batch=1)
    assert _summary(ref.run_until_decision(max_rounds=16, batch=4)) == _summary(rec2)
    assert _summary(ref.run_until_decision(max_rounds=16, batch=4)) == _summary(rec3)


def test_sharded_driver_windowed_policy(jax_mesh, mesh):
    sims = [Simulator(128, config=teng.SimConfig(capacity=128, fd_policy="windowed"),
                      seed=43, mesh=mesh),
            JaxSimulator(128, config=jeng.SimConfig(capacity=128, fd_policy="windowed"),
                         seed=43, mesh=jax_mesh)]
    for sim in sims:
        sim.crash(np.array([3]))
    rec = _drive(sims, lambda s: s.run_until_decision(max_rounds=20, batch=10))
    assert list(rec.cut) == [3]
    # window fills at round 10, votes arrive round 11
    assert rec.virtual_time_ms == 11 * 1000 + 100


def test_sharded_driver_staggered_phases(jax_mesh, mesh):
    records = []
    for sim in (Simulator(128, config=teng.SimConfig(capacity=128, rounds_per_interval=5),
                          seed=44, mesh=mesh),
                Simulator(128, config=teng.SimConfig(capacity=128, rounds_per_interval=5),
                          seed=44, device="cpu"),
                JaxSimulator(128, config=jeng.SimConfig(capacity=128, rounds_per_interval=5),
                             seed=44, mesh=jax_mesh)):
        sim.crash(np.array([8, 90]))
        records.append(_summary(sim.run_until_decision(max_rounds=64, batch=16)))
    assert records[0] is not None and records[0] == records[1] == records[2]


@pytest.mark.parametrize("random_loss", [False, True])
def test_sharded_until_bit_identical_to_scan(mesh, random_loss):
    """The "until" runner and the scan runner give the same state, field for
    field, the key included: the masked rounds after the decision keep it."""
    sim = Simulator(256, seed=44, mesh=mesh)
    sim.crash(np.array([7, 31]))
    if random_loss:
        sim.ingress_loss(np.array([5, 9]), 0.3)
    inputs = sim._const_inputs(sim._arm_pending_joins())
    before = _fields(sim.state)
    out_scan = sim._sharded_run(12, random_loss)(sim.state, inputs)
    out_until = sim._sharded_run_until(random_loss)(sim.state, inputs, 12)
    _assert_equal(out_until, out_scan, "until vs scan")
    assert bool(out_scan.decided)
    decided = int(out_scan.decided_round)
    assert decided < 12, "some rounds of the budget should be masked"
    key = threefry.prng_key(sim.seed)
    for _ in range(decided):
        key, _ = threefry.split(key)
    assert torch.equal(out_scan.rng_key, key), "the key splits once a round until the decision"
    after = _fields(sim.state)  # the input state is not modified
    assert all(np.array_equal(after[f], v) for f, v in before.items())


def test_sharded_decision_single_dispatch_no_rejit(mesh):
    """A mesh decision takes one dispatch when the batch covers it, and
    another batch size reuses the cached runner. The port has no metrics
    plane, so the runner is wrapped to count its dispatches."""
    sim = Simulator(256, seed=45, mesh=mesh)
    dispatches = []
    runner_for = sim._sharded_run_until

    def counting(*key):
        runner = runner_for(*key)

        def run(*args):
            dispatches.append(args[2])
            return runner(*args)
        return run

    sim._sharded_run_until = counting
    sim.crash(np.array([12]))
    rec = sim.run_until_decision(max_rounds=32, batch=32)
    assert rec is not None and list(rec.cut) == [12]
    assert dispatches == [32]
    n_cached = len(sim._sharded_runs)
    sim.crash(np.array([40]))
    rec2 = sim.run_until_decision(max_rounds=32, batch=5)
    assert rec2 is not None and list(rec2.cut) == [40]
    assert len(sim._sharded_runs) == n_cached == 1
    assert dispatches[1:] == [5, 5, 5]  # decided in round 11 of the configuration


def test_sharded_driver_2d_dcn_ici_mesh():
    records = []
    for sim in (Simulator(256, seed=47, mesh=make_mesh(shape=(2, 4), devices=CPU8)),
                Simulator(256, seed=47, device="cpu"),
                JaxSimulator(256, seed=47, mesh=jshard.make_mesh(shape=(2, 4)))):
        sim.crash(np.array([3, 99]))
        records.append(_summary(sim.run_until_decision(max_rounds=16, batch=16)))
    assert records[0][0] == [3, 99]
    assert records[0] == records[1] == records[2]


def test_multihost_mesh_entry_degenerate_single_process():
    m = make_multihost_mesh(chips_per_host=4, hosts=[CPU8])
    assert m.axis_names == ("dcn", "ici")
    assert m.shape["dcn"] == 1 and m.shape["ici"] == 4
    sim = Simulator(36, capacity=36, seed=31, mesh=m)
    sim.crash(np.array([4, 17]))
    rec = sim.run_until_decision(max_rounds=32, batch=8)
    assert rec is not None and set(rec.cut) == {4, 17}
    ref = Simulator(36, capacity=36, seed=31, device="cpu")
    ref.crash(np.array([4, 17]))
    assert _summary(ref.run_until_decision(max_rounds=32, batch=8)) == _summary(rec)


def test_multihost_mesh_with_coordinator_is_not_ported_yet():
    """(Named for when a coordinator raised.) A coordinator without a world
    size or rank is refused before anything starts; a world of one process
    over gloo gives the one-host mesh, which decides as the single device
    does. The multi-process runs are tests/test_torch_multihost.py's."""
    import socket

    import torch.distributed as dist

    with pytest.raises(ValueError, match="num_processes and process_id"):
        make_multihost_mesh(coordinator_address="localhost:1234", num_processes=2)
    assert not dist.is_initialized()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    try:
        m = make_multihost_mesh(coordinator_address=f"127.0.0.1:{port}", num_processes=1,
                                process_id=0, devices=["cpu"] * 2)
        assert dist.get_backend() == "gloo" and m.shape == {"dcn": 1, "ici": 2}
        assert (m.process_index, m.process_count, m.local_shards) == (0, 1, range(2))
        sim = Simulator(36, capacity=36, seed=31, mesh=m)
        sim.crash(np.array([4, 17]))
        rec = sim.run_until_decision(max_rounds=32, batch=8)
    finally:
        dist.destroy_process_group()
    ref = Simulator(36, capacity=36, seed=31, device="cpu")
    ref.crash(np.array([4, 17]))
    assert _summary(ref.run_until_decision(max_rounds=32, batch=8)) == _summary(rec)


# --------------------------------------------------------------------- #
# Twin of __graft_entry__.dryrun_multichip(8)
# --------------------------------------------------------------------- #


def test_dryrun_multichip_twin():
    n_devices = 8
    capacity = 16 * n_devices
    config = teng.SimConfig(capacity=capacity)
    m = make_mesh(n_devices, devices=CPU8)
    cluster = teng.VirtualCluster.synthesize(capacity, config.k, seed=0)
    active = np.ones(capacity, dtype=bool)
    state = teng.initial_state(config, cluster, active, device="cpu")
    alive = active.copy()
    alive[-2:] = False
    inputs = teng.const_inputs(config, alive, device="cpu")
    out = make_sharded_run(config, m, rounds=12)(place_state(state, m), place_inputs(inputs, m))
    assert bool(out.decided), "sharded dryrun did not reach a decision"
    assert _cut(out) == {capacity - 2, capacity - 1}

    sim = Simulator(capacity, config=config, seed=1, mesh=m)
    sim.crash(np.array([0]))
    rec = sim.run_until_decision(max_rounds=16, batch=8)
    assert rec is not None and list(rec.cut) == [0]
    assert sim.membership_size == capacity - 1
    for shape in [(2, n_devices // 2), (4, n_devices // 4)]:
        sim2 = Simulator(capacity, config=config, seed=1,
                         mesh=make_mesh(shape=shape, devices=CPU8))
        sim2.crash(np.array([0]))
        rec2 = sim2.run_until_decision(max_rounds=16, batch=8)
        assert rec2 is not None and list(rec2.cut) == [0]
        assert rec2.configuration_id == rec.configuration_id
        assert rec2.virtual_time_ms == rec.virtual_time_ms


# --------------------------------------------------------------------- #
# The port's own: join headroom at the engine, the exchange's copy path,
# random loss, the mesh's devices, snapshots, the seed rule
# --------------------------------------------------------------------- #


def test_join_headroom_and_leaves_match_jax_sharded(jax_mesh, mesh):
    """Capacity 64 > 60 members, two joiners armed (their rows hold expected
    observers) and a leave, over 12 rounds: every field equals JAX's
    sharded run and the port's single-device run."""
    jsim = JaxSimulator(60, capacity=64, seed=5, speculate=False)
    jsim.crash(np.array([11]))
    jsim.leave(np.array([30]))
    jsim.request_joins(np.array([60, 61]))
    joins = jsim._arm_pending_joins()
    jinputs = jeng.const_inputs(jsim.config, jsim.alive, join_reports=joins,
                                down_reports=np.asarray(jsim._down_reports()))
    jstate, config = jsim.state, _port_config(jsim.config)
    pstate, pinputs = _port_state(jsim.config, jstate), _port_inputs(jinputs)
    jout = jshard.make_sharded_run(jsim.config, jax_mesh, rounds=12)(
        jshard.place_state(jstate, jax_mesh), jshard.place_inputs(jinputs, jax_mesh))
    out = make_sharded_run(config, mesh, 12, random_loss=False)(
        place_state(pstate, mesh), place_inputs(pinputs, mesh))
    _assert_equal(out, jout, "port sharded vs JAX sharded")
    _assert_equal(out, teng.run_rounds_const(config, pstate, pinputs, 12, False),
                  "port sharded vs port single-device")
    assert bool(out.decided)


def test_exchange_copy_path_matches_in_place_segments(mesh, monkeypatch):
    """A device other than home writes its shards' segments into one buffer,
    which is then copied into home's bitset (the peer copy between cards):
    one copy a round, its shards being consecutive in mesh order. Forced here
    on the CPU, the result is the same."""
    jconfig, pconfig, _, pstate = build(seed=24)
    alive = np.ones(64, dtype=bool)
    alive[[2, 60]] = False
    inputs = place_inputs(teng.const_inputs(pconfig, alive, device="cpu"), mesh)
    run = make_sharded_run(pconfig, mesh, 12, random_loss=False)
    want = run(place_state(pstate, mesh), inputs)
    copies = []
    real_copy = shard._copy_in
    monkeypatch.setattr(shard, "_same_device", lambda a, b: False)
    monkeypatch.setattr(shard, "_copy_in",
                        lambda segment, source: copies.append(segment.numel())
                        or real_copy(segment, source))
    got = run(place_state(pstate, mesh), inputs)
    monkeypatch.undo()
    assert copies == [8 * kernels.segment_words(8, pconfig.k)] * 12
    _assert_equal(got, want, "copied segments vs in-place segments")


@pytest.mark.parametrize("layout, calls_a_round, copies_a_round", [
    ("one device", [8], 0),           # every shard on home: one call, segments in place
    ("interleaved", [4, 4], 8),       # two devices off home, shards alternating: a copy a shard
    ("runs of 3", [3, 3, 2], 3),      # at most 3 shards a call: a call and a copy a run
])
def test_one_fd_call_a_device_group_a_round(mesh, monkeypatch, layout, calls_a_round,
                                            copies_a_round):
    """Each group of ``device_groups`` makes one ``fd_phase_rows`` call a
    round over its shards, folding each shard's own index into the probe
    key, and no ``threefry_draw`` call; groups off home copy their segments
    in. Under random loss every shard still draws from the probe key folded
    with its own index, so the state equals the one-device run's, field for
    field."""
    _, pconfig, _, pstate = build(seed=26)
    alive = np.ones(64, dtype=bool)
    alive[[4, 37]] = False
    drop = np.zeros(64, dtype=np.float32)
    drop[[9, 50]] = 0.5
    inputs = place_inputs(teng.const_inputs(pconfig, alive, drop_prob=drop, device="cpu"), mesh)
    run = make_sharded_run(pconfig, mesh, 12, random_loss=True)
    want = run(place_state(pstate, mesh), inputs)
    calls, draws, copies = [], [], []
    real_rows, real_copy = kernels.fd_phase_rows, shard._copy_in

    def rows(*a, **kw):
        calls.append(len(kw["row0"]))
        draws.append(list(kw["fold"]))
        return real_rows(*a, **kw)

    monkeypatch.setattr(kernels, "fd_phase_rows", rows)
    monkeypatch.setattr(kernels, "threefry_draw", None)  # any call would raise
    monkeypatch.setattr(shard, "_copy_in",
                        lambda segment, source: copies.append(1) or real_copy(segment, source))
    if layout != "one device":
        monkeypatch.setattr(shard, "_same_device", lambda a, b: False)
    if layout == "interleaved":
        cpu = torch.device("cpu")
        monkeypatch.setattr(shard, "device_groups",
                            lambda m: [(cpu, [0, 2, 4, 6]), (cpu, [1, 3, 5, 7])])
    if layout == "runs of 3":
        monkeypatch.setattr(kernels, "MAX_SHARDS_PER_CALL", 3)
    got = run(place_state(pstate, mesh), inputs)
    monkeypatch.undo()
    assert calls == calls_a_round * 12
    assert [len(d) for d in draws] == calls
    assert sorted(sum(draws[:len(calls_a_round)], [])) == list(range(8))
    assert len(copies) == copies_a_round * 12
    _assert_equal(got, want, layout)
    assert bool(got.decided)


def test_device_groups_by_device_in_mesh_order(monkeypatch):
    cpu, meta = torch.device("cpu"), torch.device("meta")
    m = shard.Mesh(np.array([cpu, meta, cpu, meta, cpu, cpu], dtype=object), ("nodes",))
    assert shard.device_groups(m) == [(cpu, [0, 2, 4, 5]), (meta, [1, 3])]
    assert shard.device_groups(make_mesh(devices=CPU8)) == [(cpu, list(range(8)))]
    monkeypatch.setattr(kernels, "MAX_SHARDS_PER_CALL", 3)
    assert shard.device_groups(m) == [(cpu, [0, 2, 4]), (cpu, [5]), (meta, [1, 3])]


def _lossy_record(sim, rec):
    """A decision's record with the rounds the simulator ran to it."""
    return _summary(rec) + (sim.metrics.get("rounds"),)


@pytest.mark.parametrize("probability", [1.0, 0.5, 0.8])
def test_lossy_sharded_driver_matches_jax_by_outcome(jax_mesh, mesh, probability):
    """Ingress loss on a mesh and on one device, in both packages: each
    port simulator equals its JAX twin record for record (cut, configuration
    id, virtual time, round) and state for state, the key included; the
    mesh and the single device agree on the cut and configuration id (their
    draws differ by the fold, in both packages)."""
    sims = [Simulator(256, seed=46, mesh=mesh),
            JaxSimulator(256, seed=46, mesh=jax_mesh),
            Simulator(256, seed=46, device="cpu"),
            JaxSimulator(256, seed=46)]
    recs = []
    for sim in sims:
        sim.ingress_loss(np.array([11, 140]), probability)
        recs.append(sim.run_until_decision(max_rounds=64, batch=16))
    assert all(r is not None for r in recs)
    assert len({(tuple(r.cut.tolist()), r.configuration_id) for r in recs}) == 1
    assert recs[0].cut.tolist() == [11, 140]
    assert _lossy_record(sims[0], recs[0]) == _lossy_record(sims[1], recs[1])
    assert _lossy_record(sims[2], recs[2]) == _lossy_record(sims[3], recs[3])
    _assert_equal(sims[0].state, sims[1].state, "mesh, after the view change")
    _assert_equal(sims[2].state, sims[3].state, "single device, after the view change")
    if probability == 1.0:
        assert len({r.virtual_time_ms for r in recs}) == 1


@pytest.mark.parametrize("shape, policy", [((8,), "cumulative"), ((2, 4), "cumulative"),
                                           ((8,), "windowed")])
def test_sharded_random_loss_matches_jax_sharded(shape, policy):
    """The sharded round under ingress loss 0.5, mid-decision: every field
    equals JAX's sharded round's, the key and the planes the draw decided
    included, after each of three dispatches."""
    jconfig, pconfig, jstate, pstate = build(seed=27, fd_policy=policy)
    alive = np.ones(64, dtype=bool)
    alive[[6, 45]] = False
    drop = np.zeros(64, dtype=np.float32)
    drop[[3, 17, 30, 52]] = 0.5
    jinputs = jeng.const_inputs(jconfig, alive, drop_prob=drop)
    pinputs = teng.const_inputs(pconfig, alive, drop_prob=drop, device="cpu")
    jmesh = jshard.make_mesh(8) if len(shape) == 1 else jshard.make_mesh(shape=shape)
    pmesh = make_mesh(devices=CPU8) if len(shape) == 1 else make_mesh(shape=shape, devices=CPU8)
    jrun = jshard.make_sharded_run(jconfig, jmesh, rounds=4, random_loss=True)
    prun = make_sharded_run(pconfig, pmesh, 4, random_loss=True)
    jout, out = jshard.place_state(jstate, jmesh), place_state(pstate, pmesh)
    for _ in range(3):
        jout = jrun(jout, jshard.place_inputs(jinputs, jmesh))
        out = prun(out, place_inputs(pinputs, pmesh))
        _assert_equal(out, jout, "port sharded vs JAX sharded, lossy")


def test_mesh_devices_and_home():
    with pytest.raises(AssertionError, match="needs 9"):
        make_mesh(9, devices=CPU8)
    with pytest.raises(AssertionError, match="needs 8 devices"):
        make_mesh(shape=(2, 4), devices=["cpu"] * 4)
    m = make_mesh(shape=(2, 2), devices=CPU8)
    assert m.size == 4 and m.home == torch.device("cpu")
    assert Simulator(64, mesh=m).device == m.home


def test_make_mesh_without_cuda_or_devices_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices="):
        make_mesh(8)
    with pytest.raises(RuntimeError, match="devices="):
        make_multihost_mesh()


def test_from_configuration_onto_a_mesh(mesh, tmp_path):
    sim = Simulator(64, seed=12, device="cpu")
    sim.crash(np.array([63]))
    assert sim.run_until_decision(max_rounds=16) is not None
    path = str(tmp_path / "snap.npz")
    sim.save_configuration(path)
    restored = Simulator.from_configuration(path, mesh=mesh)
    assert restored.mesh is mesh and restored.configuration_id() == sim.configuration_id()
    for s in (sim, restored):
        s.crash(np.array([7]))
    assert _summary(restored.run_until_decision(max_rounds=16)) == _summary(
        sim.run_until_decision(max_rounds=16))
    with pytest.raises(AssertionError, match="divide evenly"):
        Simulator.from_configuration(path, mesh=make_mesh(shape=(3,), devices=["cpu"] * 3))


def test_shard_seed_rule(mesh):
    """A shard's draw comes from the round's probe key folded with its
    linear index, JAX's rule: distinct shards draw differently, the same
    shard the same, and one call over several shards stacks what each
    shard's own call draws."""
    key = threefry.prng_key(5)
    whole = kernels.threefry_draw(key, 3, 4, list(mesh.local_shards))
    alone = [kernels.threefry_draw(key, 3, 4, [s]) for s in mesh.local_shards]
    assert all(torch.equal(whole[0], k) for k, _ in alone)
    assert torch.equal(whole[1], torch.cat([d for _, d in alone]))
    assert not torch.equal(alone[0][1], alone[1][1])
    jkey, jprobe = jax.random.split(jax.random.PRNGKey(5))
    np.testing.assert_array_equal(whole[0].numpy().astype(np.uint32), np.asarray(jkey))
    for s, (_, d) in enumerate(alone):
        want = jax.random.uniform(jax.random.fold_in(jprobe, s), (3, 4))
        np.testing.assert_array_equal(d.numpy(), np.asarray(want))


def _stalled(sims, n=1000, n_blind=260):
    """A blind delivery group of more than F members never hears a
    broadcast, so the fast round stalls on the crashed pair (the scenario of
    tests/test_torch_classic.py)."""
    group_of = np.zeros(n, dtype=np.int32)
    group_of[n - n_blind:] = 1
    victims = np.array([5, 6])
    for sim in sims:
        sim.set_delivery_groups(group_of)
        sim.crash(victims)
        sim.drop_broadcasts(1, np.arange(n))
    return victims


class _RiggedRng:
    """Expovariate timers with two chosen slots firing first."""

    def __init__(self, first, second):
        self.first, self.second = first, second

    def exponential(self, scale, size):
        t = np.full(size, 1_000_000.0)
        t[self.first], t[self.second] = 0.2, 0.6
        return t


def _classic_record(rec):
    return rec and (_summary(rec), rec.membership_size, rec.via_classic_round)


def test_classic_fallback_on_a_mesh_matches_jax_and_single_device(jax_mesh, mesh):
    """The classic round runs on home, on the replicated acceptor arrays; a
    race of two coordinators, the later one stealing the quorum."""
    sims = [Simulator(1000, config=teng.SimConfig(capacity=1000, groups=2), seed=17, mesh=mesh),
            JaxSimulator(1000, config=jeng.SimConfig(capacity=1000, groups=2), seed=17,
                         mesh=jax_mesh),
            Simulator(1000, config=teng.SimConfig(capacity=1000, groups=2), seed=17,
                      device="cpu")]
    victims = _stalled(sims)
    for sim in sims:
        sim._host_rng = _RiggedRng(0, 1)
    recs = [_classic_record(sim.run_until_decision(max_rounds=16, batch=8,
                                                   classic_fallback_after_rounds=2))
            for sim in sims]
    assert recs[0] == recs[1] == recs[2]
    assert recs[0][0][0] == victims.tolist() and recs[0][2]


def test_announcement_stop_and_extern_votes_on_a_mesh(jax_mesh, mesh):
    """The bridge's pattern on a mesh: pause at the announcement, register
    external votes, then decide; states, announcements and records equal
    JAX's sharded driver."""
    sims = [Simulator(1000, config=teng.SimConfig(capacity=1000, groups=2, extern_proposals=2),
                      seed=42, mesh=mesh),
            JaxSimulator(1000, config=jeng.SimConfig(capacity=1000, groups=2,
                                                     extern_proposals=2),
                         seed=42, mesh=jax_mesh)]
    victims = _stalled(sims)
    assert _drive(sims, lambda s: s.run_until_decision(max_rounds=40,
                                                       stop_when_announced=True)) is None
    for a, b in zip(sims[0].last_announcement, sims[1].last_announcement):
        np.testing.assert_array_equal(a, b)
    assert sims[0].virtual_ms == sims[1].virtual_ms
    for sim in sims:
        for slot in range(740, 760):
            sim.set_auto_vote(slot, False)
            assert sim.register_extern_vote(slot, victims)
    _assert_equal(sims[0].state, sims[1].state, "after the extern votes")
    rec = _drive(sims, lambda s: s.run_until_decision(max_rounds=8,
                                                      classic_fallback_after_rounds=None))
    assert rec.cut.tolist() == victims.tolist()
