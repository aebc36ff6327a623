"""The speculative view change is invisible.

While the host waits for a batch's decision words, a worker thread builds
the view change the fault plane predicts (configuration-id fold, fresh
state); the driver takes the results only when the decision matches. With
speculation on and off the port must give the JAX package's records, and
each other's, on one device and on a mesh; with it on, the prediction must
really be consumed."""

import sys
import threading

import numpy as np
import pytest

from rapid_tpu.sim.driver import Simulator as JaxSimulator
from rapid_tpu_torch.shard.engine import make_mesh
from rapid_tpu_torch.sim.driver import Simulator
from test_fuzz_parity import BATCH, CAPACITY, N_START, generate_and_run

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py


def _summary(records):
    return [(r.cut.tolist(), r.configuration_id, r.virtual_time_ms, r.membership_size)
            for r in records]


def _hits(sim):
    return (sim.metrics.get("speculation_hits_config_id")
            + sim.metrics.get("speculation_hits_fresh_state"))


def _port(n, seed, speculate, mesh=None):
    where = {"mesh": mesh} if mesh is not None else {"device": "cpu"}
    return Simulator(n, seed=seed, speculate=speculate, **where)


def _three_changes(sim):
    recs = []
    sim.crash([3, 7, 11])
    recs.append(sim.run_until_decision(max_rounds=32, batch=8))
    sim.leave([20, 21])
    recs.append(sim.run_until_decision(max_rounds=32, batch=8))
    sim.crash([30])
    recs.append(sim.run_until_decision(max_rounds=32, batch=8))
    return recs


def test_speculative_view_change_matches_unspeculated_run():
    """Twin of tests/test_sim_engine.py's: records, config ids and
    follow-on view changes identical with and without speculation, and
    equal to the JAX package's."""
    want = _summary(_three_changes(JaxSimulator(60, seed=21, speculate=True)))
    for speculate in (True, False):
        sim = _port(60, 21, speculate)
        assert _summary(_three_changes(sim)) == want
        assert (_hits(sim) > 0) == speculate


def _stale_prediction(sim):
    sim.crash([5, 6])
    # too short a batch to decide: the worker speculates, then the world
    # changes under it
    assert sim.run_until_decision(max_rounds=4, batch=4) is None
    sim.revive([6])
    sim.crash([7])
    recs = []
    while sim.membership_size > 58:
        rec = sim.run_until_decision(max_rounds=64, batch=16)
        assert rec is not None
        recs.append(rec)
    return recs


def test_speculation_discarded_when_prediction_wrong():
    """Twin of tests/test_sim_engine.py's: a revive between speculation and
    the decision invalidates the speculated alive mask; the run falls back
    and stays equal to the unspeculated one and to JAX's."""
    want = _summary(_stale_prediction(JaxSimulator(60, seed=22, speculate=True)))
    for speculate in (True, False):
        recs = _stale_prediction(_port(60, 22, speculate))
        assert set().union(*(set(r.cut.tolist()) for r in recs)) == {5, 7}
        assert _summary(recs) == want


def _replay(script, fuzz_seed, speculate, mesh=None):
    """The fuzz script of tests/test_fuzz_parity.py on the port."""
    where = {"mesh": mesh} if mesh is not None else {"device": "cpu"}
    sim = Simulator(N_START, capacity=CAPACITY, seed=fuzz_seed, speculate=speculate, **where)
    history = []
    for kind, args in script:
        if kind == "crash":
            sim.crash(np.array(args))
        elif kind == "revive":
            sim.revive(np.array(args))
        elif kind == "leave":
            sim.leave(np.array(args))
        elif kind == "join":
            sim.request_joins(np.array(args))
        rec = sim.run_until_decision(max_rounds=BATCH, batch=BATCH)
        if rec is not None:
            history.append((tuple(sorted(int(i) for i in rec.cut)), rec.configuration_id,
                            rec.membership_size, rec.virtual_time_ms))
    return history, sim


@pytest.mark.parametrize("fuzz_seed", [13, 14, 17, 18])
def test_fuzzed_schedule_identical_without_speculation(fuzz_seed):
    """Arbitrary crash/revive/leave/join interleavings between short
    batches, the regime where predictions go stale: the port with
    speculation on and off replays the JAX history exactly, and only the
    speculating run consumed predictions."""
    script, jax_history, _ = generate_and_run(fuzz_seed)
    assert jax_history, f"schedule decided nothing: {script}"
    spec_history, spec_sim = _replay(script, fuzz_seed, True)
    plain_history, plain_sim = _replay(script, fuzz_seed, False)
    assert spec_history == jax_history, f"schedule: {script}"
    assert plain_history == jax_history, f"schedule: {script}"
    assert _hits(spec_sim) > 0, f"speculation never consumed; schedule: {script}"
    assert _hits(plain_sim) == 0


@pytest.mark.parametrize("fuzz_seed", [13, 17])
def test_fuzzed_schedule_identical_without_speculation_on_mesh(fuzz_seed):
    """The same on a mesh of four CPU shards, where the worker also places
    the predicted state on the mesh."""
    script, jax_history, _ = generate_and_run(fuzz_seed)
    mesh = make_mesh(devices=["cpu"] * 4)
    spec_history, spec_sim = _replay(script, fuzz_seed, True, mesh=mesh)
    plain_history, plain_sim = _replay(script, fuzz_seed, False, mesh=mesh)
    assert spec_history == plain_history == jax_history, f"schedule: {script}"
    assert _hits(spec_sim) > 0 and _hits(plain_sim) == 0


@pytest.mark.parametrize("mesh_shards", [0, 4])
def test_lossy_runs_draw_alike_with_and_without_speculation(mesh_shards):
    """Below drop probability 1.0 the records depend on every draw of the
    random-loss generators: the worker creates and advances none, so both
    runs decide alike, round for round."""
    records = []
    for speculate in (True, False):
        mesh = make_mesh(devices=["cpu"] * mesh_shards) if mesh_shards else None
        sim = _port(40, 9, speculate, mesh=mesh)
        sim.ingress_loss(np.array([4, 19]), 0.6)
        recs = [sim.run_until_decision(max_rounds=64, batch=4)]
        sim.crash(np.array([30]))
        recs.append(sim.run_until_decision(max_rounds=64, batch=4))
        assert all(r is not None for r in recs)
        records.append(_summary(recs))
    assert records[0] == records[1]


def test_worker_is_joined_and_spec_reset():
    before = threading.active_count()
    sim = _port(30, 3, True)
    sim.crash(np.array([2]))
    assert sim.run_until_decision(max_rounds=32) is not None
    assert threading.active_count() == before
    assert sim._spec is None
    assert sim.metrics.get("speculation_hits_fresh_state") == 1


def test_no_speculation_for_joins_or_an_unchanged_fault_plane():
    sim = Simulator(20, capacity=24, seed=5, device="cpu")
    assert sim._speculate_view_change() is None  # nothing predicted
    sim.request_joins(np.array([21]))
    sim.crash(np.array([4]))
    assert sim._speculate_view_change() is None  # joins are never speculated
    sim.cancel_join(21)
    worker = sim._speculate_view_change()
    worker.join(timeout=60)
    assert not worker.is_alive() and sim._spec is not None
    assert sim._speculate_view_change() is None  # already speculated
    sim.set_auto_vote(4, True)
    assert sim._spec is None  # a changed vote owner voids it


def test_speculation_under_a_short_switch_interval():
    """The worker and the dispatch thread interleave at every few
    bytecodes: the replay still equals the unspeculated one."""
    script, jax_history, _ = generate_and_run(14)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        history, sim = _replay(script, 14, True)
    finally:
        sys.setswitchinterval(interval)
    assert history == jax_history and _hits(sim) > 0


def test_a_sync_in_the_worker_is_a_violation(monkeypatch):
    """A worker that meets a sync debug error records it in jitwatch's
    violations (the main thread's timed window cannot see it) and leaves
    the decision to the unspeculated path, which still decides."""
    from rapid_tpu_torch.runtime import jitwatch

    def synchronizing_build(active, alive):
        raise RuntimeError("called a synchronizing CUDA operation")

    sim = _port(30, 3, True)
    monkeypatch.setattr(sim, "_build_state", synchronizing_build)
    sim.crash(np.array([2]))
    jitwatch.consume_violations()
    sim._speculate_view_change().join()
    found = jitwatch.consume_violations()
    assert sim._spec is None and len(found) == 1 and "speculation worker" in found[0]
    monkeypatch.undo()
    assert sim.run_until_decision(max_rounds=32) is not None
    assert sim.metrics.get("speculation_hits_fresh_state") == 1
