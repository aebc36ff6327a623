"""The port's multi-process mesh across real OS processes: the twin of
tests/test_multihost_processes.py.

``rapid_tpu_torch.cli.multihost_sim --device cpu`` runs in 2 or 4 processes
that meet over ``torch.distributed`` (gloo) on localhost, each holding its
row of a ("dcn", "ici") mesh of CPU shards. Every process must report the
record (cut, protocol time, configuration id, rounds run) of the port's
single-process run on a mesh of the same shape, and of JAX's ``Simulator``
on a mesh of that shape over the 8 CPU devices tests/conftest.py forces.
Under random ingress loss each global shard draws from the round's probe key
folded with its global index, threefry's bits as in JAX, so a lossy
multi-process run equals the port's single-process run and JAX's run record
for record, and its state (the key included) equals both, field by field,
mid-decision. Uneven rows fail in every process with the width message.

Every child has a wall timeout and is killed in ``finally``. Run as a
script (``--worker``), this file is the child that holds the gathered state
(``shard.engine.gather_state``, a collective) against the single-process
mesh.

Tolerance: exact.
"""

import json
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py

REPO = Path(__file__).resolve().parent.parent
N = 256
SEED = 42
CHILD_TIMEOUT_S = 90
_RECORD = re.compile(r"cut (\d+) nodes in (\d+) ms protocol time .*; config (-?\d+)")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_processes(tmp_path, argv_of, num_processes, name):
    """Start ``num_processes`` children (``argv_of(pid, port)``), highest
    rank first, wait for all under a wall timeout and kill any left in
    ``finally``; returns each one's (exit code, output)."""
    port = _free_port()
    procs, logs = [], []
    try:
        for pid in reversed(range(num_processes)):
            log = open(tmp_path / f"{name}-{pid}.log", "w")
            logs.append(log)
            procs.append((pid, subprocess.Popen(
                [sys.executable, *argv_of(pid, port)], stdout=log, stderr=subprocess.STDOUT,
                env=dict(os.environ, PYTHONUNBUFFERED="1"), cwd=str(REPO))))
        rcs = {pid: p.wait(timeout=CHILD_TIMEOUT_S) for pid, p in procs}
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    return [(rcs[pid], (tmp_path / f"{name}-{pid}.log").read_text())
            for pid in range(num_processes)]


def _cli(num_processes, devices_per_host, *extra):
    def argv(pid, port):
        return ["-m", "rapid_tpu_torch.cli.multihost_sim", "--coordinator", f"127.0.0.1:{port}",
                "--num-processes", str(num_processes), "--process-id", str(pid),
                "--devices-per-host", str(devices_per_host), "--n", str(N),
                "--seed", str(SEED), "--device", "cpu", *extra]
    return argv


def _records(outputs, num_processes, devices_per_host):
    records, stats = [], []
    for pid, (rc, text) in enumerate(outputs):
        assert rc == 0, f"process {pid} failed:\n{text}"
        assert f"mesh {{'dcn': {num_processes}, 'ici': {devices_per_host}}}" in text, text
        m = _RECORD.search(text)
        assert m, f"no record line in process {pid}'s output:\n{text}"
        stats.append(json.loads(text.split("stats ", 1)[1].splitlines()[0]))
        records.append(tuple(int(g) for g in m.groups()) + (stats[-1]["rounds"],))
    return records, stats


def _victims():
    rng = np.random.default_rng(SEED)
    return rng.choice(N, max(1, int(N * 0.01)), replace=False)


def _port_record(shape, loss=0.0):
    """The same scenario in one process on the port's mesh of ``shape``."""
    from rapid_tpu_torch.shard.engine import make_mesh
    from rapid_tpu_torch.sim.driver import Simulator

    sim = Simulator(N, seed=SEED, mesh=make_mesh(shape=shape, devices=["cpu"] * 4))
    victims = _victims()
    if loss:
        sim.ingress_loss(victims, loss)
    else:
        sim.crash(victims)
    rec = sim.run_until_decision(max_rounds=64 if loss else 16, batch=16)
    assert rec is not None and set(rec.cut) == set(victims)
    return len(rec.cut), rec.virtual_time_ms, rec.configuration_id, sim.metrics.get("rounds")


def _jax_record(shape, loss=0.0):
    from rapid_tpu.shard.engine import make_mesh
    from rapid_tpu.sim.driver import Simulator

    sim = Simulator(N, seed=SEED, mesh=make_mesh(shape=shape))
    victims = _victims()
    if loss:
        sim.ingress_loss(victims, loss)
    else:
        sim.crash(victims)
    rec = sim.run_until_decision(max_rounds=64 if loss else 16, batch=16)
    assert rec is not None and set(rec.cut) == set(victims)
    return len(rec.cut), rec.virtual_time_ms, rec.configuration_id, sim.metrics.get("rounds")


@pytest.mark.parametrize("num_processes,devices_per_host", [(2, 2), (4, 1)])
def test_every_process_reports_the_single_process_record(tmp_path, num_processes,
                                                         devices_per_host):
    shape = (num_processes, devices_per_host)
    outputs = _run_processes(tmp_path, _cli(num_processes, devices_per_host), num_processes,
                             "crash")
    records, stats = _records(outputs, num_processes, devices_per_host)
    assert len(set(records)) == 1, f"processes diverged: {records}"
    assert records[0] == _port_record(shape) == _jax_record(shape)
    for pid, st in enumerate(stats):
        # one decision dispatch of 16 rounds: one all-gather a round, every
        # shard's segment in it, each wait an audited sync
        assert st["process"] == pid and st["processes"] == num_processes
        assert st["shards"] == list(range(pid * devices_per_host,
                                          (pid + 1) * devices_per_host))
        assert st["collectives"] == 16
        assert st["syncs"]["shard.exchange"] == 16 and st["syncs"]["sim.decision_words"] == 1
        words = -(-(N // 4) * 10 // 32) + 1
        assert st["bytes_a_collective"] == 4 * words * 4


def test_lossy_processes_equal_the_single_process_run(tmp_path):
    """Ingress loss 0.5: each global shard draws from the probe key folded
    with its index, so every process reports the single-process record and
    JAX's exactly (protocol time and rounds included)."""
    outputs = _run_processes(tmp_path, _cli(2, 2, "--ingress-loss", "0.5"), 2, "lossy")
    records, _ = _records(outputs, 2, 2)
    assert len(set(records)) == 1, records
    assert records[0] == _port_record((2, 2), loss=0.5) == _jax_record((2, 2), loss=0.5)


def test_uneven_devices_per_process_fail_loudly_in_every_process(tmp_path):
    def argv(pid, port):
        return _cli(2, 2 - pid)(pid, port)

    outputs = _run_processes(tmp_path, argv, 2, "uneven")
    for pid, (rc, text) in enumerate(outputs):
        assert rc != 0, f"process {pid} accepted the uneven shape:\n{text}"
        assert "uneven devices per process: process 0: 2, process 1: 1" in text, text


def _process_mesh(process_index, process_count=2, per_process=2):
    """Process ``process_index``'s view of a ("dcn", "ici") mesh of CPU
    shards over ``process_count`` processes (nothing here is collective)."""
    from rapid_tpu_torch.shard.engine import Mesh

    grid = np.empty((process_count, per_process), dtype=object)
    grid[:] = "cpu"
    return Mesh(grid, ("dcn", "ici"), process_index=process_index,
                process_count=process_count)


@pytest.mark.parametrize("process_index", [0, 1, 2])
def test_a_process_holds_its_own_run_of_shards_under_global_seeds(process_index):
    import torch

    from rapid_tpu_torch.shard import engine as shard
    from rapid_tpu_torch.sim import engine, kernels, threefry
    from rapid_tpu_torch.sim.driver import Simulator

    mesh = _process_mesh(process_index, process_count=3)
    local = range(2 * process_index, 2 * process_index + 2)
    assert mesh.size == 6 and mesh.local_shards == local
    assert mesh.local_devices == (torch.device("cpu"),) * 2 and mesh.home == torch.device("cpu")
    assert shard.device_groups(mesh) == [(torch.device("cpu"), list(local))]
    # a process's draw is its global shards' blocks of the whole mesh's draw
    key = threefry.prng_key(5)
    whole = kernels.threefry_draw(key, 3, 10, list(range(6)))
    mine = kernels.threefry_draw(key, 3, 10, list(local))
    assert torch.equal(mine[0], whole[0])
    assert torch.equal(mine[1], whole[1][3 * local.start:3 * local.stop])
    sim = Simulator(60, seed=2, device="cpu")
    placed = shard.place_state(sim.state, mesh)
    assert len(placed.rows) == 2 and placed.mesh is mesh
    rows = 10
    for i, s in enumerate(local):
        for name in shard.ROW_STATE_FIELDS:
            assert torch.equal(placed.rows[i][name],
                               getattr(sim.state, name)[s * rows:(s + 1) * rows]), name
    inputs = shard.place_inputs(engine.RoundInputs(
        alive=torch.ones(60, dtype=torch.bool),
        probe_drop=torch.arange(600).reshape(60, 10) % 7 == 0,
        drop_prob=torch.zeros(60), join_reports=torch.zeros((60, 10), dtype=torch.bool),
        down_reports=torch.zeros((60, 10), dtype=torch.bool),
        deliver=torch.ones((1, 60), dtype=torch.bool),
        deliver_delay=torch.zeros((1, 60), dtype=torch.int32)), mesh)
    assert [b.tolist() for b in inputs.probe_drop_rows] == [
        (torch.arange(600).reshape(60, 10) % 7 == 0)[s * rows:(s + 1) * rows].tolist()
        for s in local]


def test_bridge_and_gateway_refuse_a_multi_process_mesh():
    from rapid_tpu_torch.messaging.gateway import SwarmGateway
    from rapid_tpu_torch.sim.bridge import TpuSimMessaging
    from rapid_tpu_torch.types import Endpoint

    mesh = _process_mesh(1)
    with pytest.raises(ValueError, match="the bridge runs in one process"):
        TpuSimMessaging(None, 60, mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="the bridge runs in one process"):
        TpuSimMessaging.restore(None, "unused.npz", mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="the gateway runs in one process"):
        SwarmGateway(Endpoint.from_parts("127.0.0.1", 1), 60, mesh=mesh)


def _worker_state(path):
    return {k: v for k, v in np.load(path).items()}


def test_gathered_state_mid_decision_equals_the_single_process_mesh(tmp_path):
    """Mid-decision (five lossy rounds, no decision yet), ``gather_state``
    on every process gives the single-process mesh's state, every field bit
    for bit, the key included, and so does JAX's mesh of the same shape;
    then all three decide alike."""
    from rapid_tpu_torch.shard.engine import gather_state, make_mesh
    from rapid_tpu_torch.sim import engine
    from rapid_tpu_torch.sim.driver import Simulator

    def argv(pid, port):
        return [str(Path(__file__).resolve()), "--worker", f"127.0.0.1:{port}", str(pid),
                str(tmp_path / f"state-{pid}.npz")]

    outputs = _run_processes(tmp_path, argv, 2, "state")
    for pid, (rc, text) in enumerate(outputs):
        assert rc == 0, f"worker {pid} failed:\n{text}"
    sim = Simulator(N, seed=SEED, mesh=make_mesh(shape=(2, 2), devices=["cpu"] * 4))
    _worker_steps(sim, _victims())
    want = engine.state_to_numpy(gather_state(sim.state))
    rec = sim.run_until_decision(max_rounds=64, batch=16)
    from rapid_tpu.shard.engine import make_mesh as jax_mesh
    from rapid_tpu.sim.driver import Simulator as JaxSimulator

    jsim = JaxSimulator(N, seed=SEED, mesh=jax_mesh(shape=(2, 2)))
    _worker_steps(jsim, _victims())
    for name, value in want.items():
        np.testing.assert_array_equal(np.asarray(getattr(jsim.state, name)), value,
                                      err_msg=f"JAX's mesh: {name}")
    jrec = jsim.run_until_decision(max_rounds=64, batch=16)
    assert [len(jrec.cut), jrec.virtual_time_ms, jrec.configuration_id] == [
        len(rec.cut), rec.virtual_time_ms, rec.configuration_id]
    for pid in range(2):
        got = _worker_state(tmp_path / f"state-{pid}.npz")
        assert sorted(got) == sorted(["record", *want])
        for name, value in want.items():
            np.testing.assert_array_equal(got[name], value, err_msg=name)
        assert got["record"].tolist() == [len(rec.cut), rec.virtual_time_ms,
                                          rec.configuration_id]


def _worker_steps(sim, victims):
    sim.ingress_loss(victims, 0.5)
    assert sim.run_until_decision(max_rounds=5, batch=5) is None


def _worker(coordinator, pid, out):
    """One process of the state test: the (2, 2) mesh over 2 processes."""
    from rapid_tpu_torch.shard.engine import gather_state, make_multihost_mesh
    from rapid_tpu_torch.sim import engine
    from rapid_tpu_torch.sim.driver import Simulator

    mesh = make_multihost_mesh(coordinator_address=coordinator, num_processes=2,
                               process_id=pid, devices=["cpu", "cpu"])
    sim = Simulator(N, seed=SEED, mesh=mesh)
    assert len(sim.state.rows) == 2 and sim.state.rows[0]["subjects"].shape == (N // 4, 10)
    _worker_steps(sim, _victims())
    state = engine.state_to_numpy(gather_state(sim.state))
    rec = sim.run_until_decision(max_rounds=64, batch=16)
    np.savez(out, record=np.array([len(rec.cut), rec.virtual_time_ms, rec.configuration_id]),
             **state)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    sys.path.insert(0, str(REPO))
    try:
        _worker(sys.argv[2], int(sys.argv[3]), sys.argv[4])
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
