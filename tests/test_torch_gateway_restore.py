"""The port's swarm gateway across a checkpoint and a restart, and its CLI.

Twins of ``tests/test_gateway.py``'s checkpoint/restore cases, with
``rapid_tpu`` agents against ``rapid_tpu_torch``'s ``SwarmGateway(device=
"cpu")`` (harness in ``test_torch_gateway.py``), and the gateway CLI
(``python -m rapid_tpu_torch.cli.gateway``) run as a process: its ``SEED``
line, a ``rapid_tpu`` agent joining through it, and a SIGINT with
``--snapshot`` whose snapshot a new ``SwarmGateway`` resumes with the same
configuration id."""

import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
from harness import free_port_base
from test_torch_gateway import GatewayHarness, crash, port_ep

import rapid_tpu.types as rtypes
from rapid_tpu import ClusterBuilder, Settings
from rapid_tpu.messaging.gateway import GatewayRoutedClient, GatewaySwarmBroadcaster
from rapid_tpu.messaging.tcp import TcpClientServer
from rapid_tpu_torch import types as ptypes
from rapid_tpu_torch.messaging.gateway import SwarmGateway

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py

ROOT = Path(__file__).resolve().parents[1]


def test_gateway_checkpoint_restart_resume(tmp_path):
    """The restored swarm keeps the configuration id and the real members'
    seats; live agents reconnect transparently, observe a new cut decided
    by the restored swarm, and a fresh agent can still join."""
    h = GatewayHarness(n_virtual=24, seed=14)
    try:
        a1 = h.join_agent(1)
        a2 = h.join_agent(2)
        assert h.wait_converged(26)
        config_before = h.gateway.configuration_id()

        h.restart(str(tmp_path / "swarm.npz"))
        assert h.gateway.configuration_id() == config_before
        assert h.gateway.membership_size() == 26
        assert set(h.gateway.bridge._real) == {  # noqa: SLF001
            port_ep(a1.listen_address), port_ep(a2.listen_address)}

        crash(h.gateway, [5, 17])
        assert h.wait_converged(24, timeout=90)
        h.assert_agreement()

        a3 = h.join_agent(3)
        assert h.wait_converged(25)
        h.assert_agreement()
        assert a3.get_current_configuration_id() == h.gateway.configuration_id()
    finally:
        h.shutdown()


def test_rejoin_same_address_after_gateway_restore(tmp_path):
    """A member cut BEFORE the snapshot rejoins on the same address AFTER
    the restore: stale endpoint->slot mappings do not resurrect."""
    h = GatewayHarness(n_virtual=24, seed=15)
    try:
        h.join_agent(1)
        a2 = h.join_agent(2)
        assert h.wait_converged(26)
        dead_addr = a2.listen_address
        a2.shutdown()  # abrupt death; the swarm cuts it
        h.agents.remove(a2)
        assert h.wait_converged(25, timeout=90)

        h.restart(str(tmp_path / "swarm.npz"))
        assert port_ep(dead_addr) not in h.gateway.bridge._slot_of  # noqa: SLF001

        back = h.join_agent(dead_addr.port - h.base)  # same host:port
        assert h.wait_converged(26, timeout=90)
        assert back.listen_address == dead_addr
        assert port_ep(dead_addr) in h.gateway.bridge._real  # noqa: SLF001
        h.assert_agreement()
    finally:
        h.shutdown()


def _read_seed(proc: subprocess.Popen, timeout: float = 60.0) -> str:
    deadline = time.time() + timeout
    lines = []
    while time.time() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        lines.append(line)
        if line.startswith("SEED "):
            return line.split()[1]
    raise AssertionError(f"no SEED line from the gateway CLI: {lines}")


def test_gateway_cli_seed_join_sigint_snapshot_and_resume(tmp_path):
    base = free_port_base(4)
    snapshot = tmp_path / "cli.npz"
    proc = subprocess.Popen(
        [sys.executable, "-m", "rapid_tpu_torch.cli.gateway", "--listen-address",
         f"127.0.0.1:{base}", "--n-virtual", "24", "--seed", "3", "--device", "cpu",
         "--pump-interval-ms", "50", "--snapshot", str(snapshot)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    agent = None
    try:
        seed = rtypes.Endpoint.from_string(_read_seed(proc))
        settings = Settings(failure_detector_interval_ms=100, batching_window_ms=50)
        addr = rtypes.Endpoint.from_parts("127.0.0.1", base + 1)
        transport = TcpClientServer(addr, settings)
        client = GatewayRoutedClient(addr, rtypes.Endpoint.from_parts("127.0.0.1", base),
                                     transport, settings)
        agent = (ClusterBuilder(addr).use_settings(settings)
                 .set_messaging_client_and_server(client, transport)
                 .set_broadcaster_factory(lambda c, rng: GatewaySwarmBroadcaster(client))
                 .join(seed, timeout=60))
        assert agent.get_membership_size() == 25
        config = agent.get_current_configuration_id()
        proc.send_signal(signal.SIGINT)
        proc.wait(timeout=60)
        assert snapshot.exists(), proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        if agent is not None:
            agent.shutdown()
    stderr = proc.stderr.read()
    assert "snapshot written" in stderr, stderr
    restored = SwarmGateway(ptypes.Endpoint.from_parts("127.0.0.1", free_port_base(2)),
                            restore_from=str(snapshot), device="cpu")
    try:
        assert restored.configuration_id() == config
        assert restored.membership_size() == 25
        assert port_ep(addr) in restored.bridge._real  # noqa: SLF001
    finally:
        restored.shutdown()


def test_gateway_cli_without_a_card_and_without_device_cpu_fails():
    import torch

    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    base = free_port_base(2)
    proc = subprocess.run(
        [sys.executable, "-m", "rapid_tpu_torch.cli.gateway", "--listen-address",
         f"127.0.0.1:{base}", "--n-virtual", "8"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "SEED" not in proc.stdout
