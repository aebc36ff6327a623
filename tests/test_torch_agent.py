"""The port's standalone agent (``python -m rapid_tpu_torch.cli.agent``) in
its own OS process, on the CPU.

``chip_smoke.agent_sequence`` starts the port's ``SwarmGateway`` at 1000
virtual members and the agent in a child process, routed through the gateway
over the port's TCP transport: it joins, goes through a closed-form crash and
a crash under ingress loss 1.0 (both run on the gateway's protocol thread)
and leaves on SIGINT. After each step but the leave its configuration id,
read through its status RPC, equals the gateway's; every decision's id
equals a plain simulator's driven alike. Then the agent alone: a seed and a
joiner over loopback, ``--status`` against them, the same two on the native
transport (``--transport native-tcp``), the serving demo (``--serving``) on
two agents, and the transport the port refuses."""

import os
import re
import signal
import subprocess
import sys
import time

import pytest

import chip_smoke
from rapid_tpu_torch.messaging.ports import free_port_base

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_agent_sequence_against_the_port_gateway():
    out = chip_smoke.agent_sequence(1000, "cpu")
    steps = {row["name"]: row for row in out["steps"]}
    assert list(steps) == ["join", "crash, closed form", "crash, scan", "leave"]
    for name in ("join", "crash, closed form", "crash, scan"):
        row = steps[name]
        assert row["agent_configuration_id"] == row["configuration_id"] \
            == row["plain_configuration_id"], name
    assert steps["join"]["members_before"] == 1000 and steps["join"]["cut"] == 1
    for name in ("crash, closed form", "crash, scan"):
        assert steps[name]["cut"] == 10 and steps[name]["dispatch_ms"] > 0
    assert steps["leave"]["configuration_id"] == steps["leave"]["plain_configuration_id"]
    assert all(0 < row["agent_wall_ms"] < chip_smoke.GATEWAY_WAIT_S * 1e3 for row in steps.values())


def _agent(*args):
    return subprocess.Popen([sys.executable, "-m", "rapid_tpu_torch.cli.agent", *args],
                            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env=dict(os.environ, PYTHONUNBUFFERED="1"))


def _wait_for(proc, pattern, lines, timeout=60):
    deadline = time.time() + timeout
    while time.time() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        lines.append(line)
        if re.search(pattern, line):
            return line
    raise AssertionError(f"no {pattern!r} in {''.join(lines[-20:])}")


def test_two_agents_converge_and_answer_status():
    """A seed and a joiner, each its own process over the port's TCP
    transport: both log a membership of 2 with one configuration id, and
    ``--status`` prints it; SIGINT makes the joiner leave and exit 0 (two
    members cannot decide a removal: the fast quorum is both, so the seed
    keeps its view; ``agent_sequence`` holds a leave at scale)."""
    base = free_port_base(2)
    seed, joiner = f"127.0.0.1:{base}", f"127.0.0.1:{base + 1}"
    procs = [_agent("--listen-address", seed, "--fd-interval-ms", "100")]
    try:
        seed_lines = []
        _wait_for(procs[0], r"agent started at", seed_lines)
        procs.append(_agent("--listen-address", joiner, "--seed-address", seed,
                            "--fd-interval-ms", "100"))
        joiner_lines = []
        configs = set()
        for proc, lines in ((procs[1], joiner_lines), (procs[0], seed_lines)):
            line = _wait_for(proc, r"membership size=2 ", lines)
            configs.add(re.search(r"config=(-?\d+)", line).group(1))
        assert len(configs) == 1
        status = subprocess.run([sys.executable, "-m", "rapid_tpu_torch.cli.agent", "--status",
                                 joiner], cwd=REPO, capture_output=True, text=True, timeout=60)
        assert status.returncode == 0, status.stdout + status.stderr
        assert f"config={configs.pop()}  members=2" in status.stdout
        procs[1].send_signal(signal.SIGINT)
        assert procs[1].wait(timeout=60) == 0
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            proc.stdout.close()


def test_two_agents_converge_over_native_tcp():
    """``--transport native-tcp``: a seed and a joiner, each its own process
    with its server half on the port's C++ epoll reactor, converge on one
    configuration id, and ``--status`` reads it through the joiner's native
    server; SIGINT makes the joiner leave and exit 0."""
    base = free_port_base(2)
    seed, joiner = f"127.0.0.1:{base}", f"127.0.0.1:{base + 1}"
    common = ("--transport", "native-tcp", "--fd-interval-ms", "100")
    procs = [_agent("--listen-address", seed, *common)]
    try:
        seed_lines = []
        _wait_for(procs[0], r"agent started at", seed_lines)
        procs.append(_agent("--listen-address", joiner, "--seed-address", seed, *common))
        configs = set()
        for proc, lines in ((procs[1], []), (procs[0], seed_lines)):
            line = _wait_for(proc, r"membership size=2 ", lines)
            configs.add(re.search(r"config=(-?\d+)", line).group(1))
        assert len(configs) == 1
        status = subprocess.run([sys.executable, "-m", "rapid_tpu_torch.cli.agent", "--status",
                                 joiner], cwd=REPO, capture_output=True, text=True, timeout=60)
        assert status.returncode == 0, status.stdout + status.stderr
        assert f"config={configs.pop()}  members=2" in status.stdout
        procs[1].send_signal(signal.SIGINT)
        assert procs[1].wait(timeout=60) == 0
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            proc.stdout.close()


@pytest.mark.parametrize("args,refusal", [
    (["--transport", "grpc"], "--transport grpc is not ported"),
])
def test_agent_refuses_what_is_not_ported(args, refusal):
    out = subprocess.run([sys.executable, "-m", "rapid_tpu_torch.cli.agent", "--listen-address",
                          "127.0.0.1:1", *args], cwd=REPO, capture_output=True, text=True,
                         timeout=60)
    assert out.returncode == 2 and refusal in out.stderr, out.stderr
    assert "Queue 1 item 8d" in out.stderr and "8c" not in out.stderr, out.stderr


def test_serving_demo_agents_write_and_read_back():
    """``--serving`` on a seed and a joiner (placement, handoff and serving on
    an in-memory store): each agent's tick writes its demo key through the
    quorum path, reads it back and logs the put/get line with the serving
    counters, as the JAX agent's demo does."""
    base = free_port_base(2)
    seed, joiner = f"127.0.0.1:{base}", f"127.0.0.1:{base + 1}"
    common = ("--fd-interval-ms", "100", "--serving", "--serving-partitions", "8")
    procs = [_agent("--listen-address", seed, *common)]
    try:
        seed_lines = []
        _wait_for(procs[0], r"agent started at", seed_lines)
        procs.append(_agent("--listen-address", joiner, "--seed-address", seed, *common))
        for proc, addr, lines in ((procs[1], joiner, []), (procs[0], seed, seed_lines)):
            line = _wait_for(proc, rf"serving key=agent-demo:{addr} value=tick-\d+ ", lines,
                             timeout=90)
            # every put is applied by both members (one row of two replicas)
            puts = int(re.search(r"gets=\d+ puts=(\d+) acks=\d+", line).group(1))
            assert puts >= 1, line
        procs[1].send_signal(signal.SIGINT)
        assert procs[1].wait(timeout=60) == 0
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            proc.stdout.close()
