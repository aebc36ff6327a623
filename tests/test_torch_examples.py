"""The port's examples (``rapid_tpu_torch/examples/``) on the CPU, held to
the JAX examples' properties and to the JAX package's own functions:

- ``load_balancer``: Fig. 13 at 20 backends with 4 failing, through a real
  socket gateway: one view change, the exact cut, no route to a dead
  backend, the router's and the swarm's ids equal. Its routes equal
  ``rapid_tpu.placement.rendezvous_route`` over the same pool, and the final
  configuration id equals the fold of ``rapid_tpu.hashing`` over the same
  members;
- ``swarm_agent`` at a few dozen virtual nodes: exit 0, the ids equal after
  the join and the crash, the swarm back to N - crashed after the leave;
- ``agent_with_custom_messaging``: two agents on localhost join over TCP and
  stop.
Each refuses to run without a card unless ``--device cpu``.
"""

import signal
import subprocess
import sys
import time

import pytest
import torch

import rapid_tpu.hashing as jax_hashing
import rapid_tpu.placement as jax_placement
from rapid_tpu.types import Endpoint as JaxEndpoint
from rapid_tpu_torch.examples import load_balancer, swarm_agent
from rapid_tpu_torch.messaging.ports import free_port_base

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py

NO_CARD = not torch.cuda.is_available()


@pytest.fixture(scope="module")
def fig13():
    """One run at 20 backends, 4 failing, seed 23, with the router kept."""
    made = []

    class Recording(load_balancer.RendezvousRouter):
        def __init__(self, cluster, address):
            super().__init__(cluster, address)
            made.append((self, cluster))

    mp = pytest.MonkeyPatch()
    mp.setattr(load_balancer, "RendezvousRouter", Recording)
    try:
        out = load_balancer.run_scenario(backends=20, fail=4, seed=23, quiet=True, device="cpu")
    finally:
        mp.undo()
    assert len(made) == 1
    return out, made[0]


def test_load_balancer_holds_fig13(fig13):
    out, _ = fig13
    assert load_balancer.holds(out) == {"single view change": True, "exact cut": True,
                                        "clean routes": True, "config ids match": True}
    assert len(out["cut"]) == 4 and out["keys"] == 200
    # only the failed backends' keys move: about 4/20 of them, never more
    # than the dead share allows
    assert 0 < out["moved"] < out["keys"]
    assert set(out) == {"view_changes", "cut", "victims", "dead_routes", "moved", "keys",
                        "config_id_router", "config_id_swarm"}


def _jax(ep):
    return JaxEndpoint.from_parts(ep.hostname.decode(), ep.port)


def test_load_balancer_routes_equal_the_jax_rendezvous(fig13):
    out, (router, _) = fig13
    pool = router.backends()
    assert len(pool) == 20 - 4 and not set(pool) & out["victims"]
    jax_pool = [_jax(b) for b in pool]
    seeds = {b: jax_placement.weight_seed(b) for b in jax_pool}
    for i in range(200):
        key = b"req-%d" % i
        assert _jax(router.route(key)) == jax_placement.rendezvous_route(key, jax_pool, seeds)


def test_load_balancer_id_equals_the_jax_fold(fig13):
    out, (_, cluster) = fig13
    config = cluster._membership_service._view.get_configuration()
    assert len(config.endpoints) == 20 + 1 - 4
    folded = jax_hashing.configuration_id(
        ((n.high, n.low) for n in config.node_ids),
        ((e.hostname, e.port) for e in config.endpoints))
    assert folded == out["config_id_router"] == out["config_id_swarm"]


def test_swarm_agent_keeps_the_ids_equal():
    out = swarm_agent.run(virtual_nodes=40, crash_percent=5.0, seed=42, device="cpu", quiet=True)
    assert out["ok"] and out["crashed"] == 2
    join, crash, leave = out["steps"]
    assert (join["member_id"], join["member_size"]) == (join["swarm_id"], 41)
    assert (crash["member_id"], crash["member_size"]) == (crash["swarm_id"], 39)
    assert crash["cut"] == 2
    assert leave["swarm_size"] == 38 and not leave["seated"]
    assert leave["swarm_id"] != crash["swarm_id"]


def test_swarm_agent_main_exits_0_on_the_cpu(capsys):
    assert swarm_agent.main(["--virtual-nodes", "24", "--crash-percent", "10",
                             "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "parity: True" in out and "left gracefully" in out


@pytest.mark.skipif(not NO_CARD, reason="holds the refusal on a machine without a card")
@pytest.mark.parametrize("module", ["load_balancer", "swarm_agent"])
def test_examples_refuse_to_run_without_a_card(module):
    out = subprocess.run([sys.executable, "-m", f"rapid_tpu_torch.examples.{module}",
                          "--backends" if module == "load_balancer" else "--virtual-nodes", "8"],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 2
    assert "no CUDA device" in out.stderr and "--device" not in out.stdout
    assert "cpu" in out.stderr


def test_agents_on_custom_messaging_join_over_tcp_and_stop():
    """A seed, then a joiner that exits 0 once it sees both members; the
    seed then logs a membership of 2 and exits 0 on SIGINT."""
    base = free_port_base(2)
    module = [sys.executable, "-m", "rapid_tpu_torch.examples.agent_with_custom_messaging"]
    seed = subprocess.Popen([*module, "--listen-address", f"127.0.0.1:{base}"],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    seed_lines = []

    def seed_says(text, timeout=60):
        deadline = time.time() + timeout
        while time.time() < deadline:
            line = seed.stdout.readline()
            if not line:
                break
            seed_lines.append(line)
            if text in line:
                return
        raise AssertionError(f"the seed never said {text!r}: {''.join(seed_lines)}")

    try:
        seed_says("over custom TCP messaging")  # it listens once it says so
        joiner = subprocess.run([*module, "--listen-address", f"127.0.0.1:{base + 1}",
                                 "--seed-address", f"127.0.0.1:{base}", "--until-size", "2"],
                                capture_output=True, text=True, timeout=120)
        assert joiner.returncode == 0, joiner.stderr
        assert "membership size=2 reached" in joiner.stderr
        seed_says("membership size=2")
        seed.send_signal(signal.SIGINT)
        assert seed.wait(timeout=60) == 0, "".join(seed_lines)
    finally:
        if seed.poll() is None:
            seed.kill()
        seed.wait()
        seed.stdout.close()


def test_agent_with_custom_messaging_runs_for_a_set_time():
    base = free_port_base(1)
    out = subprocess.run([sys.executable, "-m",
                          "rapid_tpu_torch.examples.agent_with_custom_messaging",
                          "--listen-address", f"127.0.0.1:{base}", "--run-for-s", "0.5"],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "over custom TCP messaging" in out.stderr


def test_chip_smoke_tools_phase_on_the_cpu(monkeypatch, tmp_path, capsys):
    """``chip_smoke.py``'s tools-and-examples phase, (a)-(c), at small sizes
    on the CPU: the card's run differs in sizes and device only."""
    import chip_smoke
    from rapid_tpu_torch.sim import kernels

    monkeypatch.setattr(chip_smoke, "LB_BACKENDS", 20)
    monkeypatch.setattr(chip_smoke, "LB_FAIL", 4)
    monkeypatch.setattr(chip_smoke, "SWARM_AGENT_N", 60)
    monkeypatch.setattr(chip_smoke, "PERFSCOPE_N", 512)
    lb = chip_smoke.load_balancer_run("cpu", kernels, device="cpu")
    assert lb["checks"] == {"single view change": True, "exact cut": True,
                            "clean routes": True, "config ids match": True}
    assert lb["launches"] == {"fd_phase_fused": 0, "placement_topr": 0}
    agent = chip_smoke.swarm_agent_run("cpu", kernels, device="cpu")
    assert [s["ok"] for s in agent["steps"]] == [True, True, True]
    tools = chip_smoke.operator_tools_run("cpu", str(tmp_path), device="cpu")
    assert (tools["perfscope_rc"], tools["phase_bars"], tools["tracecat_rc"]) == (0, 4, 0)
    assert tools["processes"].count("virtual-time (ms)") == 1
    out = capsys.readouterr().out
    assert out.count("tools and examples (") == 7
