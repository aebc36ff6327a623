"""The port's scenario battery against ``scenarios.py``'s: the
protocol-plane scenarios and the pinned corpus plans.

Each scenario builds in-process clusters on virtual time over the port's own
``rapid_tpu_torch.harness.ClusterHarness`` (the JAX package's over
``tests/harness.py``'s), with the same seeds. Each record, as the CLI
prints it, equals the JAX package's in every field but ``wall_s``, exactly.
Their losses are the nemesis's seeded Python draws, not the simulator's:
``rolling-upgrade``'s 5% probe loss stays exact, as in
``tests/test_torch_cluster.py``'s nemesis twins. ``gray-slow-node``'s
device leg runs its simulator on ``device="cpu"``.

``nemesis-protocol`` reports the process-global ``time_to_stable_view_ms``
histogram's count, which sums every protocol-plane cluster the process has
built; each package's global registry is emptied before its run, so both
count the scenario's own clusters.
"""

import gc
import json
import pathlib

import pytest
import torch

import scenarios as jax_scenarios
from rapid_tpu import observability as jax_observability
from rapid_tpu_torch import observability as port_observability
from rapid_tpu_torch.cli import scenarios as port_scenarios

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU path runs these scenarios as thousands of small ops;
    beside other test workers, intra-op threads wait on each other (the WAN
    replay took 58 s against 2.4 s on one thread on a loaded 8-core host),
    so the module runs torch on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


REPO = pathlib.Path(__file__).resolve().parents[1]
CORPUS = sorted((REPO / "scenarios" / "corpus").glob("*.json"))

# the registry's protocol-plane scenarios, at the registry's sizes and seeds
PROTOCOL_SCENARIOS = ("nemesis-protocol", "gray-slow-node", "gray-flapping",
                      "clock-skew", "rolling-upgrade", "rolling-restart")


def record(result):
    """A scenario's record as the CLI prints it, without ``wall_s``."""
    doc = json.loads(json.dumps(result))
    doc.pop("wall_s")
    return doc


def fresh_global_metrics(observability):
    gc.collect()  # dead clusters' samples are queued now, and reset drops them
    observability.global_metrics().reset()


def twins(name, **kw):
    fresh_global_metrics(jax_observability)
    want = record(jax_scenarios.run_scenario(name, **kw))
    fresh_global_metrics(port_observability)
    got = record(port_scenarios.run_scenario(name, device="cpu", **kw))
    return want, got


@pytest.mark.parametrize("name", PROTOCOL_SCENARIOS)
def test_protocol_scenario_record_equals_jax(name):
    want, got = twins(name)
    assert got == want
    assert got["cut_ok"] is True
    assert got.get("config_id_parity", True) is True
    assert got.get("lost_acked_writes", 0) == 0


def test_nemesis_protocol_with_another_plan_seed():
    want, got = twins("nemesis-protocol", seed=9)
    assert got == want and got["cut_ok"]
    assert got["stable_view_decisions"] > 0


@pytest.mark.parametrize("pin", CORPUS, ids=lambda p: p.stem)
def test_corpus_plan_record_equals_jax(pin):
    name = f"corpus-{pin.stem}"
    want, got = twins(name)
    assert got == want
    assert got["cut_ok"] is True and got["violations"] == []


@pytest.mark.parametrize("pin", CORPUS, ids=lambda p: p.stem)
def test_plan_flag_with_a_seed_equals_jax(pin, capsys):
    want = record(jax_scenarios.scenario_pinned_plan(str(pin), seed=5))
    assert port_scenarios.main(["--plan", str(pin), "--seed", "5", "--device", "cpu"]) == 0
    got = record(json.loads(capsys.readouterr().out.splitlines()[0]))
    assert got == want


def test_fault_plan_flag_prints_the_nemesis_pair(capsys):
    fresh_global_metrics(jax_observability)
    want = [record(jax_scenarios.run_scenario("nemesis-protocol", seed=3)),
            record(jax_scenarios.run_scenario("nemesis-smoke", seed=3))]
    fresh_global_metrics(port_observability)
    assert port_scenarios.main(["--fault-plan", "3", "--device", "cpu"]) == 0
    got = [record(json.loads(line)) for line in capsys.readouterr().out.splitlines()]
    assert got == want
    assert all(rec["cut_ok"] for rec in got)


def test_harness_keeps_the_jax_harness_surface():
    """``rapid_tpu_torch.harness`` under ``tests/harness.py``'s names."""
    import inspect

    import harness as jax_harness
    from rapid_tpu_torch import harness as port_harness

    assert port_harness.BASE_PORT == jax_harness.BASE_PORT
    assert port_harness.free_port.__module__ == "rapid_tpu_torch.messaging.ports"
    assert port_harness.free_port_base.__module__ == "rapid_tpu_torch.messaging.ports"
    for name, member in inspect.getmembers(jax_harness.ClusterHarness, inspect.isfunction):
        port_member = getattr(port_harness.ClusterHarness, name)
        assert list(inspect.signature(port_member).parameters) == \
            list(inspect.signature(member).parameters), name
    h = port_harness.ClusterHarness(seed=3)
    assert {"scheduler", "network", "instances", "blacklist", "broadcaster_factory",
            "nemesis", "use_static_fd"} <= set(vars(h))
    assert str(h.addr(2)) == str(jax_harness.ClusterHarness(seed=3).addr(2))
