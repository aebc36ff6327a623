"""``tests/golden/torch_planes.json`` on the CPU, both ways: the port's runs
of the driver's host planes at the bench's sizes (``chip_smoke.py``'s
``planes_golden_runs``, which the card reruns) equal the file exactly, and
so do the JAX package's runs today (``generate_torch_planes.py``'s
``jax_runs``), so the file cannot go stale unseen."""

import json
import os
import sys

import pytest

import chip_smoke

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden"))

import generate_torch_planes  # noqa: E402

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py

with open(chip_smoke.PLANES_GOLDEN) as _f:
    GOLDEN = json.load(_f)["runs"]
RUNS = ("serving_dimension", "sweep_point", "zone_churn")


@pytest.fixture(scope="module")
def port_runs():
    return json.loads(json.dumps(chip_smoke.planes_golden_runs("cpu")))


@pytest.fixture(scope="module")
def jax_runs():
    return json.loads(json.dumps(generate_torch_planes.jax_runs()))


@pytest.mark.parametrize("run", RUNS)
def test_port_run_equals_the_golden_file(port_runs, run):
    assert chip_smoke._golden_misses(port_runs[run], GOLDEN[run]) == []


@pytest.mark.parametrize("run", RUNS)
def test_jax_run_still_equals_the_golden_file(jax_runs, run):
    assert chip_smoke._golden_misses(jax_runs[run], GOLDEN[run]) == []


def test_golden_runs_exercise_every_plane():
    serving, sweep, churn = (GOLDEN[r] for r in RUNS)
    assert serving["lost_acked_writes"] == 0 and serving["acked"]
    assert serving["slo"]["serving.latency"]["alerts"]["fast"]["fired_count"] >= 0
    assert sweep["handoff"]["handoff.sessions_completed"] == sweep["handoff"][
        "handoff.sessions_started"] > 0
    assert sweep["moved"] == [len(sweep["moved_partitions"])]
    assert churn["fingerprint_ok"] and churn["parent_rounds"] > 0


def test_golden_misses_names_each_difference():
    want = {"a": [1, 2], "b": {"c": 3}}
    assert chip_smoke._golden_misses(want, want) == []
    assert chip_smoke._golden_misses({"a": [1, 5], "b": {}}, want) == [
        "/a[1]: 5, want 2", "/b/c: missing"]
