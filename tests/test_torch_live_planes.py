"""``tests/golden/torch_live_planes.json`` on the CPU: ``chip_smoke.py``'s
live-planes phase (real members' durable stores, handoff, serving and
hierarchy planes, then the recovery points) run on the port at the file's
reduced size equals its ``reduced`` section exactly, and so does the JAX
package's run today, so the file cannot go stale unseen. The card runs the
``full`` section (the bench's serving size); its shape is checked here."""

import json
import os
import sys

import pytest

import chip_smoke

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden"))

import generate_torch_live_planes  # noqa: E402

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py

with open(chip_smoke.LIVE_GOLDEN) as _f:
    GOLDEN = json.load(_f)


@pytest.fixture(scope="module")
def port_reduced(tmp_path_factory):
    P = chip_smoke.live_modules("rapid_tpu_torch")
    outcome, walls = chip_smoke.live_planes_sequence(
        P, str(tmp_path_factory.mktemp("live")), **chip_smoke.LIVE_REDUCED)
    return json.loads(json.dumps(outcome)), walls


@pytest.mark.parametrize("run", ["serving", "hierarchy", "recovery"])
def test_port_reduced_run_equals_the_golden_file(port_reduced, run):
    outcome, _walls = port_reduced
    assert chip_smoke._golden_misses(outcome[run], GOLDEN["reduced"][run]) == []


def test_jax_reduced_run_still_equals_the_golden_file():
    assert chip_smoke._golden_misses(generate_torch_live_planes.jax_run("reduced"),
                                     GOLDEN["reduced"]) == []


def test_phase_constants_are_the_bench_s():
    generate_torch_live_planes.check_against_bench()


@pytest.mark.parametrize("section", ["full", "reduced"])
def test_golden_runs_hold_every_plane_s_invariant(section):
    run = GOLDEN[section]
    serving, hier = run["serving"], run["hierarchy"]
    n = chip_smoke.SERVING_N_NODES if section == "full" else chip_smoke.LIVE_REDUCED["n_nodes"]
    assert serving["n_nodes"] == hier["n_nodes"] == n
    assert len(serving["fingerprints"]) == chip_smoke.LIVE_PLACEMENT["partitions"]
    assert len(serving["acked"]) == chip_smoke.SERVING_KEYS
    sessions = serving["sessions"]
    assert sessions["handoff.sessions_started"] == sessions["handoff.sessions_completed"] > 0
    assert sessions["handoff.sessions_failed"] == 0
    assert serving["replayed_records"] > 0 and len(serving["serving"]) == n
    assert serving["final_config"] == serving["config_ids"][-1]
    ops = dict(chip_smoke.SERVING_OPS if section == "full" else chip_smoke.LIVE_REDUCED["ops"])
    assert {k: w["ops"] for k, w in serving["windows"].items()} == ops
    assert hier["member_count"] == n - len(hier["crashed"])
    assert sum(hier["cells"].values()) == n
    assert [(p["log_records"], p["snapshot_every"], p["replayed_records"])
            for p in run["recovery"]] == [
        (r, e, r % e if e else r) for e in chip_smoke.RECOVERY_SNAPSHOT_EVERY
        for r in chip_smoke.RECOVERY_LOG_RECORDS]


def test_live_golden_check_names_each_difference(port_reduced):
    outcome, _walls = port_reduced
    assert chip_smoke.live_golden_check(outcome, "reduced") == []
    bent = json.loads(json.dumps(outcome))
    bent["hierarchy"]["global_fingerprint"] += 1
    bent["serving"]["acked"]["bench-key-0000"] -= 1
    assert chip_smoke.live_golden_check(bent, "reduced") == [
        f"/hierarchy/global_fingerprint: {outcome['hierarchy']['global_fingerprint'] + 1}, "
        f"want {outcome['hierarchy']['global_fingerprint']}",
        f"/serving/acked/bench-key-0000: {outcome['serving']['acked']['bench-key-0000'] - 1}, "
        f"want {outcome['serving']['acked']['bench-key-0000']}"]
