"""``tests/golden/torch_search.json`` on the CPU: ``chip_smoke.py``'s search
phase (the engine hunt, the flagged bug found, shrunk, pinned and replayed,
the simulator hunt, a simulator probe at full shape, the forensics
timeline) run on the port at the file's reduced size, with the simulator
on ``device="cpu"``, equals its ``reduced`` section exactly, and so does the
JAX package's run today, so the file cannot go stale unseen. The simulator
hunt also runs at the ``full`` section's budget, whose probes draw loss
below 1.0, and equals it exactly. The card runs the ``full`` section; its
shape and the facts the card is held to are checked here."""

import json
import os
import sys

import pytest

import chip_smoke

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden"))

import generate_torch_search  # noqa: E402

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py

with open(chip_smoke.SEARCH_GOLDEN) as _f:
    GOLDEN = json.load(_f)
RUNS = ("engine_hunt", "bug_hunt", "sim_hunt", "wide_probe", "timeline")


@pytest.fixture(scope="module")
def port_reduced(tmp_path_factory):
    P = chip_smoke.search_modules()
    return chip_smoke.search_sequence(P, str(tmp_path_factory.mktemp("search")), device="cpu",
                                      **chip_smoke.SEARCH_REDUCED)


@pytest.mark.parametrize("run", RUNS)
def test_port_reduced_run_equals_the_golden_file(port_reduced, run):
    outcome, _walls = port_reduced
    assert chip_smoke._golden_misses(outcome[run], GOLDEN["reduced"][run]) == []


def test_port_reduced_run_passes_the_card_s_comparison(port_reduced):
    outcome, walls = port_reduced
    assert chip_smoke.search_golden_misses(outcome, GOLDEN["reduced"]) == []
    assert set(walls) == set(RUNS) and all(w["launches"] == {} for w in walls.values())


def test_port_full_sim_hunt_equals_the_golden_file_lossy_probes_included():
    """(c) at the card's full budget, on the CPU: every probe equals the JAX
    package's exactly, those whose plans draw loss below 1.0 included (the
    port draws threefry's bits from the same key), and so do the report and
    the coverage."""
    got = json.loads(json.dumps(chip_smoke.sim_hunt(chip_smoke.search_modules(), "cpu")))
    want = GOLDEN["full"]["sim_hunt"]
    assert any(p["draws_loss"] for p in want["probes"]), "the hunt should draw loss"
    assert chip_smoke._golden_misses(got, want) == []


def test_jax_reduced_run_still_equals_the_golden_file():
    assert chip_smoke._golden_misses(generate_torch_search.jax_run("reduced"),
                                     GOLDEN["reduced"]) == []


@pytest.mark.parametrize("section", ["full", "reduced"])
def test_golden_runs_hold_what_the_card_is_held_to(section):
    run = GOLDEN[section]
    budgets = {"full": (chip_smoke.SEARCH_ENGINE_HUNT["budget"],
                        chip_smoke.SEARCH_SIM_HUNT["budget"], chip_smoke.SEARCH_WIDE_N),
               "reduced": (chip_smoke.SEARCH_REDUCED["engine_budget"],
                           chip_smoke.SEARCH_REDUCED["sim_budget"],
                           chip_smoke.SEARCH_REDUCED["wide_n"])}[section]
    # (a) and (c) clean, at their budgets
    assert run["engine_hunt"]["report"]["probes"] == budgets[0]
    assert run["engine_hunt"]["report"]["violations"] == []
    assert len(run["sim_hunt"]["probes"]) == budgets[1]
    assert run["sim_hunt"]["report"]["violations"] == []
    assert all(p["spec"]["capacity"] == 5 for p in run["sim_hunt"]["probes"])
    # (b) found, shrunk to 3 rules or fewer, pinned; the corpus pin green
    # without the flag and violating with it
    bug = run["bug_hunt"]
    assert bug["pin"]["kinds"] == ["linearizability"]
    assert len(bug["pin"]["spec"]["plan"]["rules"]) <= 3
    assert json.loads(bug["pin_bytes"])["expect"] == {"invariants": ["linearizability"]}
    assert bug["corpus_replay"]["flag_off"]["kinds"] == []
    assert bug["corpus_replay"]["flag_on"]["kinds"] == ["linearizability"]
    # (d) at its size, clean, through both view changes
    wide = run["wide_probe"]
    assert wide["spec"]["n"] == wide["spec"]["capacity"] == budgets[2]
    assert wide["kinds"] == [] and wide["info"]["view_changes"] == 2
    assert not chip_smoke.draws_loss(wide["spec"])
    # (e) the stuck handoff found, everything else clean, the tampering caught
    tl = run["timeline"]
    assert [f["signature"] for f in tl["stuck_handoff"]["findings"]] == ["stuck_handoff"]
    assert {k: t["report_rc"] for k, t in tl.items() if isinstance(t, dict)} == {
        "witness": 0, "skewed_churn": 0, "stuck_handoff": 3, "clean": 0}
    assert all(t["stamped"] and t["verify_rc"] == [0] for t in tl.values() if isinstance(t, dict))
    assert tl["tampered_verify_rc"] == 3


def test_full_wide_probe_is_the_bench_headline_s_size():
    info = GOLDEN["full"]["wide_probe"]["info"]
    assert GOLDEN["full"]["wide_probe"]["spec"]["n"] == chip_smoke.N_NODES == 100_000
    assert (info["acked_puts"], info["history"], info["virtual_ms"], info["replayed_records"]) == (
        18, 45, 68_245, 0)
    assert len(GOLDEN["full"]["wide_probe"]["coverage"]) == 12
