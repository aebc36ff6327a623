"""The port's forensics timeline (``rapid_tpu_torch.forensics.timeline`` and
``rapid_tpu_torch.cli.forensics``) against the JAX package's
(``rapid_tpu.forensics.timeline`` and ``tools/forensics.py``), exactly.

The same bundles go to both packages: ``tests/test_forensics.py``'s CLI
fixtures, the flagged bug's witness bundle, a hand-built fixture for each
signature, and journals drawn from a seeded ``random.Random`` (stamped and
unstamped, over three nodes and every kind a detector reads). The merged
events, the findings, the Chrome trace and the report text must be equal,
and both CLIs must print the same and exit alike. Then bundles captured
from each package's own members (the skewed churn of
``tests/test_forensics.py``) give equal timelines, the signature catalog
passes the port's counterpart of ``tools/check.py``'s lint, and every
public name of the JAX module exists in the port.
"""

import ast
import contextlib
import dataclasses
import importlib
import importlib.util
import inspect
import io
import json
import pathlib
import random
import subprocess
import sys

import pytest

import chip_smoke

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py

REPO = pathlib.Path(__file__).resolve().parents[1]
PACKAGES = ("rapid_tpu", "rapid_tpu_torch")
BUG_FLAG = "RAPID_BUG_NEWROW_SYNC"


def timeline(package):
    return importlib.import_module(f"{package}.forensics.timeline")


def bundle_mod(package):
    return importlib.import_module(f"{package}.forensics.bundle")


def cli_main(package):
    if package == "rapid_tpu_torch":
        return importlib.import_module("rapid_tpu_torch.cli.forensics").main
    spec = importlib.util.spec_from_file_location("_tools_forensics",
                                                  REPO / "tools" / "forensics.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.main


def run_timeline(package, bundles):
    """Every output of package's timeline over ``bundles``."""
    T = timeline(package)
    events = T.merge_timeline(bundles)
    findings = T.detect_signatures(events)
    return ([dataclasses.astuple(e) + (e.hlc_key, e.wall_key) for e in events],
            [e.to_journal_entry() for e in events], findings,
            T.timeline_chrome_trace(events), T.report_text(events, findings, bundles))


def assert_twin(bundles):
    jax, port = (run_timeline(p, bundles) for p in PACKAGES)
    assert jax == port
    return jax


def jax_search_modules():
    """``chip_smoke.search_modules`` for the JAX package: its live modules,
    the search's and the timeline's modules, and ``tools/forensics.py``'s
    ``main`` as the forensics CLI (loaded by path, as the golden generator
    runs it). ``chip_smoke.py`` builds the port's alone: it imports nothing
    of the JAX package."""
    ns = chip_smoke.live_modules("rapid_tpu")
    for module in chip_smoke.SEARCH_MODULES:
        setattr(ns, module.replace(".", "_"), importlib.import_module(f"rapid_tpu.{module}"))
    spec = importlib.util.spec_from_file_location("_forensics_cli", REPO / "tools" / "forensics.py")
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    ns.forensics_main = cli.main
    return ns


def search_modules(package):
    """The search namespace of ``package`` (either of PACKAGES)."""
    return jax_search_modules() if package == "rapid_tpu" else chip_smoke.search_modules()


def journal_bundle(events):
    """``tests/test_forensics.py``'s ``_bundle_with`` (built with the JAX
    package, so both packages read the same document)."""
    return chip_smoke._journal_bundle(jax_search_modules(), events)


FIXTURES = {
    "stuck_handoff": [("handoff_started", {"sessions": 2, "version": 4}),
                      ("handoff_complete", {"partition": 0})],
    "clean": [("handoff_started", {"sessions": 1, "version": 4}),
              ("handoff_complete", {"partition": 0})],
    "stuck_three": [("handoff_started", {"sessions": 3, "version": 9})],
    "probe": [("probe", {"peer": "x"})],
}


def entry(seq, kind, node, hlc, virtual_ms, wall_s=0.0, **detail):
    out = {"seq": seq, "kind": kind, "node": node, "wall_s": wall_s,
           "virtual_ms": virtual_ms, "detail": detail}
    if hlc is not None:
        out["hlc"] = list(hlc)
    return out


def member(node, journal, dropped=0):
    return {"node": node, "reachable": True, "journal": journal, "journal_dropped": dropped}


def bundle_of(*members, trigger="explicit"):
    records = list(members)
    return {"schema": 1, "trigger": trigger, "captured_by": records[0]["node"],
            "captured_wall_s": 0.0, "detail": {}, "members": records,
            "manifest": {"fingerprint": bundle_mod("rapid_tpu").bundle_fingerprint(records),
                         "members": len(records), "unreachable": [],
                         "events": sum(len(m["journal"]) for m in records)}}


# one fixture a signature, each built to fire it
SIGNATURE_FIXTURES = {
    "view_divergence": bundle_of(
        member("a", [entry(1, "view_install", "a", (1000, 0, 1), 1000, configuration_id=7),
                     entry(2, "probe", "a", (9000, 0, 1), 9000)]),
        member("b", [entry(1, "view_install", "b", (1100, 0, 1), 1100, configuration_id=8),
                     entry(2, "probe", "b", (9500, 0, 1), 9500)])),
    "deposed_leader_write": bundle_of(
        member("a", [entry(1, "serving_leader_change", "a", (100, 0, 1), 100, version=2),
                     entry(2, "serving_sync", "a", (900, 0, 1), 900, version=2)]),
        member("b", [entry(1, "serving_leader_change", "b", (500, 0, 1), 500, version=3)])),
    "alert_storm_burn": bundle_of(
        member("a", [entry(1, "fd_signal", "a", (100, 0, 1), 100, trace_id=5)]
               + [entry(2 + i, "alert_out", "a", (110 + i, 0, 1), 110 + i) for i in range(6)]
               + [entry(9, "view_install", "a", (400, 0, 1), 400, trace_id=5,
                        configuration_id=9, removed=1),
                  entry(10, "slo_alert_fired", "a", (300, 0, 1), 300, slo="get_p99",
                        window="fast")])),
    "unstamped": bundle_of(
        member("a", [entry(1, "view_install", "a", None, 10, wall_s=1.5, configuration_id=1),
                     entry(2, "handoff_started", "a", None, 12, wall_s=1.2, sessions=2)],
               dropped=4)),
}

KINDS = ("view_install", "handoff_started", "handoff_complete", "handoff_failed",
         "serving_leader_change", "serving_sync", "slo_alert_fired", "fd_signal",
         "alert_out", "alert_in", "alert_enqueued", "placement_rebalance", "probe")


def random_bundle(rnd):
    members = []
    for node in ("n0", "n1", "n2"):
        journal, ms = [], 0
        for seq in range(1, rnd.randint(2, 40)):
            ms += rnd.randint(0, 900)
            detail = {}
            for key, hi in (("configuration_id", 3), ("version", 4), ("sessions", 3),
                            ("trace_id", 3), ("removed", 2), ("moved", 5)):
                if rnd.random() < 0.5:
                    detail[key] = rnd.randint(0, hi)
            if rnd.random() < 0.3:
                detail.update(slo=rnd.choice(("get_p99", "put_ok")), window="fast")
            stamped = rnd.random() < 0.85
            journal.append(entry(seq, rnd.choice(KINDS), node,
                                 (ms, rnd.randint(0, 3), 1) if stamped else None,
                                 ms if rnd.random() < 0.9 else None,
                                 wall_s=ms / 1000 + rnd.random(), **detail))
        members.append(member(node, journal, dropped=rnd.choice((0, 0, 3))))
    return bundle_of(*members)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_forensics_cli_fixtures_twin(name):
    out = assert_twin([journal_bundle(FIXTURES[name])])
    signatures = [f["signature"] for f in out[2]]
    assert signatures == (["stuck_handoff"] if name.startswith("stuck") else [])


@pytest.mark.parametrize("name", sorted(SIGNATURE_FIXTURES))
def test_each_signature_fixture_twin(name):
    out = assert_twin([SIGNATURE_FIXTURES[name]])
    if name != "unstamped":
        assert name in [f["signature"] for f in out[2]]


@pytest.mark.parametrize("seed", range(6))
def test_random_journals_twin(seed):
    """Twenty seeded bundles a seed, merged one and two at a time (a node's
    journal in both dedupes)."""
    rnd = random.Random(seed)
    found = set()
    for _ in range(20):
        first, second = random_bundle(rnd), random_bundle(rnd)
        out = assert_twin([first])
        assert_twin([first, second, first])
        found |= {f["signature"] for f in out[2]}
    assert found, "the seeded journals fire no signature"


def test_witness_bundle_twin(monkeypatch):
    """The flagged bug's witness bundle, as ``tests/test_forensics.py``'s
    search witness takes it (the engine probe with the forensics mirror on)."""
    monkeypatch.setenv(BUG_FLAG, "1")
    spec = dict(json.loads((REPO / "scenarios" / "corpus" /
                            "hunt-s11-engine-linearizability-0.json").read_text()),
                forensics=True)
    bundles = [importlib.import_module(f"{p}.search.runner").run_probe(spec, **(
        {"device": "cpu"} if p == "rapid_tpu_torch" else {})).info["bundle"] for p in PACKAGES]
    out = assert_twin([bundles[0]])
    assert out[0] and all(e[5] is not None for e in out[0])  # every event HLC-stamped
    norm = [chip_smoke._normalized(search_modules(p), b)
            for p, b in zip(PACKAGES, bundles)]
    assert norm[0] == norm[1]
    assert bundles[0]["detail"] == bundles[1]["detail"]


def test_bundles_captured_from_each_package_members_twin():
    """The skewed churn of ``tests/test_forensics.py`` on each package's own
    members: the captured journals (wall times and span ids aside) and every
    timeline output over them are equal, and HLC order holds."""
    jax_P, port_P = (search_modules(p) for p in PACKAGES)
    captured = [chip_smoke.skewed_churn_bundle(P) for P in (jax_P, port_P)]
    norm = [chip_smoke._normalized(P, b) for P, b in zip((jax_P, port_P), captured)]
    assert norm[0] == norm[1]
    outs = [run_timeline(p, [n]) for p, n in zip(PACKAGES, norm)]
    assert outs[0] == outs[1]
    events = timeline("rapid_tpu_torch").merge_timeline(captured[1:])
    kinds = [e.kind for e in events]
    assert all(e.hlc is not None for e in events)
    assert kinds.index("fd_signal") < len(kinds) - 1 - kinds[::-1].index("view_install")


# --------------------------------------------------------------------- #
# The CLI: tools/forensics.py against rapid_tpu_torch.cli.forensics
# --------------------------------------------------------------------- #

def call(package, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli_main(package)(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture()
def files(tmp_path):
    paths = {}
    for name, events in FIXTURES.items():
        paths[name] = str(tmp_path / f"{name}.json")
        bundle_mod("rapid_tpu").write_bundle(journal_bundle(events), paths[name])
    for name, bundle in SIGNATURE_FIXTURES.items():
        paths[name] = str(tmp_path / f"{name}.json")
        bundle_mod("rapid_tpu").write_bundle(bundle, paths[name])
    doc = json.loads(pathlib.Path(paths["probe"]).read_text())
    doc["members"][0]["metrics"] = {"messages.forged": 1}
    paths["tampered"] = str(tmp_path / "tampered.json")
    pathlib.Path(paths["tampered"]).write_text(json.dumps(doc))
    paths["empty"] = str(tmp_path / "empty.json")
    bundle_mod("rapid_tpu").write_bundle(bundle_of(member("a", [])), paths["empty"])
    paths["missing"] = str(tmp_path / "missing.json")
    paths["trace"] = str(tmp_path / "trace-{}.json")
    return paths


CLI_CASES = {
    "report_stuck": (["report", "stuck_handoff"], 3),
    "report_clean": (["report", "clean"], 0),
    "report_json": (["report", "stuck_handoff", "clean", "--json"], 3),
    "report_every_signature": (["report", "view_divergence", "deposed_leader_write",
                                "alert_storm_burn", "unstamped", "--grace-ms", "500",
                                "--storm-min", "3"], 3),
    "report_trace": (["report", "alert_storm_burn", "--trace-out", "trace"], 3),
    "report_empty": (["report", "empty"], 2),
    "report_missing": (["report", "missing"], 2),
    "verify_ok": (["verify", "probe"], 0),
    "verify_tampered": (["verify", "tampered"], 3),
    "verify_missing": (["verify", "missing"], 2),
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_forensics_cli_twin(case, files):
    argv, rc = CLI_CASES[case]
    results = []
    for p in PACKAGES:
        args = [files[a].format(p) if a in files else a for a in argv]
        results.append(call(p, args))
        if case == "report_trace":
            results.append(json.loads(pathlib.Path(files["trace"].format(p)).read_text()))
    if case == "report_trace":
        assert results[1] == results[3]
        results = [results[0][:2], results[2][:2]]  # stderr names the package's own path
    assert results[0] == results[1]
    assert results[0][0] == rc


def test_forensics_cli_as_a_module_exits_with_its_code(files):
    proc = subprocess.run([sys.executable, "-m", "rapid_tpu_torch.cli.forensics", "report",
                           files["stuck_handoff"]], capture_output=True, text=True,
                          cwd=REPO, timeout=120)
    assert proc.returncode == 3, proc.stderr
    assert "SIGNATURE: stuck_handoff" in proc.stderr
    assert proc.stdout == call("rapid_tpu", ["report", files["stuck_handoff"]])[1]


# --------------------------------------------------------------------- #
# The catalog lint and the public surface
# --------------------------------------------------------------------- #

def test_signature_catalog_two_sided_in_the_port():
    """``tools/check.py``'s ``signature-catalog`` lint on the port: every row
    of ``SIGNATURE_CATALOG`` (a pure literal) has a non-empty doc and a
    detector that emits it, and every name a detector emits is cataloged."""
    path = REPO / "rapid_tpu_torch" / "forensics" / "timeline.py"
    tree = ast.parse(path.read_text())
    catalog = [ast.literal_eval(n.value) for n in tree.body if isinstance(n, ast.Assign)
               and getattr(n.targets[0], "id", "") == "SIGNATURE_CATALOG"]
    assert catalog, "SIGNATURE_CATALOG is not a pure literal"
    emitted = {node.args[0].value for node in ast.walk(tree)
               if isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
               and node.func.id == "_finding" and isinstance(node.args[0], ast.Constant)}
    assert set(catalog[0]) == emitted
    assert all(str(row.get("doc", "")).strip() for row in catalog[0].values())
    assert catalog[0] == timeline("rapid_tpu").SIGNATURE_CATALOG


def test_every_public_name_of_the_jax_timeline_exists_in_the_port():
    jax, port = (timeline(p) for p in PACKAGES)
    public = {n for n in vars(jax) if not n.startswith("_")}
    assert public <= set(vars(port)), public - set(vars(port))
    for name in public:
        if callable(getattr(jax, name)) and getattr(getattr(jax, name), "__module__",
                                                    "") == jax.__name__:
            assert str(inspect.signature(getattr(jax, name))) == str(
                inspect.signature(getattr(port, name))), name
    jax_init, port_init = (importlib.import_module(f"{p}.forensics") for p in PACKAGES)
    assert jax_init.__all__ == port_init.__all__
    assert all(hasattr(port_init, n) for n in port_init.__all__)
