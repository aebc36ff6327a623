"""The port's nemesis search (``rapid_tpu_torch.search`` and
``rapid_tpu_torch.cli.hunt``) against the JAX package's (``rapid_tpu.search``
and ``tools/hunt.py``), exactly.

The same histories, specs and seeds go through both packages: every
checker history of ``tests/test_search.py`` and a few hundred drawn from a
seeded ``random.Random``, generator samples and mutations over seeds,
indices and both harnesses, engine probes (the flagged bug with the flag on
and off, the restart plan, a cell partition), ``sim`` probes on
``device="cpu"`` at the search's own capacity of 5 whose plans draw no loss
below 1.0 (the durability suite's restart, a gray node, an ingress drop),
the shrinker on the corpus pin, a hunt's report, and the two CLIs' output,
exit codes and pinned bytes. Then the port's counterparts of
``tools/check.py``'s ``gen-reach`` lint and of the public surface, and the
device contract: a ``sim`` probe without ``device`` raises without CUDA.
"""

import ast
import importlib
import inspect
import json
import pathlib
import random
import subprocess
import sys

import pytest
import torch

pytest_plugins = ["torch_gate"]  # the port's test gate, tests/torch_gate.py

REPO = pathlib.Path(__file__).resolve().parents[1]
PACKAGES = ("rapid_tpu", "rapid_tpu_torch")
SEARCH_MODULES = ("checkers", "coverage", "fabric", "generator", "hunt", "runner", "shrinker")
CORPUS = sorted((REPO / "scenarios" / "corpus").glob("*.json"))
BUG_FLAG = "RAPID_BUG_NEWROW_SYNC"


def mod(package, name):
    return importlib.import_module(f"{package}.search.{name}")


def both(fn):
    """``fn(package)`` on each package: (JAX's, the port's)."""
    return tuple(fn(p) for p in PACKAGES)


def device_kw(package):
    return {"device": "cpu"} if package == "rapid_tpu_torch" else {}


# --------------------------------------------------------------------- #
# The checkers: every kill-test history, and seeded random ones
# --------------------------------------------------------------------- #

# (client, op, key, value, version, status, invoke_ms, complete_ms) with the
# status named; tests/test_search.py::TestCheckerKills' histories
HISTORIES = {
    "lost_acked_write": [("a", "put", b"k", b"v1", 1, "OK", 0, 100),
                         ("b", "get", b"k", b"", 0, "NOT_FOUND", 200, 210)],
    "stale_read": [("a", "put", b"k", b"v1", 1, "OK", 0, 50),
                   ("a", "put", b"k", b"v2", 2, "OK", 60, 100),
                   ("b", "get", b"k", b"v1", 1, "OK", 200, 210)],
    "double_leader_write": [("a", "put", b"k", b"va", 3, "OK", 0, 50),
                            ("b", "put", b"k", b"vb", 3, "OK", 10, 60)],
    "torn_read": [("a", "put", b"k", b"real", 1, "OK", 0, 50),
                  ("b", "get", b"k", b"fake", 1, "OK", 100, 110)],
    "non_monotonic_reads": [("a", "put", b"k", b"v2", 2, "OK", 0, 50),
                            ("b", "get", b"k", b"v2", 2, "OK", 60, 70),
                            ("c", "get", b"k", b"v2", 1, "OK", 80, 90)],
    "benign": [("a", "put", b"k", b"v1", 1, "OK", 0, 50),
               ("b", "get", b"k", b"v1", 1, "OK", 60, 70),
               ("a", "put", b"k", b"v2", 2, "OK", 80, 120),
               ("b", "get", b"k", b"v2", 2, "OK", 130, 140),
               ("c", "get", b"k", b"", 0, "NOT_FOUND", 10, 20),
               ("c", "put", b"k", b"lost", 0, "RETRY", 150, 160)],
}

# (checker, arguments) of TestCheckerKills' other cases and
# TestSingleClientPromotion's
CALLS = {
    "view_disagree": ("check_view_agreement", ({"n0": (1, 7), "n1": (1, 8)},)),
    "view_agree": ("check_view_agreement", ({"n0": (1, 7), "n1": (1, 7)},)),
    "leader_split_brain": ("check_leader_agreement",
                           ({"n0": ([4], ["node:7000"]), "n1": ([4], ["node:7001"])},)),
    "leader_agree": ("check_leader_agreement",
                     ({"n0": ([4], ["node:7000"]), "n1": ([4], ["node:7000"])},)),
    "config_parity_broken": ("check_config_parity", (11, 12)),
    "config_parity": ("check_config_parity", (11, 11)),
    "fingerprints_diverged": ("check_fingerprint_agreement",
                              ([(3, "n0", "aaaa"), (3, "n1", "bbbb"), (4, "n0", "cccc")],)),
    "fingerprints_agree": ("check_fingerprint_agreement",
                           ([(3, "n0", "aaaa"), (3, "n1", "aaaa")],)),
    "hierarchy_agree": ("check_hierarchy_agreement",
                        ({"n0": ((0, 1), ("a:1", "b:2"), 42),
                          "n1": ((0, 1), ("a:1", "b:2"), 42)},)),
    "hierarchy_diverged": ("check_hierarchy_agreement",
                           ({"n0": ((0, 1), ("a:1", "b:2"), 42),
                             "n1": ((0, 1), ("a:1", "b:2"), 43)},)),
    "hierarchy_two_leaders": ("check_hierarchy_agreement",
                              ({"n0": ((0,), ("a:1",), 42), "n1": ((0,), ("b:2",), 42)},)),
    "durability_lost": ("check_durability", ({b"k": 3, b"j": 1}, {b"k": 2, b"j": 1})),
    "durability_recovery_diverged": ("check_durability",
                                     ({b"k": 1}, {b"k": 1}, [(0, "n0", "aa"), (0, "n1", "bb")])),
    "durability_held": ("check_durability", ({b"k": 2}, {b"k": 3}, [(0, "n0", "aa")])),
    "gray_collateral": ("check_gray_collateral", ({"slot1"}, ["slot1", "slot3"])),
    "gray_victims_only": ("check_gray_collateral", ({"slot1"}, ["slot1"])),
}

SINGLE_CLIENT = {
    "single_ok": [("put", b"k", b"v1", 1, "OK"), ("get", b"k", b"v1", 1, "OK")],
    "single_stale": [("put", b"k", b"v1", 1, "OK"), ("get", b"k", b"v1", 1, "OK"),
                     ("put", b"k", b"v2", 2, "OK"), ("get", b"k", b"v1", 1, "OK")],
}


def verdict(call):
    """What ``call()`` gives: None, or the exception's class, tag and text."""
    try:
        call()
    except Exception as exc:  # noqa: BLE001 -- the verdict is the exception
        return (type(exc).__name__, getattr(exc, "invariant", None),
                getattr(exc, "detail", None), str(exc))
    return None


def history(package, rows):
    C = mod(package, "checkers")
    PutAck = importlib.import_module(f"{package}.types").PutAck
    return [C.ClientOp(c, op, k, v, ver, getattr(PutAck, f"STATUS_{s}"), t0, t1)
            for c, op, k, v, ver, s, t0, t1 in rows]


def random_history(rnd):
    """A history over 2 keys and 3 clients whose versions, values, statuses
    and intervals are drawn loosely enough that every verdict occurs."""
    rows, t = [], 0
    for _ in range(rnd.randint(2, 9)):
        start = t + rnd.randint(0, 40)
        t = start + rnd.randint(1, 60)
        op = rnd.choice(("put", "get"))
        version = rnd.randint(0, 4)
        value = b"v%d" % rnd.randint(0, 4)
        rows.append((rnd.choice("abc"), op, rnd.choice((b"k", b"j")), value, version,
                     rnd.choice(("OK", "OK", "OK", "NOT_FOUND", "RETRY")),
                     start, t if rnd.random() < 0.8 else start + rnd.randint(0, 300)))
    return rows


@pytest.mark.parametrize("name", sorted(HISTORIES))
def test_checker_kill_histories_twin(name):
    got = both(lambda p: verdict(lambda: mod(p, "checkers").check_linearizable_history(
        history(p, HISTORIES[name]))))
    assert got[0] == got[1]
    assert (got[0] is None) == (name == "benign")


@pytest.mark.parametrize("name", sorted(CALLS))
def test_checker_calls_twin(name):
    checker, args = CALLS[name]
    got = both(lambda p: verdict(lambda: getattr(mod(p, "checkers"), checker)(*args)))
    assert got[0] == got[1]


@pytest.mark.parametrize("name", sorted(SINGLE_CLIENT))
def test_single_client_checker_twin(name):
    def run(p):
        PutAck = importlib.import_module(f"{p}.types").PutAck
        rows = [(op, k, v, ver, getattr(PutAck, f"STATUS_{s}"))
                for op, k, v, ver, s in SINGLE_CLIENT[name]]
        return verdict(lambda: mod(p, "checkers").check_linearizable_single_client(rows))

    got = both(run)
    assert got[0] == got[1]
    assert (got[0] is None) == (name == "single_ok")


def test_violation_tags_twin():
    assert mod("rapid_tpu", "checkers").INVARIANTS == mod("rapid_tpu_torch", "checkers").INVARIANTS
    made_up = both(lambda p: verdict(
        lambda: mod(p, "checkers").InvariantViolation("made-up-invariant", "nope")))
    assert made_up[0] == made_up[1] and made_up[0][0] == "AssertionError"
    assert both(lambda p: mod(p, "checkers").InvariantViolation(
        "linearizability", "witness").to_json()) == ({"invariant": "linearizability",
                                                      "detail": "witness"},) * 2


@pytest.mark.parametrize("seed", range(4))
def test_checkers_on_random_histories_twin(seed):
    """100 seeded histories a seed through the linearizability, single-client
    and metastable-recovery checkers of both packages."""
    rnd = random.Random(seed)
    for _ in range(100):
        rows = random_history(rnd)
        faulted, healed = sorted(rnd.sample(range(0, 400), 2))
        for call in (
            lambda p: mod(p, "checkers").check_linearizable_history(history(p, rows)),
            lambda p: mod(p, "checkers").check_linearizable_single_client(
                [(o.op, o.key, o.value, o.version, o.status) for o in history(p, rows)]),
            lambda p: mod(p, "checkers").check_metastable_recovery(
                history(p, rows), faulted_from_ms=faulted, healed_at_ms=healed),
        ):
            got = both(lambda p: verdict(lambda: call(p)))
            assert got[0] == got[1], rows


# --------------------------------------------------------------------- #
# The generator
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("harness", ("engine", "sim"))
@pytest.mark.parametrize("seed", (0, 3, 7, 12))
def test_generator_fresh_and_mutate_twin(harness, seed):
    def samples(p):
        H = mod(p, "hunt")
        defaults = H.ENGINE_DEFAULTS if harness == "engine" else H.SIM_DEFAULTS
        gen = mod(p, "generator").PlanGenerator(
            seed, H.harness_endpoints(harness, defaults), defaults["horizon_ms"], harness)
        fresh = [gen.fresh(i) for i in range(40)]
        return fresh, [gen.mutate(fresh[i % 7], i) for i in range(40)]

    jax, port = both(samples)
    assert jax == port


def test_gen_rules_equal_the_port_rule_subclasses():
    """``tools/check.py``'s ``gen-reach`` lint on the port: ``GEN_RULES`` is a
    pure literal equal to the ``Rule`` subclasses the port's ``faults.py``
    defines (transitively), so no fault rule stays outside every hunt."""
    faults_tree = ast.parse((REPO / "rapid_tpu_torch" / "faults.py").read_text())
    known, classes = {"Rule"}, set()
    for node in faults_tree.body:
        if isinstance(node, ast.ClassDef) and {
                b.id for b in node.bases if isinstance(b, ast.Name)} & known:
            known.add(node.name)
            classes.add(node.name)
    gen_tree = ast.parse((REPO / "rapid_tpu_torch" / "search" / "generator.py").read_text())
    literal = [ast.literal_eval(n.value) for n in gen_tree.body
               if isinstance(n, ast.Assign) and getattr(n.targets[0], "id", "") == "GEN_RULES"]
    assert literal and set(literal[0]) == classes and len(literal[0]) == len(classes)
    assert tuple(literal[0]) == mod("rapid_tpu", "generator").GEN_RULES


# --------------------------------------------------------------------- #
# Probes
# --------------------------------------------------------------------- #

BUG_PLAN = {"seed": 7, "rules": [
    {"type": "DropRule", "at": "egress", "windows": [[0, None]], "src": None,
     "dst": "node:7003", "msg_types": ["Put"], "probability": 1.0},
    {"type": "PartitionRule", "at": "egress", "windows": [[1200, None]], "src": None,
     "dst": "node:7000", "msg_types": None},
    {"type": "DropRule", "at": "egress", "windows": [[1200, None]], "src": None,
     "dst": "node:7002", "msg_types": ["Get"], "probability": 1.0}]}
ENGINE = {"harness": "engine", "n": 5, "partitions": 16, "replicas": 3, "horizon_ms": 4000,
          "ops": 40, "keys": 6}
BUG_SPEC = dict(ENGINE, plan=BUG_PLAN)  # tests/test_search.py's
RESTART_SPEC = dict(ENGINE, plan={"seed": 7, "rules": [  # tests/test_durability.py's
    {"type": "RestartNodeRule", "at": "egress", "windows": [[800, 2400]], "src": None,
     "dst": "node:7002", "msg_types": None},
    {"type": "TornWriteRule", "at": "egress", "windows": [[0, None]], "src": None,
     "dst": "node:7002", "msg_types": None, "drop_bytes": 3, "corrupt": False}]})
CELL_SPEC = dict(ENGINE, n=6, plan={"seed": 4, "rules": [
    {"type": "CellPartitionRule", "at": "egress", "windows": [[500, 2500]], "src": None,
     "dst": None, "msg_types": None, "cell": 2, "cells": 3}]})
SIM = {"harness": "sim", "n": 4, "capacity": 5, "horizon_ms": 20_000, "ops": 30, "keys": 8}
SIM_SPECS = {
    # tests/test_durability.py::TestSearchDurability's
    "restart": dict(SIM, plan={"seed": 5, "rules": [
        {"type": "RestartNodeRule", "at": "egress", "windows": [[5000, 9000]], "src": None,
         "dst": "10.0.0.2:5002", "msg_types": None}]}),
    "gray": dict(SIM, fd_gray_confirm=3, plan={"seed": 6, "rules": [
        {"type": "SlowNodeRule", "at": "egress", "windows": [[3000, 12000]], "src": None,
         "dst": "10.0.0.1:5001", "msg_types": None, "response_delay_ms": 400}]}),
    "ingress_drop": dict(SIM, plan={"seed": 9, "rules": [
        {"type": "DropRule", "at": "ingress", "windows": [[2000, None]], "src": None,
         "dst": "10.0.0.3:5003", "msg_types": None, "probability": 1.0}]}),
}


def probe(package, spec):
    result = mod(package, "runner").run_probe(spec, **device_kw(package))
    return result.coverage, result.violations, result.info


@pytest.mark.parametrize("flag", (False, True), ids=("flag_off", "flag_on"))
def test_engine_bug_probe_twin(flag, monkeypatch):
    if flag:
        monkeypatch.setenv(BUG_FLAG, "1")
    else:
        monkeypatch.delenv(BUG_FLAG, raising=False)
    jax, port = both(lambda p: probe(p, BUG_SPEC))
    assert jax == port
    assert bool(jax[1]) == flag


@pytest.mark.parametrize("name", ("restart", "cell_partition"))
def test_engine_probe_twin(name, monkeypatch):
    monkeypatch.delenv(BUG_FLAG, raising=False)
    spec = RESTART_SPEC if name == "restart" else CELL_SPEC
    jax, port = both(lambda p: probe(p, spec))
    assert jax == port
    assert jax[1] == ()
    kind = "durability_recovered" if name == "restart" else "kicked"
    assert ("kind", kind) in jax[0]


@pytest.mark.parametrize("name", sorted(SIM_SPECS))
def test_sim_probe_on_cpu_twin(name, monkeypatch):
    """The port's simulator on the CPU gives the JAX package's probe exactly:
    these plans draw no loss below 1.0."""
    monkeypatch.delenv(BUG_FLAG, raising=False)
    jax, port = both(lambda p: probe(p, SIM_SPECS[name]))
    assert jax == port
    assert jax[1] == () and jax[0]


def test_sim_probe_without_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    runner = mod("rapid_tpu_torch", "runner")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        runner.run_probe(SIM_SPECS["restart"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod("rapid_tpu_torch", "hunt").Hunter(seed=0, budget=1, harness="sim").run()
    cli = importlib.import_module("rapid_tpu_torch.cli.hunt")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--harness", "sim", "--budget", "1"])
    # the engine harness is host code: it takes the argument and needs no card
    assert runner.run_probe(BUG_SPEC, device="cuda") == runner.run_probe(BUG_SPEC)


# --------------------------------------------------------------------- #
# The shrinker and the hunter
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("path", CORPUS, ids=[p.stem for p in CORPUS])
def test_shrink_corpus_pin_twin(path, monkeypatch):
    monkeypatch.setenv(BUG_FLAG, "1")
    artifact = json.loads(path.read_text())
    spec = {k: v for k, v in artifact.items() if k not in ("name", "description", "expect")}
    jax, port = both(lambda p: mod(p, "shrinker").shrink_spec(
        spec, max_probes=40, **device_kw(p)))
    assert jax == port
    assert jax[1] > 1


def test_hunter_report_twin(monkeypatch):
    monkeypatch.delenv(BUG_FLAG, raising=False)
    jax, port = both(lambda p: mod(p, "hunt").Hunter(seed=5, budget=15, **device_kw(p)).run())
    assert jax.to_json() == port.to_json()
    assert jax.coverage == port.coverage and jax.corpus == port.corpus
    assert jax.report_text() == port.report_text()


def test_pin_to_file_bytes_twin(tmp_path, monkeypatch):
    monkeypatch.setenv(BUG_FLAG, "1")
    pin = {"kinds": ["linearizability"], "spec": dict(BUG_SPEC, forensics=True),
           "shrink_probes": 3}
    pin["bundle"] = mod("rapid_tpu", "runner").run_probe(pin["spec"]).info["bundle"]
    written = []
    for p in PACKAGES:
        path = tmp_path / f"{p}.json"
        mod(p, "hunt").pin_to_file(pin, str(path), "pin", "a pinned witness")
        written.append((path.read_bytes(), json.loads((tmp_path / f"{p}.json.bundle.json")
                                                      .read_text())))
    assert written[0] == written[1]


# --------------------------------------------------------------------- #
# The CLI: tools/hunt.py against python -m rapid_tpu_torch.cli.hunt
# --------------------------------------------------------------------- #

def run_cli(package, args, cwd, flag=False):
    cmd = ([sys.executable, str(REPO / "tools" / "hunt.py")] if package == "rapid_tpu" else
           [sys.executable, "-m", "rapid_tpu_torch.cli.hunt"])
    env = {"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO), "JAX_PLATFORMS": "cpu"}
    if flag:
        env[BUG_FLAG] = "1"
    return subprocess.run(cmd + args, capture_output=True, text=True, cwd=cwd, env=env,
                          timeout=300)


@pytest.mark.parametrize("case", ("json", "bug_pinned", "sim_cpu"))
def test_hunt_cli_twin(case, tmp_path):
    args, flag = {
        "json": (["--seed", "5", "--budget", "15", "--json"], False),
        "bug_pinned": (["--seed", "12", "--budget", "120", "--shrink-budget", "150",
                        "--pin", "pins"], True),
        "sim_cpu": (["--harness", "sim", "--budget", "3", "--json"], False),
    }[case]
    outs = []
    for p in PACKAGES:
        cwd = tmp_path / p
        cwd.mkdir()
        extra = ["--device", "cpu"] if p == "rapid_tpu_torch" and case == "sim_cpu" else []
        proc = run_cli(p, args + extra, cwd, flag)
        pins = sorted((f.name, f.read_bytes()) for f in (cwd / "pins").glob("*")) if (
            cwd / "pins").exists() else []
        outs.append((proc.returncode, proc.stdout, pins))
    assert outs[0] == outs[1], outs[1][1][-2000:]
    assert outs[0][0] == (1 if flag else 0)
    if flag:
        assert outs[0][2] and "wrote pins/hunt-s12-engine-linearizability-0.json" in outs[0][1]


# --------------------------------------------------------------------- #
# The public surface
# --------------------------------------------------------------------- #

def _public(module):
    return {n for n in vars(module) if not n.startswith("_")}


@pytest.mark.parametrize("name", ("__init__",) + SEARCH_MODULES)
def test_every_public_name_of_the_jax_search_exists_in_the_port(name):
    """Every public name of ``rapid_tpu.search.<name>`` exists in the port;
    each function and method defined there takes the JAX parameters in the
    JAX order with the same defaults, the port adding only ``device``."""
    jax, port = (importlib.import_module(f"{p}.search" + ("" if name == "__init__" else
                                                          f".{name}")) for p in PACKAGES)
    missing = _public(jax) - _public(port)
    assert not missing, missing
    if name == "__init__":
        assert jax.__all__ == port.__all__
    for attr in sorted(_public(jax)):
        j, t = getattr(jax, attr), getattr(port, attr)
        members = [(attr, j, t)]
        if inspect.isclass(j) and j.__module__ == jax.__name__:
            assert _public(j) <= set(dir(t)), attr
            members += [(f"{attr}.{m}", getattr(j, m), getattr(t, m)) for m in vars(j)
                        if (m == "__init__" or not m.startswith("_"))
                        and inspect.isfunction(getattr(j, m))]
        for label, jf, tf in members:
            if not inspect.isfunction(jf) or jf.__module__ != jax.__name__:
                continue
            jp = list(inspect.signature(jf).parameters.values())
            tp = list(inspect.signature(tf).parameters.values())
            assert [(q.name, q.default, q.kind) for q in tp[:len(jp)]] == [
                (q.name, q.default, q.kind) for q in jp], label
            assert [q.name for q in tp[len(jp):]] in ([], ["device"]), label
