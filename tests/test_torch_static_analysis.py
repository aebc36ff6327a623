"""The port's merge gate: ``rapid_tpu_torch.cli.check``, ``concur`` and
``devlint`` (the counterparts of ``tools/check.py``, ``concur.py`` and
``devlint.py``).

1. The gates: ``check --all`` exits 0 on the port, and no analyzer it runs
   reports a finding.
2. ``concur`` gives the JAX tool's rule set on every ``tests/fixtures/concur``
   file, but for the ``jit_purity`` pair, which the port's docstring points
   at torch's capture-and-replay instead (``tests/fixtures/torch_concur``).
3. The code-health rules give the JAX tool's findings on the same snippets.
4. ``tests/fixtures/torch_devlint``, the torch translation of
   ``tests/fixtures/devlint``, fires both ways; each host-sync form alone.
5. Suppressions, the device plane's paths, the rule docs, the print-ok set.
6. No module of the port, and not ``chip_smoke.py``, imports ``jax``,
   ``rapid_tpu`` or ``tools`` (by statement or by string).
"""

import ast
import pathlib
import subprocess
import sys

import pytest

from rapid_tpu_torch.cli import check, concur, devlint, lintlib
from tools import check as jax_check
from tools import concur as jax_concur

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures"
JAX_CONCUR = FIXTURES / "concur"
TORCH_CONCUR = FIXTURES / "torch_concur"
TORCH_DEVLINT = FIXTURES / "torch_devlint"

# ---------------------------------------------------------------------------
# 1. the gates
# ---------------------------------------------------------------------------

CONCUR_RULES = {"lock-order", "unguarded-write", "blocking-under-lock",
                "unbalanced-acquire", "jit-purity"}
DEVLINT_RULES = {"host-sync", "recompile-hazard", "dtype-discipline", "donation-hygiene"}
GATES = ("concur", "devlint", "check --all")


@pytest.fixture(scope="module")
def gate_run():
    """``check --all``, which runs check, concur and devlint in one process."""
    return subprocess.run([sys.executable, "-m", "rapid_tpu_torch.cli.check", "--all"],
                          cwd=REPO, text=True, capture_output=True, timeout=240)


def _owner(rule):
    return ("concur" if rule in CONCUR_RULES else
            "devlint" if rule in DEVLINT_RULES else "check --all")


@pytest.mark.parametrize("name", GATES)
def test_gate_is_clean_on_the_port(gate_run, name):
    lines = gate_run.stdout.strip().splitlines()
    findings = [line for line in lines[:-1] if _owner(line.split(": ", 1)[1].split()[0]) == name]
    assert findings == [], gate_run.stdout + gate_run.stderr
    if name == "check --all":
        assert gate_run.returncode == 0, gate_run.stdout + gate_run.stderr
        assert lines[-1] == "check+concur+devlint: OK"


def test_default_paths_cover_the_ports_files():
    files = {p.relative_to(REPO).as_posix() for p in lintlib.iter_py_files(
        check._expand(check.DEFAULT_PATHS))}
    assert "chip_smoke.py" in files and "tests/torch_gate.py" in files
    assert "rapid_tpu_torch/sim/driver.py" in files
    assert {p.relative_to(REPO).as_posix() for p in REPO.glob("tests/test_torch_*.py")} <= files
    assert not any(f.startswith(("rapid_tpu/", "tools/")) or "/fixtures/" in f for f in files)
    assert concur.DEFAULT_PATHS == ["rapid_tpu_torch", "chip_smoke.py", "tests/torch_gate.py"]


# ---------------------------------------------------------------------------
# 2. concur against tools/concur.py on the fixture corpus
# ---------------------------------------------------------------------------

JIT_PAIR = ("bad_jit_purity.py", "good_jit_purity.py")
SHARED = sorted(p.name for p in JAX_CONCUR.glob("*.py") if p.name not in JIT_PAIR)
HYGIENE = ("thread-daemon", "callback-under-lock")


def _concur_rules(tool, path):
    return {f.rule for f in tool.run([str(path)])}


@pytest.mark.parametrize("name", SHARED)
def test_concur_matches_the_jax_tool(name):
    port = _concur_rules(concur, JAX_CONCUR / name)
    assert port == _concur_rules(jax_concur, JAX_CONCUR / name)
    assert bool(port) == name.startswith("bad_") or name in (
        "bad_thread_daemon.py", "bad_callback_under_lock.py")  # check.py's hygiene pair


@pytest.mark.parametrize("name", SHARED)
def test_hygiene_matches_the_jax_tool(name):
    port = [(f.line, f.rule, f.msg) for f in check.check_file(JAX_CONCUR / name)
            if f.rule in HYGIENE]
    assert port == [(f.line, f.rule, f.msg) for f in jax_check.check_file(JAX_CONCUR / name)
                    if f.rule in HYGIENE]


@pytest.mark.parametrize("name", JIT_PAIR)
def test_jax_jit_is_not_the_ports_staging(name):
    """The module docstring's choice: ``jax.jit`` has no subject in the port,
    so the JAX pair fires nothing here (it fires ``jit-purity`` in the JAX
    tool)."""
    assert "``jax.jit`` itself is not recognized" in " ".join(concur.__doc__.split())
    assert _concur_rules(concur, JAX_CONCUR / name) == set()
    assert _concur_rules(jax_concur, JAX_CONCUR / name) == (
        {"jit-purity"} if name.startswith("bad") else set())


@pytest.mark.parametrize("name,rules", [("bad_jit_purity.py", {"jit-purity"}),
                                        ("good_jit_purity.py", set())])
def test_jit_purity_points_at_cuda_graph_capture(name, rules):
    assert _concur_rules(concur, TORCH_CONCUR / name) == rules
    assert {p.name for p in TORCH_CONCUR.glob("*.py")} == set(JIT_PAIR)


@pytest.mark.parametrize("decorator", ["@torch.compile", "@torch.compile(mode='max-autotune')",
                                       "@torch.jit.script"])
def test_jit_purity_covers_compiled_functions(tmp_path, decorator):
    target = tmp_path / "staged.py"
    target.write_text(f"import time\nimport torch\n\n\n{decorator}\n"
                      "def f(x):\n    return x + time.time()\n")
    assert _concur_rules(concur, target) == {"jit-purity"}


def test_noqa_suppresses_concur_finding(tmp_path):
    bad = (JAX_CONCUR / "bad_blocking_under_lock.py").read_text()
    lines = [line + "  # noqa: Blocking-Under-Lock" if "sleep(" in line or ".result(" in line
             or ".wait(" in line or "recv(" in line else line for line in bad.splitlines()]
    target = tmp_path / "suppressed.py"
    target.write_text("\n".join(lines) + "\n")
    assert "blocking-under-lock" in _concur_rules(concur, JAX_CONCUR / "bad_blocking_under_lock.py")
    assert "blocking-under-lock" not in _concur_rules(concur, target)


# ---------------------------------------------------------------------------
# 3. code health against tools/check.py on the same snippets
# ---------------------------------------------------------------------------

SNIPPETS = {
    "unused-import": "import os\nimport sys\n\nprint_ok = sys.argv\n",
    "mutable-default": "def f(x=[], *, y={}):\n    return x, y\n",
    "bare-except": "try:\n    pass\nexcept:\n    pass\n",
    "none-compare": "x = 1\nif x == None or x != None:\n    pass\n",
    "assert-tuple": "assert (1, 'always true')\n",
    "dup-dict-key": "d = {'a': 1, 'a': 2}\n",
    "print-in-lib": "print('hello')\n",
    "debugger": "import pdb\npdb.set_trace()\n",
    "thread-daemon": "import threading\nthreading.Thread(target=print).start()\n",
    "callback-under-lock": ("import threading\nlock = threading.Lock()\n\n\n"
                            "def fire(callback):\n    with lock:\n        callback()\n"),
    "noqa": "import os  # noqa: unused-import\nprint(1)  # noqa\n",
    "clean": "import os\n\n\ndef f(x=None):\n    return os.sep if x is None else x\n",
}
CODE_HEALTH = {"syntax", "unused-import", "mutable-default", "bare-except", "none-compare",
               "assert-tuple", "dup-dict-key", "print-in-lib", "debugger", *HYGIENE}


def _health(tool, library_path, source):
    """``tool``'s code-health findings for ``source`` as a library module at
    ``library_path`` (the path only names the module; nothing is read)."""
    tree = ast.parse(source)
    checker = tool.Checker(library_path, source, tree)
    checker.check_unused_imports()
    checker.visit(tree)
    found = list(checker.findings)
    hygiene = tool._HygieneVisitor(library_path, tool.noqa_lines(source))
    hygiene.visit(tree)
    found += hygiene.findings
    return sorted((f.line, f.rule, f.msg) for f in found if f.rule in CODE_HEALTH)


@pytest.mark.parametrize("name", list(SNIPPETS))
def test_code_health_matches_the_jax_tool(tmp_path, name):
    path = tmp_path / f"{name.replace('-', '_')}.py"
    path.write_text(SNIPPETS[name])
    source = path.read_text()
    port = _health(check, REPO / "rapid_tpu_torch" / path.name, source)
    assert port == _health(jax_check, REPO / "rapid_tpu" / path.name, source)
    if name in ("noqa", "clean"):
        assert port == []
    else:
        assert name in {rule for _, rule, _ in port}


@pytest.mark.parametrize("rel,ok", [
    ("rapid_tpu_torch/cli/check.py", True), ("rapid_tpu_torch/experiments/join_wave.py", True),
    ("rapid_tpu_torch/examples/load_balancer.py", True), ("rapid_tpu_torch/sim/fd_bench.py", True),
    ("rapid_tpu_torch/placement/topr_variants.py", True), ("chip_smoke.py", True),
    ("tests/test_torch_api.py", True), ("rapid_tpu_torch/sim/driver.py", False),
    ("rapid_tpu_torch/cluster.py", False)])
def test_print_ok_set(rel, ok):
    tree = ast.parse("print(1)\n")
    checker = check.Checker(REPO / rel, "print(1)\n", tree)
    checker.visit(tree)
    assert (not checker.findings) == ok


def test_syntax_error_is_a_finding(tmp_path):
    target = tmp_path / "broken.py"
    target.write_text("def f(:\n")
    assert [f.rule for f in check.check_file(target)] == ["syntax"]


def test_port_catalog_lints_are_clean_and_read_the_port():
    for lint in (check.check_wire_tags, check.check_fault_rules, check.check_generator_reach,
                 check.check_settings_catalog, check.check_metric_emission,
                 check.check_event_emission, check.check_signature_catalog,
                 check.check_slo_catalog, check.check_plan_corpus):
        assert lint() == [], lint.__name__
    assert check.PKG == REPO / "rapid_tpu_torch"
    from rapid_tpu_torch import observability

    assert check.METRIC_CATALOG == observability.METRIC_CATALOG
    assert check.SPAN_CATALOG == observability.SPAN_CATALOG
    assert check.EVENT_CATALOG == observability.EVENT_CATALOG


def test_rules_prints_the_full_catalog():
    out = subprocess.run([sys.executable, "-m", "rapid_tpu_torch.cli.check", "--rules"],
                         cwd=REPO, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0
    assert [line.split()[0] for line in out.stdout.splitlines()] == list(check.RULE_DOCS)
    assert set(check.RULE_DOCS) == set(jax_check.RULE_DOCS)


# ---------------------------------------------------------------------------
# 4. devlint: the torch corpus, and each host-sync form
# ---------------------------------------------------------------------------

DEVLINT_FIXTURES = [
    ("bad_recompile.py", "recompile-hazard"),
    ("bad_host_sync.py", "host-sync"),
    ("bad_dtype.py", "dtype-discipline"),
    ("bad_donation.py", "donation-hygiene"),
]
GOOD_DEVLINT = ["good_recompile.py", "good_host_sync.py", "good_dtype.py", "good_donation.py"]


def _devlint_rules(path):
    return {f.rule for f in devlint.run([str(path)])}


def test_devlint_corpus_is_complete_and_translates_the_jax_corpus():
    on_disk = {f.name for f in TORCH_DEVLINT.glob("*.py")}
    assert on_disk == {name for name, _ in DEVLINT_FIXTURES} | set(GOOD_DEVLINT)
    assert on_disk == {f.name for f in (FIXTURES / "devlint").glob("*.py")}


@pytest.mark.parametrize("name,rule", DEVLINT_FIXTURES)
def test_devlint_rule_fires_on_bad_fixture(name, rule):
    assert _devlint_rules(TORCH_DEVLINT / name) == {rule}


@pytest.mark.parametrize("name", GOOD_DEVLINT)
def test_devlint_silent_on_good_fixture(name):
    assert _devlint_rules(TORCH_DEVLINT / name) == set()


SYNC_FORMS = {
    "item": "return t.item()",
    "tolist": "return t.sum(dim=0).tolist()",
    "cpu": "return t.cpu()",
    "numpy": "return t.numpy()",
    "int": "return int(t.max())",
    "float": "return float(t)",
    "bool": "return bool(t.any())",
    "np.asarray": "return np.asarray(t)",
    "synchronize": "torch.cuda.synchronize()",
    "nonzero": "return t.nonzero()",
    "unique": "return torch.unique(t)",
    "where one argument": "return torch.where(t > 0)",
    "mask read": "return t[t > 0]",
    "mask write": "t[m] = 0",
    "if tensor": "if (t > 3).any():\n        return 1",
    "while tensor": "while t.sum() > 0:\n        t = t - 1",
    "assert tensor": "assert t.all()",
    "scalar write": "t[0] = 5",
    "0-d index": "return t[t.argmax()]",
    "device state": "return int(self.state.round)",
}
NO_SYNC_FORMS = {
    "shape": "return int(t.shape[0]) + t.size(0)",
    "is None": "if t is None:\n        return 0",
    "index tensor": "return t[torch.arange(3, dtype=torch.int64)]",
    "tensor write": "t[0] = t[1]",
    "where three arguments": "return torch.where(t > 0, t, 0)",
    "fetch": "return int(jitwatch.fetch('x', t.sum()))",
    "host_transfer": "with jitwatch.host_transfer('x'):\n        return t.cpu()",
    "numpy host": "a = np.zeros(3, dtype=np.int64)\n    return int(a[0]) + a.tolist()[0]",
}


def _sync_snippet(tmp_path, body):
    target = tmp_path / "plane.py"
    target.write_text(
        "import numpy as np\nimport torch\n\nfrom rapid_tpu_torch.runtime import jitwatch\n\n\n"
        "def f(self, t: torch.Tensor):\n    m = t > 0\n    " + body + "\n")
    return target


@pytest.mark.parametrize("form", list(SYNC_FORMS))
def test_each_host_sync_form_fires(tmp_path, form):
    findings = devlint.run([str(_sync_snippet(tmp_path, SYNC_FORMS[form]))])
    assert [f.rule for f in findings] == ["host-sync"], findings


@pytest.mark.parametrize("form", list(NO_SYNC_FORMS))
def test_no_host_sync_where_none_is(tmp_path, form):
    assert devlint.run([str(_sync_snippet(tmp_path, NO_SYNC_FORMS[form]))]) == []


# ---------------------------------------------------------------------------
# 5. suppressions, paths, docs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tag", ["sync-point", "SYNC-POINT"])
def test_devlint_tag_suppresses_finding(tmp_path, tag):
    target = _sync_snippet(tmp_path, f"# the decision's copy  # devlint: {tag}\n    return t.cpu()")
    assert _devlint_rules(target) == set()


def test_devlint_tag_window_is_backward_looking(tmp_path):
    target = _sync_snippet(tmp_path, "x = t.cpu()\n    # devlint: sync-point\n    return x")
    assert _devlint_rules(target) == {"host-sync"}


def test_devlint_tag_covers_only_its_rule(tmp_path):
    target = _sync_snippet(tmp_path, "# devlint: jit-cached\n    return t.cpu()")
    assert _devlint_rules(target) == {"host-sync"}


def test_devlint_honors_noqa(tmp_path):
    bad = (TORCH_DEVLINT / "bad_dtype.py").read_text()
    out = [line + "  # noqa: dtype-discipline" if "torch." in line or "fd_" in line else line
           for line in bad.splitlines()]
    target = tmp_path / "suppressed.py"
    target.write_text("\n".join(out) + "\n")
    assert _devlint_rules(target) == set()


def test_devlint_host_owned_tag_suppresses_ownership(tmp_path):
    bad = (TORCH_DEVLINT / "bad_donation.py").read_text()
    target = tmp_path / "owned.py"
    target.write_text(bad.replace("self.mask_t = torch.from_numpy(alive)",
                                  "self.mask_t = torch.from_numpy(alive)  # devlint: host-owned")
                      .replace("self.alive_t = torch.as_tensor(self.alive, device=self.device)",
                               "self.alive_t = torch.as_tensor(self.alive, device=self.device)"
                               "  # devlint: no-donate"))
    assert _devlint_rules(target) == set()


def test_device_plane_paths_exist():
    assert len(devlint.DEVICE_PLANE) == 8
    for rel in devlint.DEVICE_PLANE:
        assert (REPO / rel).is_file(), rel


def test_every_rule_is_documented():
    assert {rule for _, rule in DEVLINT_FIXTURES} == DEVLINT_RULES
    assert CONCUR_RULES | DEVLINT_RULES <= set(check.RULE_DOCS)
    assert set(devlint.TAG_RULES.values()) <= set(check.RULE_DOCS)


def test_default_scan_skips_fixture_corpora():
    scanned = lintlib.iter_py_files([REPO / "tests"])
    assert not any("fixtures" in f.parts for f in scanned)


# ---------------------------------------------------------------------------
# 6. the port imports nothing of the JAX side
# ---------------------------------------------------------------------------

FORBIDDEN = ("jax", "jaxlib", "rapid_tpu", "tools")


def _forbidden(name):
    return name is not None and name.split(".")[0] in FORBIDDEN


def _imports(path):
    """Every module ``path`` imports: statements, and string literals given
    to ``importlib.import_module`` / ``__import__`` / ``spec_from_file_location``
    (for the last, the path's first directory)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [(node.lineno, a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append((node.lineno, node.module))
        elif isinstance(node, ast.Call):
            name = node.func.attr if isinstance(node.func, ast.Attribute) else getattr(
                node.func, "id", None)
            args = [a for a in node.args if isinstance(a, ast.Constant) and isinstance(a.value, str)]
            if name in ("import_module", "__import__") and args:
                out.append((node.lineno, args[0].value))
            if name == "spec_from_file_location":
                for part in ast.walk(node):
                    if isinstance(part, ast.Constant) and isinstance(part.value, str):
                        out.append((node.lineno, part.value.replace("/", ".")))
    return out


@pytest.mark.parametrize("root", ["rapid_tpu_torch", "chip_smoke.py"])
def test_nothing_of_the_jax_side_is_imported(root):
    files = lintlib.iter_py_files([REPO / root])
    assert files
    bad = [(str(f.relative_to(REPO)), line, name) for f in files
           for line, name in _imports(f) if _forbidden(name)]
    assert bad == []


def test_the_scan_sees_string_imports(tmp_path):
    target = tmp_path / "sneaky.py"
    target.write_text("import importlib\nimport importlib.util\n"
                      "importlib.import_module('rapid_tpu.faults')\n"
                      "importlib.util.spec_from_file_location('x', 'tools/forensics.py')\n"
                      "from jax import numpy\n")
    assert sorted(name for _, name in _imports(target) if _forbidden(name)) == [
        "jax", "rapid_tpu.faults", "tools.forensics.py"]


def test_chip_smoke_search_modules_builds_the_port_alone():
    import chip_smoke

    assert list(__import__("inspect").signature(chip_smoke.search_modules).parameters) == []
    ns = chip_smoke.search_modules()
    assert ns.name == "rapid_tpu_torch"
    assert ns.forensics_main.__module__ == "rapid_tpu_torch.cli.forensics"
    assert all(getattr(ns, m.replace(".", "_")).__name__.startswith("rapid_tpu_torch.")
               for m in chip_smoke.SEARCH_MODULES)
